"""pose3d-torch-doctor — environment and installation diagnostics of the
PyTorch/CUDA port (counterpart of ``pose3d_tpu/cli/doctor.py``).

One screen answering what every support thread starts with: which cards
are visible and at what power limit, which toolkit builds the kernels and
whether their libraries are built, why the native decoder does or does not
build, are the console scripts installed — plus optional quick probes
(``--probe``): bf16 matmul throughput of the card, host→device copies
(pinned and pageable), host decode, and a load of each kernel library,
building it at first use.

Runs against the card (``--device cuda``, the default). Without one the
devices section says so and ``--probe`` exits nonzero; ``--device cpu``
probes the host instead, and says so: the CPU is never probed quietly.

Usage:
  python -m pose3d_tpu_torch.cli.doctor [--probe] [--json out.json]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
import platform
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from pose3d_tpu_torch.ops.kernels import _build
from pose3d_tpu_torch.utils.profiling import card_label, time_calls

logger = logging.getLogger("Doctor")

# matmul probe: n x n bf16 operands, products timed between CUDA events
_MATMUL_N, _MATMUL_ITERS = 4096, 50
_H2D_BYTES = 64 << 20


def kernel_names() -> List[str]:
    """The kernel sources of the package, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))


def _run(cmd) -> str:
    """First line of a tool's output, or why there is none."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not run: {e}"
    lines = (out.stdout or out.stderr).strip().splitlines()
    return lines[0] if lines else f"exit {out.returncode}, no output"


def _versions() -> Dict[str, str]:
    out = {"python": platform.python_version(), "torch": torch.__version__,
           "torch_cuda": str(torch.version.cuda),
           "cudnn": str(torch.backends.cudnn.version())}
    try:
        nccl = torch.cuda.nccl.version()
        out["nccl"] = ".".join(map(str, nccl)) if isinstance(
            nccl, tuple) else str(nccl)
    except Exception as e:  # a CPU build of torch has no NCCL
        out["nccl"] = f"not available ({type(e).__name__})"
    for name in ("numpy", "cv2"):
        try:
            out[name] = str(importlib.import_module(name).__version__)
        except Exception:
            out[name] = "NOT INSTALLED"
    return out


def _devices(device: torch.device) -> Dict:
    out: Dict = {"requested": str(device),
                 "cuda_available": torch.cuda.is_available(),
                 "device_count": torch.cuda.device_count()}
    if device.type == "cpu":
        out["note"] = "--device cpu: the host is probed, no card"
    elif not torch.cuda.is_available():
        out["error"] = ("CUDA is not available: no card is visible (pass "
                        "--device cpu to probe the host)")
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        out[f"cuda:{i}"] = (f"{p.name}, compute capability {p.major}.{p.minor}"
                            f", {p.total_memory / 2**30:.1f} GiB")
    # nvidia-smi's name and power limit of each card (its name alone where
    # nvidia-smi cannot say)
    out["nvidia_smi"] = [card_label(f"cuda:{i}")
                         for i in range(torch.cuda.device_count())]
    return out


def _toolchain() -> Dict:
    from pose3d_tpu_torch.data import native

    out: Dict = {}
    try:
        nvcc = _build._nvcc()
        out["nvcc"] = nvcc
        ver = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        out["nvcc_version"] = ver[-1] if ver else "unknown"
    except RuntimeError as e:
        out["nvcc"] = f"missing: {e}"
    gxx = shutil.which("g++")
    out["g++"] = _run([gxx, "--version"]) if gxx else "missing"
    out["native_decoder_error"] = native.build_error()
    try:
        out["decode_route"] = native.decode_route()
    except RuntimeError as e:
        out["decode_route"] = f"none: {e}"
    return out


def _writable(d: Path) -> bool:
    while not d.exists():
        d = d.parent
    return os.access(d, os.W_OK)


def _kernels() -> Dict:
    out: Dict = {"build_dir": str(_build.BUILD_DIR),
                 "build_dir_writable": _writable(_build.BUILD_DIR)}
    for name in kernel_names():
        path = _build.library_path(name)
        out[name] = {"library_path": str(path), "built": path.is_file()}
    return out


def _install() -> Dict:
    import pose3d_tpu_torch

    # the expected console scripts come from the installed metadata alone:
    # a copied list would drift from pyproject's [project.scripts]
    try:
        from importlib.metadata import entry_points

        scripts = sorted(
            ep.name for ep in entry_points(group="console_scripts")
            if ep.value.startswith("pose3d_tpu_torch."))
    except Exception:
        scripts = []
    out = {
        "package_path": str(pose3d_tpu_torch.__file__),
        "console_scripts_expected": len(scripts),
        "console_scripts_missing": [
            s for s in scripts if shutil.which(s) is None],
    }
    if not scripts:
        out["console_scripts_note"] = (
            "the installed metadata has none: the package is not installed")
    return out


def _probe_matmul(device: torch.device) -> Dict:
    """bf16 products of two n x n matrices, timed between CUDA events on
    the card (a matmul of the library: a probe of the card, no kernel of
    this package); fp32 at a small size on the host with --device cpu."""
    if device.type == "cpu":
        n, iters, dtype = 512, 4, torch.float32
    else:
        n, iters, dtype = _MATMUL_N, _MATMUL_ITERS, torch.bfloat16
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(n, n, generator=g, device=device).to(dtype)
    b = torch.randn(n, n, generator=g, device=device).to(dtype)
    c = torch.empty(n, n, device=device, dtype=dtype)
    dt = time_calls(lambda: torch.matmul(a, b, out=c), device, iters,
                    warmup=3) / 1e3
    key = "matmul_tflops_bf16" if dtype == torch.bfloat16 else \
        "matmul_tflops_fp32_host"
    return {key: 2 * n ** 3 / dt / 1e12, "matmul_n": n}


def _probe_h2d(device: torch.device) -> Dict:
    """Host→device MB/s of a 64 MiB buffer, pinned and pageable, each
    confirmed by a reduction read back from the card."""
    if device.type == "cpu":
        return {"host_to_device": "not applicable with --device cpu"}
    host = torch.from_numpy(
        np.random.default_rng(1).random(_H2D_BYTES // 4, np.float32))
    out = {}
    for label, src in (("pinned", host.pin_memory()), ("pageable", host)):
        for timed in (False, True):
            t0 = time.perf_counter()
            dev = src.to(device, non_blocking=label == "pinned")
            float(dev.sum())
            if timed:
                out[f"host_to_device_MBps_{label}"] = src.numel() * 4 / 1e6 / (
                    time.perf_counter() - t0)
    return out


def _probe_decode() -> Dict:
    import cv2

    from pose3d_tpu_torch.data import native

    img = np.random.default_rng(2).integers(0, 255, size=(500, 500, 3),
                                            dtype=np.uint8)
    ok, enc = cv2.imencode(".jpg", img)
    assert ok
    blobs = [enc.tobytes()] * 32
    native.decode_jpeg_batch(blobs[:2], (500, 500), num_threads=8)
    t0 = time.perf_counter()
    native.decode_jpeg_batch(blobs, (500, 500), num_threads=8)
    return {"host_decode_imgs_per_sec": len(blobs) / (time.perf_counter()
                                                      - t0),
            "host_decode_route": native.decode_route()}


def _probe_kernels() -> Dict:
    """Load each kernel library, building it at first use; a failure is
    reported beside its name, not raised."""
    out: Dict = {}
    loaded = 0
    for name in kernel_names():
        try:
            _build.load(name)
            info = _build.build_info.get(name, {})
            out[f"kernel_{name}"] = (f"loaded, build "
                                     f"{info.get('seconds', 0.0):.2f} s")
            loaded += 1
        except (RuntimeError, OSError) as e:
            out[f"kernel_{name}"] = f"FAILED: {str(e).splitlines()[0]}"
    out["kernels_loaded"] = f"{loaded} of {len(kernel_names())}"
    return out


def _probe(device: torch.device) -> Dict:
    out: Dict = {"probed_device": (torch.cuda.get_device_name(device)
                                   if device.type == "cuda" else "cpu (host)")}
    out.update(_probe_matmul(device))
    out.update(_probe_h2d(device))
    out.update(_probe_decode())
    out.update(_probe_kernels())
    return out


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(
        "pose3d-torch-doctor", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--probe", action="store_true",
                        help="Run quick probes: card matmul, host→device "
                             "copies, host decode, and a load (building at "
                             "first use) of every kernel library")
    parser.add_argument("--json", type=str, default=None,
                        help="Also write the report as JSON")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default): the card; cpu: probe the host")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    device = torch.device(args.device)

    report: Dict = {"versions": _versions(), "devices": _devices(device),
                    "toolchain": _toolchain(), "kernels": _kernels(),
                    "install": _install()}
    no_card = device.type == "cuda" and not torch.cuda.is_available()
    if args.probe and not no_card:
        report["probe"] = _probe(device)

    for section, values in report.items():
        logger.info("%s:", section)
        for k, v in values.items():
            logger.info("  %-28s %s", k, v)

    warnings = []
    if report["toolchain"]["native_decoder_error"]:
        warnings.append("native decoder not built (%s) — decoding through "
                        "cv2" % report["toolchain"]["native_decoder_error"]
                        .splitlines()[0])
    if report["toolchain"]["nvcc"].startswith("missing"):
        warnings.append("nvcc not found — the kernels cannot be built here")
    if "console_scripts_note" in report["install"]:
        warnings.append("console scripts unknown (%s) — run `pip install -e "
                        ". --no-build-isolation`"
                        % report["install"]["console_scripts_note"])
    if report["install"]["console_scripts_missing"]:
        warnings.append(
            "console scripts missing (%s) — re-run `pip install -e . "
            "--no-build-isolation`"
            % ", ".join(report["install"]["console_scripts_missing"]))
    if no_card:
        warnings.append("no CUDA device visible")
    failed = [k for k, v in report.get("probe", {}).items()
              if str(v).startswith("FAILED")]
    if failed:
        warnings.append("kernel libraries failed to load: "
                        + ", ".join(failed))
    for w in warnings:
        logger.warning("WARNING: %s", w)
    report["warnings"] = warnings

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, default=str)
    if args.probe and no_card:
        raise SystemExit("--probe: CUDA is not available, so there is no card "
                         "to probe (pass --device cpu to probe the host)")
    return report


def cli(argv=None) -> int:
    """Console-script entry: diagnostics are informational — 0 unless the
    report could not be produced (``--probe`` without a card)."""
    main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(cli())

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``pose3d_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: card name and power limit, torch/CUDA/nvcc versions;
  2. build: every kernel of the serving path, from ``pose3d_tpu_torch/csrc``
     (build seconds and ptxas register/shared-memory/spill lines);
  3. kernels: each kernel against its plain PyTorch version at every shape
     the path gives it, in bf16 and fp32, with the tolerances below;
  4. slice: the full published transformer config (random weights from a
     seeded generator) saved as a reference-schema ``.pth``, served by the
     port's HTTP server, answering concurrent ``/predict`` requests; the
     answers are checked against a direct forward with the plain attention,
     and the kernel's launch count against 20 attentions per device call;
  5. times: kernel vs plain version per shape, the batch-8 forward with
     each, and per-request latency, each with the card's name and power
     limit.

Standard output ends with a JSON line of the kernels and, last, one JSON
line ``{"ok": true, "device": {...}}``. Without CUDA, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# (Tq, Tk, H, D) of every attention in the full-width lifter's forward:
# ViT blocks, fusion image→heatmap and heatmap→image, final blocks.
PATH_SHAPES = [(1025, 1025, 12, 64), (1024, 16, 16, 48), (16, 1024, 16, 48),
               (1041, 1041, 16, 48)]
RAGGED_SHAPES = [(1, 1, 4, 64), (17, 130, 4, 48), (130, 17, 4, 64)]
# Max |Δ| against the plain version for unit-normal inputs. bf16: the
# kernel rounds P to bf16 against a running (not the final) row max, and o
# itself is bf16 (2^-8 relative), so a couple of ulps of |o| <= ~2; fp32:
# summation order only. lse is fp32 in both dtypes.
TOL_O = {"bfloat16": 2e-2, "float32": 1e-4}
TOL_LSE = 1e-3
TOL_SLICE_REL_L2 = 2e-2
REQUEST_BATCHES = [1, 1, 2, 3, 8]


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_environment(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    nvcc = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "--version"], capture_output=True,
        text=True,
    ).stdout.strip().splitlines()
    log(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  nvcc: {nvcc[-1] if nvcc else 'missing'}")
    log(f"[env] device 0: {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from pose3d_tpu_torch.ops.kernels import _build, flash_attention

    t0 = time.perf_counter()
    flash_attention.load_library()
    log(f"[build] flash_attention_fwd: {time.perf_counter() - t0:.2f} s "
        f"-> {_build.library_path('flash_attention_fwd').relative_to(ROOT)}")
    for line in _build.build_info["flash_attention_fwd"]["log"].splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry",
                                   "bytes smem")):
            log("[build]   " + line.strip())


def _qkv(torch, B, Tq, Tk, H, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda T: torch.randn(B, T, H, D, generator=g, device="cuda",  # noqa: E731
                               dtype=torch.float32).to(dtype)
    return mk(Tq), mk(Tk), mk(Tk)


def phase_kernels(torch) -> float:
    from pose3d_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for i, (Tq, Tk, H, D) in enumerate(PATH_SHAPES + RAGGED_SHAPES):
            q, k, v = _qkv(torch, 2, Tq, Tk, H, D, dtype, seed=i)
            o, lse = flash_attention_fwd(q, k, v)
            torch.cuda.synchronize()
            ro, rlse = flash_attention_fwd_reference(q, k, v)
            torch.cuda.synchronize()
            do = (o.float() - ro.float()).abs().max().item()
            dl = (lse - rlse).abs().max().item()
            ok = (o.shape == ro.shape and lse.shape == rlse.shape
                  and o.dtype == dtype and torch.isfinite(o).all().item()
                  and do <= TOL_O[name] and dl <= TOL_LSE)
            worst = max(worst, do)
            log(f"[kernel] {name:8s} B=2 Tq={Tq:4d} Tk={Tk:4d} H={H:2d} "
                f"D={D}: max|do|={do:.3e} (tol {TOL_O[name]:.0e})  "
                f"max|dlse|={dl:.3e} (tol {TOL_LSE:.0e})  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append((name, Tq, Tk, H, D))
    if failures:
        raise SystemExit(f"kernel disagrees with its plain version: {failures}")
    return worst


def _post(url: str, arrays) -> np.ndarray:
    buf = io.BytesIO()
    np.savez(buf, image=arrays[0], depth=arrays[1], keypoints_2d=arrays[2])
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return np.load(io.BytesIO(r.read()))["joints_3d"]


def _get(url: str):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def _request_inputs(seed: int, b: int, hw, joints: int):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(b, *hw, 3)).astype(np.float32),
            rng.uniform(1, 8, size=(b, *hw, 1)).astype(np.float32),
            rng.uniform(0.1, 0.9, size=(b, joints, 2)).astype(np.float32))


def phase_slice(torch, tmp: Path) -> dict:
    from pose3d_tpu_torch.checkpoint import save_pose_model
    from pose3d_tpu_torch.core.config import TransformerModelConfig
    from pose3d_tpu_torch.models import build_model
    from pose3d_tpu_torch.ops.kernels.flash_attention import flash_attention_fwd
    from pose3d_tpu_torch.serve_http import make_server

    cfg = TransformerModelConfig()
    attn_per_forward = (cfg.vit_depth + 2 * cfg.num_cross_modal_layers
                        + cfg.final_encoder_depth)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16,
                        generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    pth = save_pose_model(model, tmp / "lifter.pth")
    del model
    log(f"[slice] full config: {n_params / 1e6:.1f} M params -> {pth}")

    flash_attention_fwd.launches = 0
    srv = make_server(pth, "127.0.0.1", 0, device="cuda", max_batch=8)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_port}"
    hw, J = tuple(cfg.image_size), cfg.num_joints
    try:
        t0 = time.monotonic()
        while True:
            try:
                if _get(base + "/healthz")[0] == 200:
                    break
            except urllib.error.HTTPError as e:
                body = json.loads(e.read() or b"{}")
                if body.get("status") == "failed":
                    raise SystemExit(f"server warmup failed: {body}")
            if time.monotonic() - t0 > 600:
                raise SystemExit("server not healthy after 600 s")
            time.sleep(0.2)
        log(f"[slice] /healthz 200 after {time.monotonic() - t0:.1f} s")

        reqs = [_request_inputs(100 + i, b, hw, J)
                for i, b in enumerate(REQUEST_BATCHES)]
        with ThreadPoolExecutor(len(reqs)) as ex:
            answers = list(ex.map(lambda a: _post(base + "/predict", a), reqs))
        launches = flash_attention_fwd.launches
        _, meta = _get(base + "/meta")
        calls = meta["batching"]["device_calls"]
        for b, ans in zip(REQUEST_BATCHES, answers):
            if ans.shape != (b, J, 3) or not np.isfinite(ans).all():
                raise SystemExit(f"bad answer {ans.shape} for batch {b}")
        log(f"[slice] {len(reqs)} concurrent /predict (batches "
            f"{REQUEST_BATCHES}) answered: shapes ok, finite; meta "
            f"{meta['batching']}")
        log(f"[slice] kernel launches {launches} = {attn_per_forward} x "
            f"{calls} device calls? {launches == attn_per_forward * calls}")
        if launches != attn_per_forward * calls or calls == 0:
            raise SystemExit("the served path did not run the kernel once "
                             "per attention")

        latency = {}
        for b in (1, 8):
            a = _request_inputs(7, b, hw, J)
            ts = []
            for _ in range(10):
                t = time.perf_counter()
                _post(base + "/predict", a)
                ts.append((time.perf_counter() - t) * 1e3)
            latency[b] = statistics.median(ts)
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
        thread.join(timeout=30)

    ref_model = build_model(cfg, device="cuda", dtype=torch.bfloat16,
                            attention_impl="reference")
    ref_model.load_state_dict(
        torch.load(pth, map_location="cuda", weights_only=True)
        ["model_state_dict"])
    with torch.inference_mode():
        want = [ref_model(*[torch.from_numpy(x).cuda() for x in a])
                .cpu().numpy() for a in reqs]
    got, want = np.concatenate(answers), np.concatenate(want)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    log(f"[slice] served (kernel) vs direct forward (plain attention): "
        f"rel L2 {rel:.3e} (tol {TOL_SLICE_REL_L2:.0e})")
    if not rel <= TOL_SLICE_REL_L2:
        raise SystemExit("served answers disagree with the plain forward")
    return {"launches": launches, "device_calls": calls, "latency": latency,
            "ref_model": ref_model, "pth": pth, "cfg": cfg}


def _time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_times(torch, card: str, sl: dict) -> dict:
    from pose3d_tpu_torch.checkpoint import load_pose_model
    from pose3d_tpu_torch.models import dummy_inputs
    from pose3d_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    times = {}
    for i, (Tq, Tk, H, D) in enumerate(PATH_SHAPES):
        q, k, v = _qkv(torch, 8, Tq, Tk, H, D, torch.bfloat16, seed=50 + i)
        plain = lambda: flash_attention_fwd_reference(q, k, v)  # noqa: E731
        kern = lambda: flash_attention_fwd(q, k, v)  # noqa: E731
        # plain, kernel, kernel, plain
        p1 = _time_ms(torch, plain, 50)
        k1 = _time_ms(torch, kern, 50)
        k2 = _time_ms(torch, kern, 50)
        p2 = _time_ms(torch, plain, 50)
        kt, pt = (k1 + k2) / 2, (p1 + p2) / 2
        flop = 2 * 8 * H * Tq * Tk * (D + D)
        times[(Tq, Tk, H, D)] = (kt, pt)
        log(f"[time] attention bf16 B=8 Tq={Tq} Tk={Tk} H={H} D={D}: "
            f"kernel {kt:.4f} ms ({flop / kt / 1e9:.1f} TFLOP/s), plain "
            f"{pt:.4f} ms  [{card}]")

    model, _ = load_pose_model(sl["pth"], "cuda")
    ref_model = sl["ref_model"]
    args = dummy_inputs(sl["cfg"], 8, device="cuda")
    with torch.inference_mode():
        f_plain = lambda: ref_model(*args)  # noqa: E731
        f_kern = lambda: model(*args)  # noqa: E731
        p1 = _time_ms(torch, f_plain, 10)
        k1 = _time_ms(torch, f_kern, 10)
        k2 = _time_ms(torch, f_kern, 10)
        p2 = _time_ms(torch, f_plain, 10)
    log(f"[time] batch-8 forward, full config bf16: kernel attention "
        f"{(k1 + k2) / 2:.3f} ms, plain attention {(p1 + p2) / 2:.3f} ms "
        f"(runs {k1:.3f}/{k2:.3f} vs {p1:.3f}/{p2:.3f})  [{card}]")
    for b, ms in sl["latency"].items():
        log(f"[time] /predict latency, batch {b}, median of 10 sequential "
            f"requests: {ms:.2f} ms  [{card}]")
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import pose3d_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    if Path(pose3d_tpu_torch.__file__).resolve().parent != ROOT / "pose3d_tpu_torch":
        print("chip_smoke: pose3d_tpu_torch was not imported from this "
              "checkout", file=sys.stderr)
        return 2

    card = phase_environment(torch)
    phase_build()
    worst = phase_kernels(torch)
    with tempfile.TemporaryDirectory(prefix="pose3d_chip_smoke_") as tmp:
        sl = phase_slice(torch, Path(tmp))
        times = phase_times(torch, card, sl)
    vit = times[PATH_SHAPES[0]]
    if "jax" in sys.modules or "flax" in sys.modules:
        raise SystemExit("JAX was imported")
    log(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "pose3d_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "pose3d_tpu/ops/pallas/flash_attention.py:49",
        "launches": sl["launches"],
        "max_abs_err": worst,
        "ms": vit[0],
        "plain_ms": vit[1],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

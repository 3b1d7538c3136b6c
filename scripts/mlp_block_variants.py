"""Where the time goes inside the ``mlp_block`` ``wgmma`` kernels: build
textual variants of the two CUDA sources with parts taken out (the GELU,
the first or second product's ``wgmma``s, or all arithmetic, which leaves
the TMA loads, the barriers and the stores; the forward also with a
shallower ring of stages) and time each at bf16, N 8,200, D 768, H 3,072
beside the unchanged source.

    PYTHONPATH=. python scripts/mlp_block_variants.py [--only fwd|bwd]

A variant's outputs are wrong by construction; only its time means
something. "loads only" is the floor that the stream of weight and
activation tiles into an SM's shared memory sets for the design: what the
arithmetic adds on top is what better overlap could still win. Variants are
compiled under the system's temporary directory, one ``nvcc`` each, in
parallel. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from pose3d_tpu_torch.ops.kernels import _build
from pose3d_tpu_torch.ops.kernels import mlp_block as mb

N, D, H = 8200, 768, 3072
OFF = "if (0) "
NO_N32 = [("wgmma_m64n32k16<", OFF + "wgmma_m64n32k16<")]
NO_N192 = [("wgmma_m64n192k16<", OFF + "wgmma_m64n192k16<")]
NO_GELU = [("gelu(", "(")]
NO_GELU_GRAD = [("gelu_grad(", "(")] + NO_GELU
LOADS_ONLY = NO_N32 + NO_N192 + NO_GELU


def _ring(stages: int):
    return [("constexpr int STAGES = 4;", f"constexpr int STAGES = {stages};")]


VARIANTS = {
    "fwd": [("unchanged", []), ("no GELU", NO_GELU),
            ("no first product (x W1)", NO_N32),
            ("no second product (ga W2)", NO_N192),
            ("loads only", LOADS_ONLY),
            # the ring's depth: where the loads alone stop gaining, the stream
            # into the SM is the limit and not its latency; where the whole
            # kernel still gains, a deeper ring would hide more of the rest
            ("ring of 3 stages", _ring(3)), ("ring of 2 stages", _ring(2)),
            ("loads only, ring of 3", LOADS_ONLY + _ring(3)),
            ("loads only, ring of 2", LOADS_ONLY + _ring(2)),
            ("loads only, ring of 1", LOADS_ONLY + _ring(1))],
    "bwd": [("unchanged", []), ("no GELU, GELU'", NO_GELU_GRAD),
            ("loads only", NO_N32 + NO_N192 + NO_GELU_GRAD)],
}


def _build_variant(out_dir: Path, which: str, tag: str, subs):
    src = (_build.CSRC_DIR / f"mlp_block_{which}.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{which} / {tag}: {old!r} not in the source")
        src = src.replace(old, new)
    stem = re.sub(r"\W+", "_", f"{which}_{tag}")
    cu, so = out_dir / f"{stem}.cu", out_dir / f"{stem}.so"
    cu.write_text(src)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
         "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{which} / {tag}: nvcc failed\n{proc.stderr[-3000:]}")
    return ctypes.CDLL(str(so))


def _ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _kernel_ms(fn) -> dict:
    """Mean device time of each ``mlp_*`` kernel over three calls."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"mlp_(fwd|bwd)_\w+", e.key)
        if m:
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            out[m.group(0)] = round(total / e.count / 1e3, 4)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("fwd", "bwd"))
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"bf16 N={N} D={D} H={H}")
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    dt, f32 = torch.bfloat16, torch.float32
    x, dy = rand(N, D).to(dt), rand(N, D).to(dt)
    w1, w2 = (rand(D, H) * D ** -0.5).to(dt), (rand(H, D) * H ** -0.5).to(dt)
    b1, b2 = rand(H) * 0.1, rand(D) * 0.1
    out, dx = torch.empty_like(x), torch.empty_like(x)
    dw1, dw2 = (torch.empty(s, dtype=f32, device="cuda")
                for s in ((D, H), (H, D)))
    db1, db2 = (torch.empty(s, dtype=f32, device="cuda") for s in (H, D))
    n_scratch = mb.launch_config(N, D, H, 2)["scratch_bytes"] // 4
    scratch = torch.empty(n_scratch, dtype=f32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptr = torch.Tensor.data_ptr

    with tempfile.TemporaryDirectory() as tmp:
        for which in ("fwd", "bwd"):
            if args.only not in (None, which):
                continue
            with ThreadPoolExecutor(8) as ex:
                libs = list(ex.map(
                    lambda v: _build_variant(Path(tmp), which, *v),
                    VARIANTS[which]))
            for (tag, _), lib in zip(VARIANTS[which], libs):
                fn = getattr(lib, f"pose3d_mlp_block_{which}")
                fn.argtypes = mb._ARGTYPES[f"mlp_block_{which}"]
                if which == "fwd":
                    argv = (*map(ptr, (x, w1, b1, w2, b2, out)), 1, N, D, H,
                            stream)
                else:
                    argv = (*map(ptr, (x, w1, b1, w2, dy, dx, dw1, db1, dw2,
                                       db2, scratch)), n_scratch, 1, N, D, H,
                            stream)
                rc = fn(*argv)
                torch.cuda.synchronize()
                if rc != 0:
                    raise SystemExit(f"{which} / {tag}: launch failed ({rc})")
                print(f"[variant] {which} {tag:28s} {_ms(lambda: fn(*argv)):.4f}"
                      f" ms; kernels {_kernel_ms(lambda: fn(*argv))}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

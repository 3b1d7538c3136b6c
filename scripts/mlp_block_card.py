"""Build the two ``mlp_block`` CUDA sources of ``pose3d_tpu_torch`` and
check and time them alone on the card: the quick loop for work on those
kernels (the whole of ``chip_smoke.py`` takes minutes).

    PYTHONPATH=. python scripts/mlp_block_card.py [--no-time] [--only fwd|bwd]

Prints ptxas's registers / spills / shared memory per kernel, then for a
list of shapes the path taken and max |Δ| / max(1, |ref|) of every output
against the plain version, a bitwise repeat, and (bf16, N 8,200, D 768,
H 3,072) the time of each kernel beside the ``F.linear → F.gelu →
F.linear`` sequence. Exits 1 on a disagreement. Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from pose3d_tpu_torch.ops.kernels import _build
from pose3d_tpu_torch.ops.kernels import mlp_block as mb

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
SHAPES = [(64, 128, 96), (1, 128, 512), (513, 128, 512), (63, 768, 96),
          (65, 768, 3056), (193, 768, 3072), (8200, 768, 3072),
          (7, 48, 80), (1, 16, 16)]


def _inputs(N, D, H, dt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    return (rand(N, D).to(dt), (rand(D, H) * D ** -0.5).to(dt),
            rand(H) * 0.1, (rand(H, D) * H ** -0.5).to(dt), rand(D) * 0.1,
            rand(N, D).to(dt))


def _rel(a, r):
    a, r = a.float(), r.float()
    return float((a - r).abs().max() / max(1.0, float(r.abs().max())))


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--only", choices=("fwd", "bwd"))
    args = ap.parse_args()
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    names = [n for n in ("mlp_block_fwd", "mlp_block_bwd")
             if args.only is None or n.endswith(args.only)]
    for name in names:
        mb.load_library(name)
        info = _build.build_info[name]
        print(f"[build] {name}: {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry",
                                       "warning", "error", "Performance")):
                print("   ", line.strip())
    bad = 0
    for dt in (torch.bfloat16, torch.float32):
        for N, D, H in SHAPES:
            x, w1, b1, w2, b2, dy = _inputs(N, D, H, dt, N + D + H)
            cfg = mb.launch_config(N, D, H, x.element_size())
            line = f"{str(dt)[6:]:9s} N={N:5d} D={D:3d} H={H:4d} {cfg['path']:6s}"
            if args.only in (None, "fwd"):
                out = mb.mlp_block_fwd(x, w1, b1, w2, b2)
                torch.cuda.synchronize()
                ref = mb.mlp_block_fwd_reference(x, w1, b1, w2, b2)
                err = _rel(out, ref)
                same = torch.equal(out, mb.mlp_block_fwd(x, w1, b1, w2, b2))
                ok = err <= TOL[dt] and same and bool(
                    torch.isfinite(out).all())
                bad += not ok
                line += f" out {err:.2e}{'' if ok else ' FAIL'}"
            if args.only in (None, "bwd"):
                got = mb.mlp_block_bwd(x, w1, b1, w2, b2, dy)
                torch.cuda.synchronize()
                again = mb.mlp_block_bwd(x, w1, b1, w2, b2, dy)
                refs = mb.mlp_block_bwd_reference(x, w1.float(), b1,
                                                  w2.float(), b2, dy)
                for nm, a, b, r in zip(("dx", "dw1", "db1", "dw2", "db2"),
                                       got, again, refs):
                    err = _rel(a, r)
                    ok = err <= TOL[dt] and torch.equal(a, b)
                    bad += not ok
                    line += f" {nm} {err:.2e}{'' if ok else ' FAIL'}"
            print(line, flush=True)
    if not args.no_time and not bad:
        N, D, H = 8200, 768, 3072
        x, w1, b1, w2, b2, dy = _inputs(N, D, H, torch.bfloat16, 0)
        w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
        b1h, b2h = b1.bfloat16(), b2.bfloat16()

        def lib_fwd():
            return F.linear(F.gelu(F.linear(x, w1t, b1h)), w2t, b2h)

        leaves = [t.clone().requires_grad_() for t in (x, w1t, b1h, w2t, b2h)]

        def lib_bwd():
            o = F.linear(F.gelu(F.linear(leaves[0], leaves[1], leaves[2])),
                         leaves[3], leaves[4])
            return torch.autograd.grad(o, leaves, dy)

        if args.only in (None, "fwd"):
            t = _ms(lambda: mb.mlp_block_fwd(x, w1, b1, w2, b2))
            print(f"[time] fwd kernel {t:.4f} ms ({4 * N * D * H / t / 1e9:.1f}"
                  f" TFLOP/s), library {_ms(lib_fwd):.4f} ms")
        if args.only in (None, "bwd"):
            t = _ms(lambda: mb.mlp_block_bwd(x, w1, b1, w2, b2, dy))
            lf = _ms(lib_fwd)
            print(f"[time] bwd kernel {t:.4f} ms, library fwd+bwd "
                  f"{_ms(lib_bwd):.4f} ms (fwd alone {lf:.4f})")
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    mb.mlp_block_bwd(x, w1, b1, w2, b2, dy)
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if "mlp_bwd" in e.key:
                    total = getattr(e, "device_time_total", None)
                    if total is None:
                        total = e.cuda_time_total
                    print(f"[time]   {e.key[:60]}: "
                          f"{total / e.count / 1e3:.4f} ms")
    print("FAIL" if bad else "OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

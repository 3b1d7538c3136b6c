"""Build the two flash-attention CUDA sources of ``pose3d_tpu_torch`` and
check and time them alone on the card: the quick loop for work on those
kernels (the whole of ``chip_smoke.py`` takes minutes).

    PYTHONPATH=. python scripts/attention_card.py [--no-time] [--only fwd|bwd]
    PYTHONPATH=. python scripts/attention_card.py --variants

Prints ptxas's registers / spills / shared memory per kernel, then for a
list of shapes (the lifter's four, ragged and edge lengths, packed q/k/v
views, the PSA pair D 32 / Dv 64) the path taken, held equal from
``launch_config`` and the built libraries, and the max |Δ| of every output
against the plain version (o absolute, lse absolute, gradients relative to
max(1, |ref|)), with a bitwise repeat of o, lse, dk, dv; then (bf16, B 8)
the time of each kernel at the four shapes of the lifter beside
``scaled_dot_product_attention`` (its backward as device time from
``torch.profiler``; ``--times-only`` the times alone, which also runs
from an unpacked earlier commit: ``cd DIR && PYTHONPATH=. python
<repo>/scripts/attention_card.py --times-only``). Times are the device's:
calls queued behind a busy stream, and ``torch.profiler``'s kernel time
beside them. Exits 1 on a disagreement. ``--variants`` instead
rebuilds the two sources with parts of the ``wgmma`` kernels taken out (the
exponentials, a product's ``wgmma``s, the dQ reduction, or all of them, which
leaves the TMA loads, barriers and stores) and times each beside the
unchanged source at the ViT shape: a variant's outputs are wrong by
construction, only its time means something. Needs one CUDA card and nvcc.
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
import torch.nn.functional as F

from pose3d_tpu_torch.ops.kernels import _build
from pose3d_tpu_torch.ops.kernels import flash_attention as fa

TOL_O = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
TOL_LSE = 1e-3
TOL_GRAD = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
PATH = [(1025, 1025, 12, 64), (1024, 16, 16, 48), (16, 1024, 16, 48),
        (1041, 1041, 16, 48)]
EDGE = ([(t, t, 3, d) for t in (1, 16, 63, 64, 65, 127, 128, 129, 1041)
         for d in (48, 64)]
        + [(t, 130, 2, 64) for t in (1, 63, 129)]
        + [(130, t, 2, 48) for t in (1, 63, 129)])
# (B, Tq, Tk, H, D, Dv, packed): packed self-attention views of one
# [B, T, 3, H, D] projection, and the PSA pair
EXTRA = [(2, 130, 130, 4, 48, 48, True), (2, 1025, 1025, 12, 64, 64, True),
         (2, 400, 400, 6, 32, 64, False)]


def _inputs(B, Tq, Tk, H, D, Dv, dt, seed, packed=False):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)
    if packed:
        q, k, v = rand(B, Tq, 3, H, D).unbind(2)
    else:
        q, k, v = rand(B, Tq, H, D), rand(B, Tk, H, D), rand(B, Tk, H, Dv)
    return q, k, v, rand(B, Tq, H, Dv)


def _rel(a, r):
    a, r = a.float(), r.float()
    return float((a - r).abs().max() / max(1.0, float(r.abs().max())))


def _ms(fn, iters=20):
    """ms a call between two events, the calls queued behind 30 ms of
    device work so that the host has enqueued them all before the first
    starts: the device's time, not the host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(30_000_000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _device_ms(fn, calls=3):
    """Device time of the kernels one call of ``fn`` launches
    (``torch.profiler``, mean over ``calls``)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        total += t
    return total / calls / 1e3


def check(only) -> int:
    bad = 0
    cases = ([(2, *s, s[3], False) for s in PATH]
             + [(2, *s, s[3], False) for s in EDGE] + EXTRA)
    for dt in (torch.bfloat16, torch.float32):
        for i, (B, Tq, Tk, H, D, Dv, packed) in enumerate(cases):
            cfg = fa.launch_config(B, Tq, Tk, H, D, Dv, dt.itemsize)
            lib = fa.library_config(B, Tq, Tk, H, D, Dv, dt.itemsize)
            line = (f"{str(dt)[6:]:9s} B={B} Tq={Tq:4d} Tk={Tk:4d} H={H:2d} "
                    f"D={D} Dv={Dv}{' packed' if packed else ''} "
                    f"{cfg['path']:6s}")
            if lib != cfg:
                bad += 1
                line += f" CONFIG {lib} != {cfg}"
            q, k, v, do = _inputs(B, Tq, Tk, H, D, Dv, dt, i, packed)
            o, lse = fa.flash_attention_fwd(q, k, v)
            torch.cuda.synchronize()
            ro, rlse = fa.flash_attention_fwd_reference(q, k, v)
            eo = float((o.float() - ro.float()).abs().max())
            el = float((lse - rlse).abs().max())
            o2, lse2 = fa.flash_attention_fwd(q, k, v)
            same = torch.equal(o, o2) and torch.equal(lse, lse2)
            ok = (eo <= TOL_O[dt] and el <= TOL_LSE and same
                  and bool(torch.isfinite(o).all()))
            bad += not ok
            line += f" o {eo:.2e} lse {el:.2e}{'' if ok else ' FAIL'}"
            if only != "fwd":
                got = fa.flash_attention_bwd(q, k, v, o, do, lse)
                torch.cuda.synchronize()
                again = fa.flash_attention_bwd(q, k, v, o, do, lse)
                refs = fa.flash_attention_bwd_reference(q, k, v, o, do, lse)
                for nm, a, b, r in zip(("dq", "dk", "dv"), got, again, refs):
                    err = _rel(a, r)
                    ok = (err <= TOL_GRAD[dt] and a.shape == r.shape
                          and bool(torch.isfinite(a).all())
                          and (nm == "dq" or torch.equal(a, b)))
                    bad += not ok
                    line += f" {nm} {err:.2e}{'' if ok else ' FAIL'}"
            print(line, flush=True)
    return bad


def times() -> None:
    card = torch.cuda.get_device_name(0)
    total_k, total_l = 0.0, 0.0
    for Tq, Tk, H, D in PATH:
        q, k, v, do = _inputs(8, Tq, Tk, H, D, D, torch.bfloat16, 50)
        kf = _ms(lambda: fa.flash_attention_fwd(q, k, v))
        kfd = _device_ms(lambda: fa.flash_attention_fwd(q, k, v))
        o, lse = fa.flash_attention_fwd(q, k, v)
        kb = _ms(lambda: fa.flash_attention_bwd(q, k, v, o, do, lse), 10)
        kbd = _device_ms(lambda: fa.flash_attention_bwd(q, k, v, o, do, lse))
        ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        with torch.no_grad():
            lf = _ms(lambda: F.scaled_dot_product_attention(ql, kl, vl))
        ol = F.scaled_dot_product_attention(ql, kl, vl)
        dol = do.transpose(1, 2)
        lbd = _device_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), dol, retain_graph=True))
        flop = 4 * 8 * H * Tq * Tk * D
        print(f"[time] B=8 Tq={Tq} Tk={Tk} H={H} D={D}: fwd {kf:.4f} ms "
              f"({flop / kf / 1e9:.1f} TFLOP/s; {kfd:.4f} device), sdpa "
              f"{lf:.4f}; bwd {kb:.4f} ms ({2.5 * flop / kb / 1e9:.1f} "
              f"TFLOP/s; {kbd:.4f} device), sdpa bwd {lbd:.4f} device  "
              f"[{card}]", flush=True)
        total_k += kf + kb
        total_l += lf + lbd
        # the backward's launches one by one (torch.profiler, mean of 3)
        fa.flash_attention_bwd(q, k, v, o, do, lse)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fa.flash_attention_bwd(q, k, v, o, do, lse)
            torch.cuda.synchronize()
        parts = []
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            name = re.sub(r"\(.*", "", e.key).split("::")[-1]
            parts.append(f"{name} {t / max(1, e.count) / 1e3:.4f}")
        print(f"[time]   backward launches: {', '.join(parts)}", flush=True)
    print(f"[time] sum over the four shapes, fwd + bwd: kernels {total_k:.4f} "
          f"ms, sdpa {total_l:.4f} ms")


OFF = "if (0) "
NO_EXP = [("exp2_approx(fmaf(", "(fmaf(")]
VARIANTS = {
    "flash_attention_fwd": [
        ("unchanged", []), ("no exp", NO_EXP),
        ("exp2f in place of ex2.approx", [("exp2_approx(", "exp2f(")]),
        ("no S = Q K^T", [("wgmma_m64n128k16<", OFF + "wgmma_m64n128k16<")]),
        ("no O += P V", [("wgmma_m64n64k16_rs<", OFF + "wgmma_m64n64k16_rs<")]),
        ("loads only", NO_EXP + [
            ("wgmma_m64n128k16<", OFF + "wgmma_m64n128k16<"),
            ("wgmma_m64n64k16_rs<", OFF + "wgmma_m64n64k16_rs<")])],
    "flash_attention_bwd": [
        ("unchanged", []), ("no exp", NO_EXP),
        ("no dQ reduction", [("tma_reduce_add_4d(", OFF + "tma_reduce_add_4d(")]),
        ("exp2f in place of ex2.approx", [("exp2_approx(", "exp2f(")]),
        ("no dQ product", [("wgmma_m64n32k16<", OFF + "wgmma_m64n32k16<")]),
        ("loads only", NO_EXP + [
            ("tma_reduce_add_4d(", OFF + "tma_reduce_add_4d("),
            ("wgmma_m64n32k16<", OFF + "wgmma_m64n32k16<"),
            ("wgmma_m64n64k16<", OFF + "wgmma_m64n64k16<"),
            ("wgmma_m64n64k16_rs<", OFF + "wgmma_m64n64k16_rs<")])],
}


def _build_variant(out_dir: Path, name: str, tag: str, subs):
    src = (_build.CSRC_DIR / f"{name}.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{name} / {tag}: {old!r} not in the source")
        src = src.replace(old, new)
    stem = re.sub(r"\W+", "_", f"{name}_{tag}")
    cu, so = out_dir / f"{stem}.cu", out_dir / f"{stem}.so"
    cu.write_text(src)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
         "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{name} / {tag}: nvcc failed\n{proc.stderr[-3000:]}")
    return ctypes.CDLL(str(so))


def variants() -> None:
    """Each variant's library stands in for the built one under the same
    wrapper, at the ViT shape, bf16, B 8."""
    card = torch.cuda.get_device_name(0)
    Tq, Tk, H, D = PATH[0]
    q, k, v, do = _inputs(8, Tq, Tk, H, D, D, torch.bfloat16, 50)
    o, lse = fa.flash_attention_fwd(q, k, v)
    calls = {"flash_attention_fwd": lambda: fa.flash_attention_fwd(q, k, v),
             "flash_attention_bwd":
             lambda: fa.flash_attention_bwd(q, k, v, o, do, lse)}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(name, tag, subs) for name, vs in VARIANTS.items()
                for tag, subs in vs]
        with ThreadPoolExecutor(len(jobs)) as ex:
            libs = list(ex.map(
                lambda j: _build_variant(Path(tmp), *j), jobs))
        for (name, tag, _), lib in zip(jobs, libs):
            built = _build._libs[name]
            _build._libs[name] = lib
            try:
                fa.load_library(name)
                ms = _ms(calls[name], 10)
                dev = _device_ms(calls[name])
            finally:
                _build._libs[name] = built
            print(f"[variant] {name} {tag}: {ms:.4f} ms ({dev:.4f} device)"
                  f"  [{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--only", choices=("fwd", "bwd"))
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--times-only", action="store_true",
                    help="times at the lifter's shapes, no checks: also for "
                    "an earlier commit's package, which has no launch_config")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        fa.load_library(name)
        info = _build.build_info[name]
        print(f"[build] {name}: {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry",
                                       "warning", "error", "Performance")):
                print("   ", line.strip())
    if args.variants:
        variants()
        return 0
    if args.times_only:
        times()
        return 0
    bad = check(args.only)
    if not args.no_time and not bad:
        times()
    print("FAIL" if bad else "OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

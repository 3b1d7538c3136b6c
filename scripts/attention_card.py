"""Build the two flash-attention CUDA sources of ``pose3d_tpu_torch`` and
check and time them alone on the card: the quick loop for work on those
kernels (the whole of ``chip_smoke.py`` takes minutes).

    PYTHONPATH=. python scripts/attention_card.py [--no-time] [--only fwd|bwd]
    PYTHONPATH=. python scripts/attention_card.py --variants
    PYTHONPATH=. python scripts/attention_card.py --deep-route

Prints ptxas's registers / spills / shared memory per kernel, then for a
list of shapes (the lifter's four, ragged and edge lengths, packed q/k/v
views, the PSA pair D 32 / Dv 64) the path taken, held equal from
``launch_config`` and the built libraries, and the max |Δ| of every output
against the plain version (o absolute, lse absolute, gradients relative to
max(1, |ref|)), with a bitwise repeat of o, lse, dk, dv; then (bf16, B 8)
the time of each kernel at the four shapes of the lifter beside
``scaled_dot_product_attention`` (its backward as device time from
``torch.profiler``; ``--dump FILE`` the outputs of both kernels at
``DUMP``'s shapes, bf16 and fp32, written to an ``.npz``, which also runs
from an unpacked earlier commit, and ``--against FILE FILE`` two such dumps
held equal, o, lse, dk and dv bitwise (dQ, summed by atomics, to
``TOL_GRAD``); ``--times-only`` the times alone, which also runs
from an unpacked earlier commit: ``cd DIR && PYTHONPATH=. python
<repo>/scripts/attention_card.py --times-only``; ``--shape B,Tq,Tk,H,D``,
repeatable, times those shapes in place of the lifter's). Times are the device's:
calls queued behind a busy stream, and ``torch.profiler``'s kernel time
beside them. Exits 1 on a disagreement. ``--variants`` instead
rebuilds the two sources with parts of the ``wgmma`` kernels taken out (the
exponentials, a product's ``wgmma``s, the dQ reduction, or all of them, which
leaves the TMA loads, barriers and stores) and times each beside the
unchanged source at the ViT shape: a variant's outputs are wrong by
construction, only its time means something. ``--deep-route`` rebuilds
both sources with the deep instance taking head depths past 128 (a copy of
``flash_attention_common.cuh`` with ``attn::deep_pair`` from 128, the
depths padded to multiples of 64 as past 256) and holds it and the (256,
256) pair against the plain pair, then times both at ``DEEP_ROUTE``'s
depths in turns. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
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


# (B, Tq, Tk, H, D, Dv) dumped by --dump: the padded route's pairs on the
# simple paths and the wgmma pair, and past 256 the deep instance
DUMP = [(2, 130, 67, 4, 96, 96), (2, 65, 33, 2, 256, 256),
        (2, 33, 70, 4, 8, 8), (2, 70, 33, 4, 24, 24),
        (2, 129, 65, 4, 48, 96), (2, 65, 129, 4, 24, 40),
        (2, 130, 130, 4, 64, 64), (2, 130, 67, 2, 384, 384),
        (2, 65, 33, 2, 384, 768)]


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


def times(shapes=None) -> None:
    """Times at the lifter's four shapes, or at ``shapes`` ((B, Tq, Tk,
    H, D) each, D = Dv), bf16."""
    card = torch.cuda.get_device_name(0)
    total_k, total_l = 0.0, 0.0
    for B, Tq, Tk, H, D in shapes or [(8, *s) for s in PATH]:
        q, k, v, do = _inputs(B, Tq, Tk, H, D, D, torch.bfloat16, 50)
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
        flop = 4 * B * H * Tq * Tk * D
        print(f"[time] B={B} Tq={Tq} Tk={Tk} H={H} D={D}: fwd {kf:.4f} ms "
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
    print(f"[time] sum over the shapes, fwd + bwd: kernels {total_k:.4f} "
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


# --deep-route: head depths in (128, 256] at B 8, T 1025, H 3, D = Dv
DEEP_ROUTE = [(8, 1025, 1025, 3, d) for d in (256, 200, 160)]
DEEP_FROM = ("(D > 256 || Dv > 256)", "(D > 128 || Dv > 128)")


def _deep_route_libs(out_dir: Path) -> dict:
    """Both sources built with the deep instance taking over past depth 128
    in place of 256 (``attn::deep_pair`` in a copy of the shared header):
    the route that would replace the (256, 256) pair."""
    for h in _build.CSRC_DIR.glob("*.cuh"):
        text = h.read_text()
        if h.name == "flash_attention_common.cuh":
            if DEEP_FROM[0] not in text:
                raise SystemExit(f"{DEEP_FROM[0]!r} not in {h.name}")
            text = text.replace(*DEEP_FROM)
        (out_dir / h.name).write_text(text)

    def build(name):
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}_deep128.so"
        cu.write_text((_build.CSRC_DIR / f"{name}.cu").read_text())
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(so), str(cu)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{name} deep from 128: nvcc failed\n"
                             f"{proc.stderr[-3000:]}")
        return name, ctypes.CDLL(str(so))
    names = ("flash_attention_fwd", "flash_attention_bwd")
    with ThreadPoolExecutor(2) as ex:
        return dict(ex.map(build, names))


class _deep_route:
    """Within the block the launchers run head depths past 128 on the deep
    instance: its libraries stand in for the built ones, and the depths are
    padded to multiples of 64 as past 256 (``padded_pair``)."""

    def __init__(self, libs):
        self.libs = libs

    def __enter__(self):
        self.saved = {n: _build._libs[n] for n in self.libs}
        self.padded_pair = fa.padded_pair
        _build._libs.update(self.libs)
        for n in self.libs:
            fa.load_library(n)

        def padded(D, Dv):
            if max(D, Dv) > 128:
                c = fa.DEEP_CHUNK
                return c * -(-D // c), c * -(-Dv // c)
            return self.padded_pair(D, Dv)
        fa.padded_pair = padded
        return self

    def __exit__(self, *exc):
        _build._libs.update(self.saved)
        fa.padded_pair = self.padded_pair


def deep_route() -> int:
    """The (256, 256) pair against the deep instance at ``DEEP_ROUTE``'s
    depths, bf16 and fp32, forward and backward: each route's outputs held
    against the plain pair, then their times in turns (pair, deep, deep,
    pair) as the device's time, and the deep route's ratio to the pair's.
    Returns the number of disagreements."""
    card = torch.cuda.get_device_name(0)
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs = _deep_route_libs(Path(tmp))
        print(f"[deep-route] both sources rebuilt with the deep instance "
              f"past 128: {time.perf_counter() - t0:.1f} s", flush=True)
        for dt in (torch.bfloat16, torch.float32):
            for B, Tq, Tk, H, D in DEEP_ROUTE:
                q, k, v, do = _inputs(B, Tq, Tk, H, D, D, dt, 70 + D)
                ro, rl = fa.flash_attention_fwd_reference(q, k, v)
                rg = fa.flash_attention_bwd_reference(q, k, v, ro, do, rl)
                routes = {}
                for route in ("pair", "deep"):
                    ctx = (_deep_route(libs) if route == "deep"
                           else contextlib.nullcontext())
                    with ctx:
                        Dp = fa.padded_pair(D, D)[0]
                        o, lse = fa.flash_attention_fwd(q, k, v)
                        g = fa.flash_attention_bwd(q, k, v, o, do, lse)
                    eo = float((o.float() - ro.float()).abs().max())
                    el = float((lse - rl).abs().max())
                    eg = max(_rel(a, r) for a, r in zip(g, rg))
                    ok = (eo <= TOL_O[dt] and el <= TOL_LSE
                          and eg <= TOL_GRAD[dt])
                    bad += not ok
                    routes[route] = (q, k, v, o, do, lse)
                    print(f"[deep-route] {str(dt)[6:]} B={B} T={Tq} H={H} "
                          f"D={D} {route} (run at depth {Dp}): |do| {eo:.2e}, "
                          f"|dlse| {el:.2e}, grad {eg:.2e}  "
                          f"{'ok' if ok else 'FAIL'}", flush=True)
                ms = {("pair", "fwd"): [], ("deep", "fwd"): [],
                      ("pair", "bwd"): [], ("deep", "bwd"): []}
                for route in ("pair", "deep", "deep", "pair"):
                    ctx = (_deep_route(libs) if route == "deep"
                           else contextlib.nullcontext())
                    q_, k_, v_, o_, do_, lse_ = routes[route]
                    with ctx:
                        ms[route, "fwd"].append(_ms(
                            lambda: fa.flash_attention_fwd(q_, k_, v_)))
                        ms[route, "bwd"].append(_ms(
                            lambda: fa.flash_attention_bwd(
                                q_, k_, v_, o_, do_, lse_), 10))
                for d in ("fwd", "bwd"):
                    pair = statistics.mean(ms["pair", d])
                    deep = statistics.mean(ms["deep", d])
                    print(f"[time] deep route {str(dt)[6:]} {d} B={B} T={Tq} "
                          f"H={H} D={D}: pair {ms['pair', d][0]:.4f} / "
                          f"{ms['pair', d][1]:.4f} ms, deep "
                          f"{ms['deep', d][0]:.4f} / {ms['deep', d][1]:.4f} "
                          f"ms: deep / pair {deep / pair:.3f}  [{card}]",
                          flush=True)
    return bad


def dump(path: str) -> None:
    """o, lse, dq, dk, dv at ``DUMP``'s shapes, bf16 and fp32, from seeded
    inputs, written to ``path``."""
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        for i, shape in enumerate(DUMP):
            q, k, v, do = _inputs(*shape, dt, 500 + i)
            o, lse = fa.flash_attention_fwd(q, k, v)
            grads = fa.flash_attention_bwd(q, k, v, o, do, lse)
            tag = f"{str(dt).removeprefix('torch.')}_{'_'.join(map(str, shape))}"
            for name, x in zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *grads)):
                out[f"{tag}_{name}"] = x.float().cpu().numpy()
    np.savez(path, **out)
    print(f"[dump] {len(out)} arrays to {path}")


def against(a: str, b: str) -> int:
    """The number of arrays of two ``--dump`` files that differ: o, lse, dk
    and dv in any bit (or in their names); dQ, which the fp32 atomics of
    the simple paths sum in the order the blocks arrive (not bitwise on a
    repeat), beyond ``TOL_GRAD`` of max(1, |ref|)."""
    x, y = np.load(a), np.load(b)
    names = sorted(set(x.files) | set(y.files))
    bad, dq = [], 0.0
    for n in names:
        if n not in x.files or n not in y.files:
            bad.append(n)
        elif n.endswith("_dq"):
            err = float(np.abs(x[n] - y[n]).max()
                        / max(1.0, float(np.abs(x[n]).max())))
            dq = max(dq, err)
            dt = torch.bfloat16 if n.startswith("bfloat16") else torch.float32
            if err > TOL_GRAD[dt]:
                bad.append(n)
        elif x[n].tobytes() != y[n].tobytes():
            bad.append(n)
    print(f"[against] {len(names) - len(bad)} of {len(names)} arrays agree "
          f"(o, lse, dk, dv bitwise; dQ within {dq:.2e} of max(1, |ref|)); "
          f"differ: {bad or 'none'}")
    return len(bad)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--only", choices=("fwd", "bwd"))
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--times-only", action="store_true",
                    help="times at the lifter's shapes, no checks: also for "
                    "an earlier commit's package, which has no launch_config")
    ap.add_argument("--shape", action="append", default=[],
                    metavar="B,Tq,Tk,H,D",
                    help="with --times-only: time this bf16 shape (D = Dv) "
                    "in place of the lifter's; repeatable")
    ap.add_argument("--deep-route", action="store_true",
                    help="the (256, 256) pair against the deep instance at "
                    "head depths 256, 200 and 160")
    ap.add_argument("--dump", metavar="FILE")
    ap.add_argument("--against", nargs=2, metavar="FILE")
    args = ap.parse_args()
    if args.against:
        return 1 if against(*args.against) else 0
    shapes = [tuple(int(x) for x in s.split(",")) for s in args.shape]
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
    if args.dump:
        dump(args.dump)
        return 0
    if args.variants:
        variants()
        return 0
    if args.deep_route:
        bad = deep_route()
        print("FAIL" if bad else "OK")
        return 1 if bad else 0
    if args.times_only:
        times(shapes)
        return 0
    bad = check(args.only)
    if not args.no_time and not bad:
        times()
    print("FAIL" if bad else "OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

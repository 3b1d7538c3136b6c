"""Build the row kernels of ``pose3d_tpu_torch`` that stream rows and
reduce them (``bn_stats``, the ``layer_norm`` backward, both adding partial
rows across blocks in their one launch, and the ``layer_norm`` forward, a
persistent row stream) and check and time them alone on the card: the
quick loop for work on those kernels (the whole of ``chip_smoke.py`` takes
minutes).

    PYTHONPATH=. python scripts/row_reduce_card.py [--no-time]
    PYTHONPATH=. python scripts/row_reduce_card.py --variants
    cd DIR && PYTHONPATH=. python <repo>/scripts/row_reduce_card.py \
        --times-only
    PYTHONPATH=. python scripts/row_reduce_card.py --scan-step
    ... [--kernels layer_norm_fwd,layer_norm_bwd]

Prints ptxas's registers and spills per kernel (a spill fails), then, for
the three kernels at every shape the paths give them (``bn_stats``: the 13
shapes of the 500x500 CNN's BatchNorms at microbatch 10; ``layer_norm``:
the lifter's 8,200 and 102,500 rows at C 768) and at ragged ones, in bf16
and fp32: the Python mirror of the plan (``launch_config`` and
``fwd_launch_config``) against the plan the built library reports, the max
|Δ| against the plain version, a bitwise repeat, and the kernels
``torch.profiler`` sees in one call (one). Then the device time of each
kernel at the path's shapes (bf16; the ``layer_norm`` forward also fp32 at
8,200 rows) beside its bound, the nearest library call (and its device time
from ``torch.profiler``), each launch's own time from ``torch.profiler``,
and ``bn_stats``'s sum over one microbatch forward (Σ calls × ms).
``--times-only`` prints the times alone, and also runs from an unpacked
earlier commit's package. ``--variants`` rebuilds the sources with a part
taken out (the combine; the row stream; the dx or y stores; the x reads;
the forward's arithmetic, its streaming hint, or all of it) or with another
plan (the forward's stages, its blocks an SM), loads
``scripts/layer_norm_fwd_register_stream.cu`` (the forward as a register
stream, the design measured against its TMA ring) in the forward's place,
and times each beside the unchanged source: a variant that takes a part
out is wrong by construction, only its time means something (the
forward's max |Δy| is printed beside each).
``--scan-step`` times the full-width CNN's scan 10x10 optimizer step
(``batch_pallas``, 590 calls of ``bn_stats``), on the host and as device
kernels, also from an earlier commit's package. ``--kernels`` keeps the
named kernels only. Kernel times are the device's: calls queued behind a
busy stream, inputs rotated through 256 MB of copies so that none is in
the 50 MB L2. Exits 1 on a disagreement. Needs one CUDA card and nvcc.
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
from pose3d_tpu_torch.ops.kernels import bn_stats as bn
from pose3d_tpu_torch.ops.kernels import layer_norm as ln

HBM_BYTES_S = 3.35e12
PEAK_FP32 = 67e12
# (n, C) of the bn_stats calls of one train-mode forward of the full-width
# batch_pallas CNN at microbatch 10, and how many calls each
BN_PATH = {(625000, 64): 2, (156250, 384): 1, (156250, 128): 5,
           (156250, 64): 1, (39690, 768): 6, (39690, 512): 1,
           (39690, 384): 1, (39690, 256): 5, (10240, 3072): 4,
           (10240, 512): 23, (10240, 256): 8, (640, 1024): 1, (10, 512): 1}
BN_RAGGED = [(n, C) for n in (1, 7, 10, 1025) for C in (3, 64, 3072)]
LN_PATH = [(8 * 1025, 768), (100 * 1025, 768)]
LN_RAGGED = ([(r, c) for r in (1, 7, 513) for c in (3, 100, 640)]
             + [(130, 2056), (8 * 1024, 768), (8 * 16, 768)])
TOL_BN = 1e-5
TOL_LN = {torch.bfloat16: 1.6e-2, torch.float32: 1e-5}
TOL_LN_STATS = 1e-5


def _rel(a, r):
    a, r = a.float(), r.float()
    return float((a - r).abs().max() / max(1.0, float(r.abs().max())))


def _ms(fn, iters=20):
    """ms a call between two events, the calls queued behind 30 ms of
    device work: the device's time, not the host's launch rate."""
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


def _kernels(fn, calls=5, tries=3):
    """{kernel name: (launches per call, device ms per call)} of the CUDA
    kernels ``torch.profiler`` records over ``calls`` calls of ``fn``. A
    trace starts with a short sleep kernel, which is left out: a trace can
    miss the first kernel after it starts, and now and then records none;
    one without the sleep kernel is taken again, up to ``tries`` times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out, slept = {}, False
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            if "spin" in e.key or "sleep" in e.key:
                slept = True
                continue
            if t <= 0:
                continue
            key = e.key.replace("(anonymous namespace)::", "")
            name = re.split(r"[<(]", re.sub(r"^void ", "", key))[0]
            name = name.split("::")[-1].strip()
            n, ms = out.get(name, (0, 0.0))
            out[name] = (n + e.count / calls, ms + t / calls / 1e3)
        if slept:
            break
    return out


def _rotating(tensors, nbytes):
    copies = max(1, min(64, -(-(256 << 20) // nbytes)))
    sets = [tuple(t.clone() for t in tensors) for _ in range(copies)]
    turn = [0]

    def nxt():
        turn[0] = (turn[0] + 1) % copies
        return sets[turn[0]]
    return nxt


def _ln_inputs(rows, C, dt, seed):
    """x, scale, bias, the plain forward's mean and rstd, and a cotangent."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*s):
        return torch.randn(*s, generator=g, device="cuda")
    x = (rand(rows, C) * 1.5 + 0.3).to(dt)
    scale, bias = rand(C) * 0.1 + 1.0, rand(C) * 0.1
    _, mean, rstd = ln.layer_norm_fwd_reference(x, scale, bias, 1e-6)
    return x, scale, bias, mean, rstd, rand(rows, C).to(dt)


def _check_ln_fwd(rows, C, dt, x, scale, bias) -> bool:
    name = str(dt)[6:]
    cfgs = [(ln.fwd_launch_config(rows, C, dt.itemsize, al),
             ln.fwd_library_config(rows, C, dt.itemsize, al))
            for al in (True, False)]
    got = ln.layer_norm_fwd(x, scale, bias, 1e-6)
    torch.cuda.synchronize()
    again = ln.layer_norm_fwd(x, scale, bias, 1e-6)
    errs = [_rel(a, r) for a, r in zip(
        got, ln.layer_norm_fwd_reference(x, scale, bias, 1e-6))]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    kern = _kernels(lambda: ln.layer_norm_fwd(x, scale, bias, 1e-6), 3)
    ok = (all(a == b for a, b in cfgs) and same
          and errs[0] <= TOL_LN[dt] and max(errs[1:]) <= TOL_LN_STATS
          and len(kern) == 1 and list(kern.values())[0][0] == 1)
    cfg = cfgs[0][0]
    print(f"[check] layer_norm_fwd {name:8s} rows={rows:6d} C={C:4d} "
          f"blocks {cfg['blocks']} ({cfg['blocks_per_sm']} an SM) "
          f"rows a warp {cfg['rows_per_warp']} nv={cfg['nv']}: y "
          f"{errs[0]:.2e} mean {errs[1]:.2e} rstd {errs[2]:.2e}, repeat "
          f"{'equal' if same else 'DIFFERS'}, kernels "
          f"{ {k: v[0] for k, v in kern.items()} }"
          f"{'' if ok else '  FAIL ' + str(cfgs)}", flush=True)
    return ok


def check(kernels) -> int:
    bad = 0
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]
        for i, (n, C) in enumerate(list(BN_PATH) + BN_RAGGED):
            if "bn_stats" not in kernels:
                break
            g = torch.Generator(device="cuda").manual_seed(100 + i)
            x = (torch.randn(n, C, generator=g, device="cuda") * 1.5
                 + 0.3).to(dt)
            cfgs = [(bn.launch_config(n, C, dt.itemsize, al),
                     bn.library_config(n, C, dt.itemsize, al))
                    for al in (True, False)]
            got = bn.bn_stats(x)
            torch.cuda.synchronize()
            again = bn.bn_stats(x)
            errs = [_rel(a, r) for a, r in zip(got, bn.bn_stats_reference(x))]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            kern = _kernels(lambda: bn.bn_stats(x), 3)
            ok = (all(a == b for a, b in cfgs) and same
                  and max(errs) <= TOL_BN and len(kern) == 1
                  and list(kern.values())[0][0] == 1)
            bad += not ok
            cfg = cfgs[0][0]
            print(f"[check] bn_stats {name:8s} n={n:6d} C={C:4d} grid "
                  f"{cfg['tiles']}x{cfg['blocks']}: "
                  f"s1 {errs[0]:.2e} s2 {errs[1]:.2e} (tol {TOL_BN:.0e}), "
                  f"repeat {'equal' if same else 'DIFFERS'}, kernels "
                  f"{ {k: v[0] for k, v in kern.items()} }"
                  f"{'' if ok else '  FAIL ' + str(cfgs)}", flush=True)
        for i, (rows, C) in enumerate(LN_PATH + LN_RAGGED):
            x, scale, bias, mean, rstd, dy = _ln_inputs(rows, C, dt, 200 + i)
            if "layer_norm_fwd" in kernels:
                bad += not _check_ln_fwd(rows, C, dt, x, scale, bias)
            if "layer_norm_bwd" not in kernels:
                continue
            cfgs = [(ln.launch_config(rows, C, dt.itemsize, al),
                     ln.library_config(rows, C, dt.itemsize, al))
                    for al in (True, False)]
            got = ln.layer_norm_bwd(x, scale, mean, rstd, dy)
            torch.cuda.synchronize()
            again = ln.layer_norm_bwd(x, scale, mean, rstd, dy)
            refs = ln.layer_norm_bwd_reference(x, scale, mean, rstd, dy)
            errs = [_rel(a, r) for a, r in zip(got, refs)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            kern = _kernels(lambda: ln.layer_norm_bwd(x, scale, mean, rstd,
                                                      dy), 3)
            ok = (all(a == b for a, b in cfgs) and same
                  and errs[0] <= TOL_LN[dt] and max(errs[1:]) <= TOL_LN_STATS
                  and len(kern) == 1 and list(kern.values())[0][0] == 1)
            bad += not ok
            cfg = cfgs[0][0]
            print(f"[check] layer_norm_bwd {name:8s} rows={rows:6d} C={C:4d} "
                  f"blocks {cfg['blocks']} nv={cfg['nv']}: "
                  f"dx {errs[0]:.2e} dscale {errs[1]:.2e} dbias "
                  f"{errs[2]:.2e}, repeat {'equal' if same else 'DIFFERS'}, "
                  f"kernels { {k: v[0] for k, v in kern.items()} }"
                  f"{'' if ok else '  FAIL ' + str(cfgs)}", flush=True)
    return bad


def _split(kern) -> str:
    return ", ".join(f"{k} x{v[0]:g} {v[1]:.4f} ms" for k, v in kern.items())


def _device_ms(kern) -> float:
    """The device ms of one call, summed over its kernels."""
    return sum(v[1] for v in kern.values())


def times(kernels) -> None:
    card = torch.cuda.get_device_name(0)
    if "layer_norm_fwd" in kernels:
        times_ln_fwd(card)
    tot = {"kernel": 0.0, "bound": 0.0, "library": 0.0}
    for (n, C), calls in BN_PATH.items():
        if "bn_stats" not in kernels:
            break
        g = torch.Generator(device="cuda").manual_seed(n + C)
        x = torch.randn(n, C, generator=g, device="cuda").bfloat16()
        nxt = _rotating((x,), n * C * 2)
        kt = _ms(lambda: bn.bn_stats(nxt()[0]))
        lt = _ms(lambda: torch.batch_norm_stats(nxt()[0], 1e-5))
        kern = _kernels(lambda: bn.bn_stats(nxt()[0]))
        nbytes = n * C * 2 + 2 * C * 4
        bound = max(nbytes / HBM_BYTES_S, 3 * n * C / PEAK_FP32) * 1e3
        tot["kernel"] += calls * kt
        tot["bound"] += calls * bound
        tot["library"] += calls * lt
        print(f"[time] bn_stats bf16 n={n} C={C} (x{calls} a forward): "
              f"{kt:.4f} ms ({bound / kt:.0%} of the bound {bound:.4f}), "
              f"batch_norm_stats {lt:.4f}; profiler: {_split(kern)}  "
              f"[{card}]", flush=True)
    if "bn_stats" in kernels:
        print(f"[time] bn_stats over one microbatch forward (59 calls): "
              f"kernel {tot['kernel']:.4f} ms, bound {tot['bound']:.4f} "
              f"({tot['bound'] / tot['kernel']:.0%}), batch_norm_stats "
              f"{tot['library']:.4f}; a scan 10x10 step (x10): "
              f"{10 * tot['kernel']:.3f} ms  [{card}]", flush=True)
    for rows, C in LN_PATH:
        if "layer_norm_bwd" not in kernels:
            break
        x, scale, _, mean, rstd, dy = _ln_inputs(rows, C, torch.bfloat16,
                                                 300)
        nxt = _rotating((x, dy), rows * C * 2)
        kt = _ms(lambda: ln.layer_norm_bwd(nxt()[0], scale, mean, rstd,
                                           nxt()[1]))
        kern = _kernels(lambda: ln.layer_norm_bwd(nxt()[0], scale, mean,
                                                  rstd, nxt()[1]))
        sb, bb = scale.bfloat16(), (scale * 0).bfloat16()
        graphs = []
        for _ in range(max(1, min(64, -(-(256 << 20) // (rows * C * 2))))):
            xl = x.clone().requires_grad_()
            sl, bl = sb.clone().requires_grad_(), bb.clone().requires_grad_()
            graphs.append((F.layer_norm(xl, (C,), sl, bl, 1e-6), (xl, sl, bl),
                           dy.clone()))
        turn = [0]

        def lib_bwd():
            turn[0] = (turn[0] + 1) % len(graphs)
            y, leaves, d = graphs[turn[0]]
            return torch.autograd.grad(y, leaves, d, retain_graph=True)
        lt = _ms(lib_bwd)
        nbytes = 3 * rows * C * 2 + 2 * rows * 4 + 3 * C * 4
        bound = max(nbytes / HBM_BYTES_S, 14 * rows * C / PEAK_FP32) * 1e3
        print(f"[time] layer_norm backward bf16 rows={rows} C={C}: {kt:.4f} "
              f"ms ({bound / kt:.0%} of the bound {bound:.4f}), F.layer_norm "
              f"backward {lt:.4f}; profiler: {_split(kern)}  [{card}]",
              flush=True)
        del graphs, nxt


# the layer_norm forward's timed shapes: the path's two row counts in bf16,
# the lifter's in fp32
LN_FWD_TIMED = [(8 * 1025, 768, torch.bfloat16), (100 * 1025, 768,
                                                  torch.bfloat16),
                (8 * 1025, 768, torch.float32)]


def _ln_fwd_bound(rows, C, itemsize) -> float:
    """ms: x read once, y written once, scale, bias, mean and rstd; some
    eight operations an element at the fp32 rate."""
    nbytes = 2 * rows * C * itemsize + 2 * C * 4 + 2 * rows * 4
    return max(nbytes / HBM_BYTES_S, 8 * rows * C / PEAK_FP32) * 1e3


def times_ln_fwd(card) -> None:
    """The forward at LN_FWD_TIMED: CUDA events around 20 queued calls
    with inputs rotated through 256 MB, torch.profiler's time a launch,
    and F.layer_norm (bf16 scale and bias for a bf16 x: it takes one
    dtype) the same two ways."""
    for rows, C, dt in LN_FWD_TIMED:
        x, scale, bias, *_ = _ln_inputs(rows, C, dt, 300)
        nxt = _rotating((x,), rows * C * dt.itemsize)
        kt = _ms(lambda: ln.layer_norm_fwd(nxt()[0], scale, bias, 1e-6))
        kern = _kernels(lambda: ln.layer_norm_fwd(nxt()[0], scale, bias,
                                                  1e-6))
        sl, bl = scale.to(dt), bias.to(dt)
        lt = _ms(lambda: F.layer_norm(nxt()[0], (C,), sl, bl, 1e-6))
        lk = _kernels(lambda: F.layer_norm(nxt()[0], (C,), sl, bl, 1e-6))
        bound = _ln_fwd_bound(rows, C, dt.itemsize)
        print(f"[time] layer_norm forward {str(dt)[6:]} rows={rows} C={C}: "
              f"{kt:.4f} ms ({bound / kt:.0%} of the bound {bound:.4f}), "
              f"F.layer_norm {lt:.4f} ms ({_device_ms(lk):.4f} of device "
              f"kernels); profiler: {_split(kern)}  [{card}]", flush=True)
        del nxt


NO_COMBINE = [("rr::combine<", "if (false) rr::combine<")]
NO_ROWS = {"bn_stats": [("for (long long r = r0 + ty; r < r1;",
                         "for (long long r = r1; r < r1;")],
           "layer_norm_bwd": [("for (; r < r1; r += kWarps)",
                               "for (; r < r0; r += kWarps)")]}
VARIANTS = {
    name: [("unchanged", []),
           ("stream alone (no combine)", NO_COMBINE),
           ("combine alone (no rows read)", NO_ROWS[name])]
    + ([("no dx stores", [("Vec<T, VEC>::store(dx",
                           "if (0) Vec<T, VEC>::store(dx")])]
       if name == "layer_norm_bwd" else [])
    for name in ("bn_stats", "layer_norm_bwd")}
# a plan that differs: the source's constant and the Python mirror's
PLANS = {("bn_stats", "four blocks an SM"): (
    [("constexpr int kPerSM = 3;", "constexpr int kPerSM = 4;")],
    (bn, "_PER_SM", 4))}
VARIANTS["bn_stats"] += [(tag, subs) for (name, tag), (subs, _) in
                         PLANS.items() if name == "bn_stats"]
# the forward: its parts taken out one at a time, other plans, and the
# register stream, a source of its own (a path in place of the
# substitutions)
VARIANTS["layer_norm_fwd"] = [
    ("unchanged", []),
    ("plain y stores (no streaming hint)", [
        ("__stcs(reinterpret_cast<uint4*>(p), t);",
         "*reinterpret_cast<uint4*>(p) = t;"),
        ("__stcs(reinterpret_cast<float4*>(p), make_float4(",
         "*reinterpret_cast<float4*>(p) = (make_float4(")]),
    ("two stages", [("constexpr int kStages = 4;",
                     "constexpr int kStages = 2;")]),
    ("one block an SM", [("return nv * (4 + 2 * vec) <= 64 ? 2 : 1;",
                          "return 1;")]),
    ("the stream alone (rows into the ring and released)", [
        ("if (r >= a.rows) continue;", "if (r >= 0) continue;")]),
    ("no y stores (x read, mean and rstd written)", [
        ("store_y<T, VEC>(y + r * C + c, o);",
         "if (r < 0) store_y<T, VEC>(y + r * C + c, o);")]),
    ("no x reads (y, mean and rstd written)", [
        ("hmma::mbar_expect_tx(bar, n * row_bytes);",
         "hmma::mbar_arrive(bar);"),
        ("for (int w = 0; w < n; ++w) {", "for (int w = 0; w < 0; ++w) {")]),
    ("empty kernel", [
        ("const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;",
         "if (a.rows > 0) return;\n  "
         "const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;"),
        ("const int lane = threadIdx.x & 31;",
         "if (a.rows > 0) return;\n  const int lane = threadIdx.x & 31;")]),
    ("the register stream",
     Path(__file__).with_name("layer_norm_fwd_register_stream.cu")),
]


def _build_variant(out_dir: Path, name: str, tag: str, subs):
    """``csrc/<name>.cu`` with ``subs`` applied (or the source at the path
    ``subs``), built with the package's flags; the loaded library."""
    if isinstance(subs, Path):
        src, subs = subs.read_text(), []
    else:
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
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        proc.stderr + proc.stdout)
    if any(int(a) or int(b) for a, b in spills):
        print(f"[variant] {name} {tag}: ptxas reports a spill", flush=True)
    return ctypes.CDLL(str(so))


def variants(kernels) -> None:
    """Each variant's library stands in for the built one under the same
    wrapper, at the stem and at a 10,240-row shape (bn_stats) and at both
    row counts (layer_norm), bf16. A forward variant's max |Δy| against the
    plain version at 8,200 rows goes beside its times."""
    card = torch.cuda.get_device_name(0)
    calls, fwd_inputs = {}, None
    for n, C in ((625000, 64), (156250, 384), (39690, 768), (10240, 512)):
        x = torch.randn(n, C, device="cuda").bfloat16()
        nxt = _rotating((x,), n * C * 2)
        calls.setdefault("bn_stats", []).append(
            (f"n={n} C={C}", lambda nxt=nxt: bn.bn_stats(nxt()[0])))
    for rows, C in LN_PATH:
        x, scale, bias, mean, rstd, dy = _ln_inputs(rows, C, torch.bfloat16,
                                                    400)
        fwd_inputs = fwd_inputs or (x, scale, bias)
        nxt = _rotating((x, dy), rows * C * 2)
        calls.setdefault("layer_norm_bwd", []).append(
            (f"rows={rows} C={C}",
             lambda nxt=nxt, s=scale, m=mean, r=rstd: ln.layer_norm_bwd(
                 nxt()[0], s, m, r, nxt()[1])))
        calls.setdefault("layer_norm_fwd", []).append(
            (f"rows={rows} C={C}",
             lambda nxt=nxt, s=scale, b=bias: ln.layer_norm_fwd(
                 nxt()[0], s, b, 1e-6)))
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(name, tag, subs) for name, vs in VARIANTS.items()
                if name in kernels for tag, subs in vs]
        with ThreadPoolExecutor(len(jobs)) as ex:
            libs = list(ex.map(lambda j: _build_variant(Path(tmp), *j), jobs))
        for (name, tag, _), lib in zip(jobs, libs):
            built = _build._libs[name]
            _build._libs[name] = lib
            mod, attr, value = PLANS.get((name, tag), ([], (bn, "_PER_SM",
                                                            None)))[1]
            kept = getattr(mod, attr)
            if value is not None:
                setattr(mod, attr, value)
            try:
                _load(name)
                parts = [f"{label} {_ms(fn):.4f} ms"
                         for label, fn in calls[name]]
                if name == "layer_norm_fwd":
                    x, scale, bias = fwd_inputs
                    y = ln.layer_norm_fwd(x, scale, bias, 1e-6)[0]
                    ref = ln.layer_norm_fwd_reference(x, scale, bias, 1e-6)[0]
                    parts.append(f"max|dy|/max(1,|ref|) {_rel(y, ref):.2e}")
            finally:
                _build._libs[name] = built
                setattr(mod, attr, kept)
            print(f"[variant] {name} {tag}: {', '.join(parts)}  [{card}]",
                  flush=True)


def scan_step() -> None:
    """The full-width 500x500 CNN with ``normalization="batch_pallas"``
    (seeded random weights, bf16 compute over fp32 parameters): the bare
    scan 10x10 optimizer step on a device-resident superbatch, host ms of
    two synchronised steps and the device kernels' ms of one
    (``torch.profiler``), with the bn_stats launches a step. Runs with an
    earlier commit's package too; the seeded batches come from
    ``chip_smoke.py`` beside this script."""
    import statistics
    import time

    sys.path.append(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from pose3d_tpu_torch.core.config import CNNModelConfig, GlobalConfig
    from pose3d_tpu_torch.models import build_model
    from pose3d_tpu_torch.ops.losses import LossWeights
    from pose3d_tpu_torch.train import loop, state as tstate, step as tstep

    card = torch.cuda.get_device_name(0)
    g = GlobalConfig()
    A, B = g.gradient_accumulation_steps, g.batch_size
    weights = LossWeights(g.mse_loss_weight, g.l1_loss_weight,
                          g.inter_joint_loss_weight, g.abs_root_loss_weight)
    cfg = CNNModelConfig(normalization="batch_pallas")
    hw, J = tuple(cfg.image_size), cfg.num_joints
    model = build_model(cfg, device="cuda", train=True,
                        dtype=getattr(torch, g.compute_dtype),
                        generator=torch.Generator("cuda").manual_seed(0))
    st = tstate.create_train_state(model, g.learning_rate, g.weight_decay,
                                   ema=True)
    sb = loop.to_device(next(loop._superbatches(
        cs._train_batches(32, A, B, hw, J), A)), "cuda")
    step = tstep.make_train_step(weights, accum_mode="scan", ema_decay=0.999)
    gen = torch.Generator("cuda").manual_seed(1)
    step(st, sb, gen)
    ts = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(st, sb, gen)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    before = bn.bn_stats.launches
    busy = cs._device_busy_ms(cs._profile_once(
        torch, lambda: step(st, sb, gen)))
    print(f"[time] CNN scan {A}x{B} step, batch_pallas: "
          f"{statistics.mean(ts):.1f} ms on the host (runs "
          f"{'/'.join(f'{t:.1f}' for t in ts)}), "
          f"{busy:.1f} ms of device kernels (torch.profiler, one step), "
          f"{bn.bn_stats.launches - before} bn_stats launches  [{card}]",
          flush=True)


NAMES = ("bn_stats", "layer_norm_fwd", "layer_norm_bwd")


def _load(name):
    return bn.load_library() if name == "bn_stats" else ln.load_library(name)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--kernels", default=",".join(NAMES),
                    help="comma-separated, of " + ", ".join(NAMES))
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--scan-step", action="store_true",
                    help="the CNN's scan 10x10 step, host and device ms; "
                    "also for an earlier commit's package")
    ap.add_argument("--times-only", action="store_true",
                    help="times at the path's shapes, no checks: also for an "
                    "earlier commit's package, which has no library_config")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(NAMES):
        ap.error(f"--kernels: {kernels} not all in {NAMES}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    bad = 0
    for name in NAMES:
        _load(name)
        info = _build.build_info[name]
        print(f"[build] {name}: {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry",
                                       "warning", "error")):
                print("   ", line.strip())
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and (int(m.group(1)) or int(m.group(2))):
                bad += 1
    if args.variants:
        variants(kernels)
        return 0
    if args.scan_step:
        scan_step()
        return 0
    if args.times_only:
        times(kernels)
        return 0
    bad += check(kernels)
    if not args.no_time and not bad:
        times(kernels)
    print("FAIL" if bad else "OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

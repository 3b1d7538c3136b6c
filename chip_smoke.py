#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``pose3d_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: card name and power limit, torch/CUDA/nvcc versions;
  2. build: every kernel of the serving and training paths, from
     ``pose3d_tpu_torch/csrc``, one nvcc per source, all started together
     (build seconds and ptxas register/shared-memory/spill lines);
  3. kernels: each kernel against its plain PyTorch version at every shape
     the paths give it, in bf16 and fp32, with the tolerances below;
  4. slice (serving): the full published transformer config (random
     weights from a seeded generator) saved as a reference-schema ``.pth``,
     served by the port's HTTP server, answering concurrent ``/predict``
     requests; the answers are checked against a direct forward with the
     plain attention, and the forward kernel's launch count against 20
     attentions per device call;
  5. train: at the full published width, (a) one batch-2 step with dropout
     off, kernels against the plain pair (loss and whole gradient vector),
     and the bf16 backward kernel alone under the plain forward, with a
     deliberately wrong backward as a control the bound must catch;
     (b) ``train_model`` for 3 optimizer steps at batch 10 × accumulation
     10 with the published dropout, from seeded uint8-compact batches, with
     20 forward and 20 backward kernel launches per forward/backward pass;
     (c) ``evaluate`` over two validation batches, the last one ragged;
     (d) the ``.pth`` that ``train_model`` wrote, served and answering one
     ``/predict``;
  6. times: each kernel vs its plain version per shape, the batch-8
     forward with each, per-request latency, the batch-2 train step with
     each, and the 10×10 train step with the kernels (ms, images/s, peak
     memory), each with the card's name and power limit.

Standard output ends with a JSON line of the kernels and, last, one JSON
line ``{"ok": true, "device": {...}}``. Without CUDA, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
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
from unittest import mock

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
# Backward, max |Δ| of dq, dk, dv against the plain version, relative to
# max(1, max|ref|): bf16 rounds P and dS to bf16 (2^-8) before their
# products and the outputs themselves; fp32 differs by summation order,
# including the atomics that add dQ across K/V tiles.
TOL_GRAD = {"bfloat16": 3e-2, "float32": 1e-4}
TOL_SLICE_REL_L2 = 2e-2
# batch-2 train step at full width, dropout off, against the plain pair:
# loss (relative) and the whole gradient vector (relative L2).
# fp32, kernels vs plain pair: summation order only, so a tight bound
# holds the kernels. bf16, the kernel pair against the fp32 plain run and
# against the bf16 plain pair: 18 blocks of bf16 activations amplify the
# forward's rounding into 1.5e-2 to 8.1e-2 for either pair (three seeded
# batches and inits on the card), and a zeroed dQ or dK reads 0.14 to
# 0.18, so this bound catches only gross faults; a precision fault (P and
# dS rounded to float8_e5m2, 3.4e-2 to 9.8e-2) is invisible here.
TOL_STEP_LOSS = {"bfloat16": 2e-2, "float32": 1e-4}
TOL_STEP_GRAD_REL_L2 = {"bfloat16": 1e-1, "float32": 1e-3}
# The bf16 backward alone: the plain forward under both runs, so only the
# attention backward differs from the plain pair. The kernel reads 1.6e-3
# to 2.2e-3 whole-gradient relative L2 (the same three batches and inits);
# the control, the plain backward with P rounded to float8_e5m2 (2
# mantissa bits) before dV = Pᵀ dO, reads 1.1e-2 to 1.3e-2. The bound
# sits between the two, and every run reads the control again and fails
# unless it lands beyond the bound.
TOL_BWD_STEP_REL_L2 = 5e-3
REQUEST_BATCHES = [1, 1, 2, 3, 8]
# The trainer phase runs GlobalConfig's defaults (the JAX package's: batch
# 10 x accumulation 10, AdamW 1e-3 / 0.01, loss weights 1/1/100/1) for
# this many optimizer steps, one per superbatch, in the JAX default mode
# (grouped: one flat batch of 100 fits in 80 GB, PERF.md).
TRAIN_STEPS = 3
ACCUM_MODE = "grouped"
KERNELS = ("flash_attention_fwd", "flash_attention_bwd")


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
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        list(ex.map(flash_attention.load_library, KERNELS))
    log(f"[build] {len(KERNELS)} kernels in parallel: "
        f"{time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        log(f"[build] {name}: {_build.build_info[name]['seconds']:.2f} s "
            f"-> {_build.library_path(name).relative_to(ROOT)}")
        for line in _build.build_info[name]["log"].splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Compiling entry", "bytes smem")):
                log("[build]   " + line.strip())


def _qkv(torch, B, Tq, Tk, H, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda T: torch.randn(B, T, H, D, generator=g, device="cuda",  # noqa: E731
                               dtype=torch.float32).to(dtype)
    return mk(Tq), mk(Tk), mk(Tk)


def phase_kernels(torch) -> dict:
    from pose3d_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    worst_bwd = 0.0
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

            g = torch.Generator(device="cuda").manual_seed(1000 + i)
            do_ = torch.randn(o.shape, generator=g, device="cuda").to(dtype)
            grads = flash_attention_bwd(q, k, v, o, do_, lse)
            torch.cuda.synchronize()
            refs = flash_attention_bwd_reference(q, k, v, o, do_, lse)
            torch.cuda.synchronize()
            errs = []
            ok = True
            for x, r in zip(grads, refs):
                scale = max(1.0, r.float().abs().max().item())
                err = (x.float() - r.float()).abs().max().item()
                errs.append(err)
                worst_bwd = max(worst_bwd, err)
                ok &= (x.shape == r.shape and x.dtype == dtype
                       and torch.isfinite(x).all().item()
                       and err <= TOL_GRAD[name] * scale)
            log(f"[kernel] bwd {name:8s} B=2 Tq={Tq:4d} Tk={Tk:4d} H={H:2d} "
                f"D={D}: max|d(dq,dk,dv)|=" + ",".join(f"{e:.2e}" for e in errs)
                + f" (tol {TOL_GRAD[name]:.0e}·max(1,|ref|))  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("bwd", name, Tq, Tk, H, D))
    if failures:
        raise SystemExit(f"kernel disagrees with its plain version: {failures}")
    return {"flash_attention_fwd": worst, "flash_attention_bwd": worst_bwd}


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
    from pose3d_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )

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
    flash_attention_bwd.launches = 0
    hw, J = tuple(cfg.image_size), cfg.num_joints
    with _serving(pth) as base:
        reqs = [_request_inputs(100 + i, b, hw, J)
                for i, b in enumerate(REQUEST_BATCHES)]
        with ThreadPoolExecutor(len(reqs)) as ex:
            answers = list(ex.map(lambda a: _post(base + "/predict", a), reqs))
        launches = flash_attention_fwd.launches
        if flash_attention_bwd.launches:
            raise SystemExit("serving launched the backward kernel")
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


class _serving:
    """The port's HTTP server on a free local port for a ``.pth``, healthy
    on entry (its URL), shut down and joined on exit."""

    def __init__(self, pth):
        self.pth = pth

    def __enter__(self) -> str:
        from pose3d_tpu_torch.serve_http import make_server

        self.srv = make_server(self.pth, "127.0.0.1", 0, device="cuda",
                               max_batch=8)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        base = f"http://127.0.0.1:{self.srv.server_port}"
        t0 = time.monotonic()
        try:
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
        except BaseException:
            self.__exit__()
            raise
        log(f"[serve] /healthz 200 after {time.monotonic() - t0:.1f} s")
        return base

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.batcher.close()
        self.srv.server_close()
        self.thread.join(timeout=30)
        return False


def _train_batches(seed: int, n: int, b: int, hw, joints: int):
    """``n`` seeded numpy batches of ``b`` samples, already in the
    uint8-compact transfer form (image and depth uint8, per-sample depth
    range), as a chunk-backed loader yields them."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        kpt = rng.uniform(0.1, 0.9, size=(b, joints, 2)).astype(np.float32)
        yield {
            "image": rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8),
            "depth": rng.integers(0, 256, (b, *hw, 1), dtype=np.uint8),
            "depth_scale": np.tile(np.float32([[1.0, 8.0]]), (b, 1)),
            "keypoints_2d": kpt,
            "joints_3d": rng.normal(0.0, 0.3, (b, joints, 3)).astype(
                np.float32),
        }


class _Scalars:
    """``train_model``'s writer: keeps every scalar."""

    def __init__(self):
        self.tags = {}

    def add_scalar(self, tag, value, step):
        self.tags.setdefault(tag, []).append((step, float(value)))

    def flush(self):
        pass


def phase_train(torch, tmp: Path, card: str) -> dict:
    from pose3d_tpu_torch.core.config import (
        GlobalConfig,
        TransformerModelConfig,
    )
    from pose3d_tpu_torch.models import build_model
    from pose3d_tpu_torch.ops.kernels import flash_attention as fa
    from pose3d_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )
    from pose3d_tpu_torch.ops.losses import LossWeights
    from pose3d_tpu_torch.train import loop, state as tstate, step as tstep

    g = GlobalConfig()
    A, B = g.gradient_accumulation_steps, g.batch_size
    weights = LossWeights(g.mse_loss_weight, g.l1_loss_weight,
                          g.inter_joint_loss_weight, g.abs_root_loss_weight)
    compute = getattr(torch, g.compute_dtype)
    cfg = TransformerModelConfig()
    hw, J = tuple(cfg.image_size), cfg.num_joints
    attn = cfg.vit_depth + 2 * cfg.num_cross_modal_layers \
        + cfg.final_encoder_depth
    out = {}

    # (a) batch-2 step, dropout off: kernels vs the plain pair, same init,
    # in fp32 and bf16 compute
    cfg0 = TransformerModelConfig(transformer_dropout_rate=0.0,
                                  regression_dropout=0.0)
    sb = loop.to_device(next(loop._superbatches(
        _train_batches(5, 1, 2, hw, J), 1)), "cuda")

    def one_step(dtype, impl, **patches):
        """(loss, whole gradient in fp64, state, step) of one step from
        the seeded init; ``patches`` replace functions of the kernels'
        module for the step (the isolation and the control below)."""
        model = build_model(
            cfg0, device="cuda", dtype=dtype, train=True,
            attention_impl=impl,
            generator=torch.Generator("cuda").manual_seed(0))
        st = tstate.create_train_state(model)
        step = tstep.make_train_step()
        with contextlib.ExitStack() as stack:
            for name, fn in patches.items():
                stack.enter_context(mock.patch.object(fa, name, fn))
            m = step(st, sb)
        grad = torch.cat([p.grad.flatten() for p in st.trainable()])
        return m["total_loss"].item(), grad.double(), st, step

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    f32, bf16 = torch.float32, torch.bfloat16
    runs = {(dtype, impl): one_step(dtype, impl)
            for dtype in (f32, bf16) for impl in ("reference", "auto")}
    truth = runs[f32, "reference"][1]
    for dtype in (f32, bf16):
        name = str(dtype).removeprefix("torch.")
        l_ref, l_k = runs[dtype, "reference"][0], runs[dtype, "auto"][0]
        grad, plain = runs[dtype, "auto"][1], runs[dtype, "reference"][1]
        dl = abs(l_k - l_ref) / abs(l_ref)
        rel = rel_l2(grad, truth)
        rel_plain = rel_l2(grad, plain)
        ok = (np.isfinite(l_k) and torch.isfinite(grad).all().item()
              and dl <= TOL_STEP_LOSS[name]
              and rel <= TOL_STEP_GRAD_REL_L2[name]
              and rel_plain <= TOL_STEP_GRAD_REL_L2[name])
        extra = ("" if dtype == f32 else
                 f"; vs bf16 plain pair {rel_plain:.3e}; plain pair bf16 "
                 f"vs fp32 {rel_l2(plain, truth):.3e}")
        log(f"[train] (a) batch-2 step {name}, kernels: loss {l_k:.6f} vs "
            f"plain pair {l_ref:.6f} (rel {dl:.2e}, tol "
            f"{TOL_STEP_LOSS[name]:.0e}); gradient vs fp32 plain pair rel "
            f"L2 {rel:.3e} (tol {TOL_STEP_GRAD_REL_L2[name]:.0e}) over "
            f"{grad.numel()} values{extra}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the kernels' train step disagrees with the "
                             "plain pair")

    # the bf16 backward alone, with the plain forward under it, against
    # the plain pair; then the control, which the bound must catch
    def bwd_p_e5m2(q, k, v, o, do, lse):
        dq, dk, _ = flash_attention_bwd_reference(q, k, v, o, do, lse)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        p = torch.exp(s * q.shape[-1] ** -0.5 - lse[..., None])
        dv = torch.einsum("bhqk,bqhd->bkhd",
                          p.to(torch.float8_e5m2).float(), do.float())
        return dq, dk, dv.to(q.dtype)

    plain = runs[bf16, "reference"][1]
    iso = one_step(bf16, "auto",
                   flash_attention_fwd=flash_attention_fwd_reference)[1]
    ctl = one_step(bf16, "reference",
                   flash_attention_bwd_reference=bwd_p_e5m2)[1]
    rel_b, rel_c = rel_l2(iso, plain), rel_l2(ctl, plain)
    ok = (torch.isfinite(iso).all().item() and rel_b <= TOL_BWD_STEP_REL_L2
          and rel_c > TOL_BWD_STEP_REL_L2)
    log(f"[train] (a) batch-2 step bf16, plain forward: kernel backward vs "
        f"plain backward, gradient rel L2 {rel_b:.3e} (tol "
        f"{TOL_BWD_STEP_REL_L2:.0e}); control, P in float8_e5m2 before "
        f"dV: {rel_c:.3e} (must exceed the tol)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the backward kernel's train step disagrees with "
                         "the plain backward, or the check missed its "
                         "control")
    del iso, ctl, plain, truth, grad

    # times, bf16: plain, kernel, kernel, plain (host clock, synchronised)
    def step_ms(impl, n=10):
        _, _, st, step = runs[bf16, impl]
        step(st, sb)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            step(st, sb)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3
    p1, k1 = step_ms("reference"), step_ms("auto")
    k2, p2 = step_ms("auto"), step_ms("reference")
    out["step2"] = ((k1 + k2) / 2, (p1 + p2) / 2)
    log(f"[time] train step, batch 2 (A 1), full config bf16, dropout off: "
        f"kernels {out['step2'][0]:.2f} ms, plain pair {out['step2'][1]:.2f}"
        f" ms (runs {k1:.2f}/{k2:.2f} vs {p1:.2f}/{p2:.2f})  [{card}]")
    del runs, sb
    torch.cuda.empty_cache()

    # (b) train_model at 10 x 10 with the published dropout
    model = build_model(cfg, device="cuda", dtype=compute, train=True,
                        generator=torch.Generator("cuda").manual_seed(0))
    if any(p.dtype != getattr(torch, g.param_dtype)
           for p in model.parameters()):
        raise SystemExit(f"parameters are not {g.param_dtype}")
    st = tstate.create_train_state(model, g.learning_rate, g.weight_decay,
                                   ema=True)
    pth = tmp / "trained.pth"
    writer = _Scalars()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    st, n = loop.train_model(
        st, _train_batches(7, A * TRAIN_STEPS, B, hw, J),
        writer=writer, loss_weights=weights,
        gradient_accumulation_steps=A, num_steps=TRAIN_STEPS,
        max_epochs=1, log_interval_steps=1, eval_interval_steps=10 ** 9,
        accum_mode=ACCUM_MODE, ema_decay=0.999,
        generator=torch.Generator("cuda").manual_seed(g.random_seed),
        checkpoint_path=pth)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": flash_attention_fwd.launches,
                "flash_attention_bwd": flash_attention_bwd.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [v for _, v in writer.tags.get("Loss/train_step", [])]
    passes = TRAIN_STEPS * (1 if ACCUM_MODE == "grouped" else A)
    want = attn * passes
    log(f"[train] (b) train_model, {ACCUM_MODE}, {A}x{B}, "
        f"dropout {cfg.transformer_dropout_rate}/{cfg.regression_dropout}: "
        f"{n} steps in {wall:.1f} s, losses {losses}; launches {launches} "
        f"(want {want} each = {attn} x {passes} forward/backward passes); "
        f"peak memory {peak:.2f} GiB")
    if (n != TRAIN_STEPS or len(losses) != TRAIN_STEPS
            or not np.isfinite(losses).all()
            or any(v != want for v in launches.values())):
        raise SystemExit("train_model did not run its steps through the "
                         "kernels with finite losses")
    loop_ms = [v for _, v in writer.tags.get("Perf/step_time_ms", [])]
    out.update(launches=launches, peak_gib=peak, loop_ms=loop_ms)
    # what the saved .pth must answer, from the weights it holds
    req = _request_inputs(11, 2, hw, J)
    st.model.eval()
    with torch.inference_mode():
        want = st.model(*[torch.from_numpy(x).cuda() for x in req]).cpu()

    # the bare step on a device-resident superbatch (host work excluded)
    sb = loop.to_device(next(loop._superbatches(
        _train_batches(8, A, B, hw, J), A)), "cuda")
    step = tstep.make_train_step(weights, accum_mode=ACCUM_MODE,
                                 ema_decay=0.999)
    gen = torch.Generator("cuda").manual_seed(g.random_seed + 1)
    ts = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(st, sb, gen)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    out["step100"] = statistics.mean(ts)
    log(f"[time] train step, {A}x{B} {ACCUM_MODE}, published "
        f"dropout, EMA, kernels: {out['step100']:.1f} ms (runs "
        f"{'/'.join(f'{t:.1f}' for t in ts)}) = "
        f"{A * B / out['step100'] * 1e3:.1f} images/s on a "
        f"device-resident superbatch; train_model's own step times "
        f"{[round(t, 1) for t in loop_ms]} ms (host batches, H2D "
        f"included); peak memory {peak:.2f} GiB  [{card}]")
    del sb

    # (c) evaluate: a full batch and a ragged one
    ev = loop.evaluate(
        tstep.make_eval_step(weights), st,
        [next(_train_batches(9, 1, B, hw, J)),
         next(_train_batches(10, 1, 7, hw, J))])
    log(f"[train] (c) evaluate over {B}+7 samples: MPJPE "
        f"{ev['mpjpe']:.4f}, PA-MPJPE {ev['pa_mpjpe']:.4f}, loss "
        f"{ev['total_loss']:.4f}")
    if not all(np.isfinite([ev["mpjpe"], ev["pa_mpjpe"]])):
        raise SystemExit("evaluate gave non-finite metrics")

    # (d) the trained .pth, served: one /predict against the weights that
    # train_model saved
    del st, model, step
    torch.cuda.empty_cache()
    with _serving(pth) as base:
        got = _post(base + "/predict", req)
    rel = float(np.linalg.norm(got - want.numpy())
                / np.linalg.norm(want.numpy()))
    log(f"[train] (d) {pth.name} served: /predict {got.shape}, vs the "
        f"trained model's eval forward rel L2 {rel:.3e} (tol "
        f"{TOL_SLICE_REL_L2:.0e})")
    if got.shape != (2, J, 3) or not rel <= TOL_SLICE_REL_L2:
        raise SystemExit("the trained checkpoint does not serve its weights")
    return out


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
        flash_attention_bwd,
        flash_attention_bwd_reference,
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
        times[("fwd", Tq, Tk, H, D)] = (kt, pt)
        log(f"[time] attention bf16 B=8 Tq={Tq} Tk={Tk} H={H} D={D}: "
            f"kernel {kt:.4f} ms ({flop / kt / 1e9:.1f} TFLOP/s), plain "
            f"{pt:.4f} ms  [{card}]")

        o, lse = flash_attention_fwd(q, k, v)
        do_ = torch.randn_like(o)
        plain = lambda: flash_attention_bwd_reference(  # noqa: E731
            q, k, v, o, do_, lse)
        kern = lambda: flash_attention_bwd(q, k, v, o, do_, lse)  # noqa: E731
        p1 = _time_ms(torch, plain, 20)
        k1 = _time_ms(torch, kern, 20)
        k2 = _time_ms(torch, kern, 20)
        p2 = _time_ms(torch, plain, 20)
        kt, pt = (k1 + k2) / 2, (p1 + p2) / 2
        times[("bwd", Tq, Tk, H, D)] = (kt, pt)
        log(f"[time] attention backward bf16 B=8 Tq={Tq} Tk={Tk} H={H} "
            f"D={D}: kernel {kt:.4f} ms ({5 * flop / 2 / kt / 1e9:.1f} "
            f"TFLOP/s), plain {pt:.4f} ms  [{card}]")
        del q, k, v, o, do_, lse

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
        del sl
        tr = phase_train(torch, Path(tmp), card)
    if "jax" in sys.modules or "flax" in sys.modules:
        raise SystemExit("JAX was imported")
    replaces = {"flash_attention_fwd": 49, "flash_attention_bwd": 90}
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"pose3d_tpu_torch/csrc/{name}.cu",
        "replaces": f"pose3d_tpu/ops/pallas/flash_attention.py:{line}",
        "launches": tr["launches"][name],
        "max_abs_err": worst[name],
        "ms": times[(name[-3:], *PATH_SHAPES[0])][0],
        "plain_ms": times[(name[-3:], *PATH_SHAPES[0])][1],
    } for name, line in replaces.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

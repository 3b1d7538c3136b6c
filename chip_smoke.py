#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``pose3d_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: card name and power limit, torch/CUDA/nvcc versions;
  2. build: every kernel of the serving, training and row-op paths (the
     two flash-attention kernels, ``bn_stats``, ``lane_resample``, and the
     forward and backward kernels of ``layer_norm`` and ``mlp_block``:
     eight sources), from ``pose3d_tpu_torch/csrc``, one nvcc per source,
     all started together (build seconds and ptxas
     register/shared-memory/spill lines);
  3. kernels: each kernel against its plain PyTorch version at every shape
     the paths give it and at ragged ones, in bf16 and fp32, with the
     tolerances below (attention: also at the edges of the ``wgmma``
     kernels' tiles, on packed q/k/v views read in place and at YOLO11x's
     PSA pair with a value depth twice the key depth, the path each shape
     takes — ``wgmma`` / ``wmma`` / ``scalar`` — asserted from
     ``launch_config`` and from the built libraries, and the ``wgmma``
     kernels' ptxas report read: a spill or a serialized ``wgmma`` (C7520,
     C7512) fails; ``bn_stats``: forward and the Function's backward;
     ``lane_resample``: order 0 equal, order 1 within 1e-6;
     ``layer_norm`` and ``mlp_block``: forward and backward at the
     lifter's row counts and widths and at ragged ones; ``mlp_block``
     also at the edges of its ``wgmma`` tiling, with the path each shape
     takes (``wgmma`` / ``wmma`` / ``scalar``) asserted from
     ``launch_config`` and from the built libraries; repeats bitwise
     for every kernel that uses no atomics);
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
  6. times: each kernel vs its plain version per shape, beside the least
     time the card could take and one library call as a yardstick
     (``scaled_dot_product_attention`` forward and backward at the four
     attention shapes of the lifter, as device time from ``torch.profiler``
     with the time between events beside it, and each direction's sum
     over one pass's 20 launches,
     ``torch.batch_norm_stats``, ``grid_sample``, ``F.layer_norm`` and its
     backward, and for ``mlp_block`` the three calls ``F.linear → F.gelu →
     F.linear`` and their backward, which write the hidden activation to
     device memory; timed here, used nowhere in the port;
     ``lane_resample`` on the lines that one augmentation with seeded
     draws hands it, its bound counted from those lines; ``layer_norm``
     also at the training-sized 100·1025 rows; for ``mlp_block`` the
     ``wgmma`` path asserted at the full-width shape, ptxas's registers and
     spills per kernel (a spill fails the run), the bound of the
     14·N·D·H the backward executes beside the 10·N·D·H counted, and
     its launches apart from ``torch.profiler`` with each one's rate), the
     batch-8 forward with each (between events, and its device kernels'
     own time from ``torch.profiler``, split into attention, matrix
     products and the rest), per-request latency, the batch-2 train step
     with each, and the 10×10 train step with the kernels (ms, images/s,
     peak memory, and the same split of one step), each with the card's
     name and power limit;
  7. cnn: the CNN lifter at the published full width (500×500), (a)
     ``normalization="batch_pallas"`` trained by ``train_model`` for 3
     optimizer steps at 10 × 10 in ``accum_mode="scan"`` with the published
     dropout and EMA with ``ema_batch_stats``, ``bn_stats`` launched once
     per BatchNorm per microbatch; (b) one batch-10 fp32 step with the
     kernel and with the plain statistics (loss, whole gradient, every
     running mean and variance); (c) ``normalization="batch"`` in the
     default grouped mode at 10 × 10, without ``remat`` when the flat batch
     of 100 fits the card and with it when not (the peak of both is
     printed), and a ``torch.profiler`` split of that step; (d)
     ``evaluate`` over a full and a ragged batch, and (a)'s ``.pth`` served
     and answering one ``/predict``; (e) the same CNN trained by
     ``train_model(augment=make_device_augment(cfg))``: 3 grouped steps
     with rotation on (the two-pass warp, 4 ``lane_resample`` launches per
     step), 3 grouped steps with rotation off (the separable warp, no
     launch), 2 scan steps with rotation on (40 launches per step), each
     timed beside the un-augmented step (host clock, and the device
     kernels' own time of one step each from ``torch.profiler``), and
     evaluated after;
  8. augment: the device augmentor on smooth seeded 500×500 images: the
     two-pass warp on the kernel against the same on the plain version and
     against the exact single-pass oracle, a blob painted at a keypoint
     against the transformed keypoint, the separable warp against the
     oracle (depth equal), and the time of one augmentation of the flat
     batch of 100, split by a ``torch.profiler`` trace of that call into
     the four launches, the layout copies and the rest;
  9. rowops: the two stand-alone differentiable ops, as the JAX package has
     them (no model calls them), at the full-width lifter's shapes and
     with its own seeded weights: ViT block 0's and final block 0's
     ``norm2`` and ``mlp`` carried across by ``layer_norm_params`` and
     ``mlp_params``, ``fused_mlp(layer_norm(x, ...), ...)`` forward and
     backward on tokens [8, 1025, 768] through the two Functions with
     ``impl="auto"`` (one launch of each of the four kernels per pass),
     against the same with ``impl="reference"`` (output and all seven
     gradients) and against the module path the model runs
     (``block.mlp(layer_norm(x, block.norm2))`` and autograd), in bf16 and,
     with TF32 off, in fp32.

Standard output ends with a JSON line of the kernels and, last, one JSON
line ``{"ok": true, "device": {...}}``. Without CUDA, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import shutil
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
# launches of each shape in one forward (or backward) pass of the lifter:
# 12 ViT blocks, 2 fusion layers' two cross attentions, 4 final blocks
PASS_LAUNCHES = dict(zip(PATH_SHAPES, (12, 2, 2, 4)))
# The edges of the wgmma kernels' tiles (64 query rows a warpgroup, 128 a
# forward block; 128 keys a forward tile and a backward block; 64 query rows
# a backward tile): lengths either side of each, and the final blocks' 1041
# = 8·128 + 17, at both of the lifter's depths; and query against key
# lengths across a tile edge. Then self-attention q/k/v as the model hands
# them over, views of one [B, T, 3, H, D] projection read in place ((T, H,
# D)), and YOLO11x's PSA attention, whose key depth is half its value depth
# ((Tq, Tk, H, D, Dv): 20 x 20 tokens, 6 heads), on the WMMA and scalar
# kernels. Every shape's path is asserted from launch_config and from the
# built libraries, and o, lse, dk, dv of a repeat are bitwise equal (dq is
# summed by atomics in an order that varies).
ATTN_EDGES = ([(t, t, 3, d) for t in (1, 16, 63, 64, 65, 127, 128, 129, 1041)
               for d in (48, 64)]
              + [(t, 130, 2, 64) for t in (1, 63, 129)]
              + [(130, t, 2, 48) for t in (1, 63, 129)])
PACKED_SHAPES = [(130, 4, 48), (1025, 12, 64)]
PSA_SHAPE = (400, 400, 6, 32, 64)
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
KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "bn_stats",
           "lane_resample", "layer_norm_fwd", "layer_norm_bwd",
           "mlp_block_fwd", "mlp_block_bwd")
# layer_norm and mlp_block: the row counts the full-width lifter would
# hand them (8 images: ViT tokens, image tokens, heatmap tokens, final
# tokens, norm_out's CLS rows) at C = D 768, H 3072, and ragged ones. Max
# |Δ| against the plain version relative to max(1, max|ref|).
# layer_norm fp32: the sums are taken in another order. bf16: y and dx are
# rounded to bf16 from fp32 values that differ in the last bits, so an
# output may land on the neighbouring bf16 value (2^-8 relative: 8e-3 at
# |y| near 4, held to twice that); mean, rstd, dscale and dbias are fp32 in
# both dtypes. mlp_block fp32: summation order over 768 to 8,328 terms.
# bf16: both sides round gelu(a) and da to bf16 from fp32 values that
# differ in the last bits, and out and dx are bf16 themselves.
ROW_COUNTS = (8 * 1025, 8 * 1024, 8 * 16, 8 * 1041, 8)
ROW_WIDTH, ROW_HIDDEN = 768, 3072
LN_RAGGED = [(r, c) for r in (1, 7, 513) for c in (3, 100, 640)] \
    + [(130, 2056)]
MLP_RAGGED = [(r, 128, 512) for r in (1, 7, 513)]
# The edges of mlp_block's wgmma tiling at D 768: one row either side of a
# 64-row block (63, 64, 65), the last row of the 129th block missing
# (129·64 − 1), one row either side of a 128-row tile of the dW kernel
# where its row groups change (511, 513: G 4 → 3) and a last group that
# holds one row (2,177), hidden widths that end inside a chunk of 64 (96,
# 3,056) or a dW block of 32 (3,056), D an odd multiple of 64; and shapes
# whose D is no multiple of 64, which stay on the WMMA kernels. Every
# shape's path is asserted, in bf16 and (always "scalar") fp32.
MLP_EDGES = [(63, 768, 3072, "wgmma"), (64, 768, 3072, "wgmma"),
             (65, 768, 3072, "wgmma"), (129 * 64 - 1, 768, 3072, "wgmma"),
             (511, 768, 3072, "wgmma"), (513, 768, 3072, "wgmma"),
             (2177, 768, 3072, "wgmma"), (65, 768, 96, "wgmma"),
             (130, 768, 3056, "wgmma"), (70, 192, 80, "wgmma"),
             (7, 48, 80, "wmma"), (33, 720, 160, "wmma")]
TOL_LN = {"bfloat16": 1.6e-2, "float32": 1e-5}
TOL_LN_STATS = 1e-5
# dx = rstd·(gs − mean(gs) − x̂·mean(gs·x̂)) cancels: at C = 3 two of a row's
# three degrees of freedom are projected out while rstd reaches 1/√eps, and
# a last-bit difference in rstd then shows 1.4e-5 of the largest gradient.
# So both backward versions are handed the same statistics, the plain
# forward's, and dx is held to y's bound.
TOL_MLP = {"bfloat16": 2e-2, "float32": 1e-4}
# The row-op path against the module path the model runs (cuBLAS Linears,
# F.layer_norm, exact erf). fp32, TF32 off: the polynomial erf (1.5e-7),
# the one-pass variance and summation order are the only differences, max
# |Δ| relative to max(1, max|ref|). bf16: the module path rounds a to bf16
# before the GELU and the op does not, so single elements differ by bf16
# steps of the hidden activation: relative L2 of each tensor.
TOL_ROWOPS_MODULE_F32 = 1e-4
TOL_ROWOPS_MODULE_BF16_REL_L2 = 2e-2
TRAIN_ROWS = 100 * 1025     # layer_norm's rows in a grouped 10 x 10 step
# bn_stats: (n, C) beside the path's own shapes, in bf16 and fp32; max |Δ|
# of Σx and Σx² against the plain version relative to max(1, max|ref|). Both
# sum in fp32 in another order: over 625,000 rows of magnitude ~1.5 the
# sums reach ~1e6 and an fp32 sum of that length is good to ~1e-6 of it.
BN_RAGGED = [(n, C) for n in (1, 7, 10, 1025) for C in (3, 64, 3072)]
TOL_BN = 1e-5
BN_STEM = (625000, 64)      # the stem's [n, C] at microbatch 10
# The CNN's batch-10 fp32 step, bn_stats kernel against the plain
# statistics (TF32 off), relative: loss and running statistics, and the
# whole gradient (relative L2). Only the order of the fp32 sums differs
# (~1e-6 of Σx and Σx², above), but var = E[x²] − E[x]² cancels and 59
# BatchNorms in sequence pass the difference on: the card gives 6e-6 on the
# loss, 6e-7 on the statistics and 7e-5 on the gradient, so the gradient's
# bound sits above the others'. The plain step run twice differs by 5e-6
# (cuDNN's weight gradients).
TOL_CNN_STEP = 1e-4
TOL_CNN_STEP_GRAD = 3e-4
CNN_STEPS = 3
# lane_resample: (N, W) of every call of the two-pass warp (image rows,
# depth rows) for the CNN at 10 x 10 grouped and scan and the transformer
# grouped, and ragged ones. Kernel and plain version round every operation
# on its own and so see the same positions: order 0 (a pixel pick) must be
# equal; order 1 is held to 1e-6 on inputs in [0, 1] (it reads 0 too).
LR_PATH = [(150000, 500), (50000, 500), (15000, 500), (5000, 500),
           (153600, 512), (51200, 512)]
LR_RAGGED = [(n, w) for n in (1, 13) for w in (1, 50, 129, 200)]
TOL_LR = 1e-6
LR_IMAGE = (150000, 500, 1)     # grouped step: image rows, bilinear
# The augmentor at 500 x 500 on smooth images. Two-pass warp on the kernel
# against the same on the plain version: geometry and depth equal, pixels
# 1e-6. Against the exact single-pass oracle, the bounds of the JAX
# package's own test of its two-pass warp: keypoints 1e-6, joints 1e-4,
# pixel difference mean < 0.01 and max < 0.2 (the sub-pixel shear
# approximation). Separable warp against the oracle: 1e-5, depth equal
# (one-hot weights in full fp32). A blob painted at a keypoint must land
# within 2 px of the transformed keypoint.
TOL_AUG_IMPL = 1e-6
TOL_AUG_SEPARABLE = 1e-5
AUG_STEPS = 3
AUG_SCAN_STEPS = 2
# The card's published peaks (H100 SXM): bytes/s of device memory, dense
# bf16 and plain fp32 operations/s.
HBM_BYTES_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12


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
    from pose3d_tpu_torch.ops.kernels import _build, bn_stats, \
        flash_attention, lane_resample, layer_norm, mlp_block

    def load(name):
        if name == "bn_stats":
            return bn_stats.load_library()
        if name == "lane_resample":
            return lane_resample.load_library()
        if name.startswith("layer_norm"):
            return layer_norm.load_library(name)
        if name.startswith("mlp_block"):
            return mlp_block.load_library(name)
        return flash_attention.load_library(name)

    # every library from the sources of this checkout, never one left by an
    # earlier run: the ptxas report below is read from this build's log
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        list(ex.map(load, KERNELS))
    log(f"[build] {len(KERNELS)} kernels in parallel: "
        f"{time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        log(f"[build] {name}: {_build.build_info[name]['seconds']:.2f} s "
            f"-> {_build.library_path(name).relative_to(ROOT)}")
        for line in _build.build_info[name]["log"].splitlines():
            # C7519 (a warpgroup.arrive that ptxas adds before a wgmma whose
            # registers it cannot follow) comes once per wgmma batch: noise
            if "C7519" not in line and any(
                    w in line for w in ("registers", "spill", "Performance",
                                        "Compiling entry", "bytes smem")):
                log("[build]   " + line.strip())


def _kernel_fns():
    from pose3d_tpu_torch.ops.kernels.bn_stats import bn_stats
    from pose3d_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from pose3d_tpu_torch.ops.kernels.lane_resample import lane_resample
    from pose3d_tpu_torch.ops.kernels.layer_norm import (
        layer_norm_bwd,
        layer_norm_fwd,
    )
    from pose3d_tpu_torch.ops.kernels.mlp_block import (
        mlp_block_bwd,
        mlp_block_fwd,
    )

    return {"flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd": flash_attention_bwd,
            "bn_stats": bn_stats, "lane_resample": lane_resample,
            "layer_norm_fwd": layer_norm_fwd,
            "layer_norm_bwd": layer_norm_bwd,
            "mlp_block_fwd": mlp_block_fwd, "mlp_block_bwd": mlp_block_bwd}


def zero_launch_counts() -> None:
    """Every kernel's launch count to 0, just before a main path runs."""
    for fn in _kernel_fns().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _kernel_fns().items()}


def _qkv(torch, B, Tq, Tk, H, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda T: torch.randn(B, T, H, D, generator=g, device="cuda",  # noqa: E731
                               dtype=torch.float32).to(dtype)
    return mk(Tq), mk(Tk), mk(Tk)


def _attention_cases() -> list:
    """(Tq, Tk, H, D, Dv, packed) of every attention check."""
    return ([(Tq, Tk, H, D, D, False)
             for Tq, Tk, H, D in PATH_SHAPES + RAGGED_SHAPES + ATTN_EDGES]
            + [(T, T, H, D, D, True) for T, H, D in PACKED_SHAPES]
            + [(*PSA_SHAPE, False)])


def _attention_path(dtype_name: str, D: int, Dv: int) -> str:
    if dtype_name == "float32":
        return "scalar"
    return "wgmma" if D == Dv and D in (48, 64) else "wmma"


def _check_attention_build() -> None:
    """The wgmma kernels of both attention sources: registers and spills
    from ptxas; a spill, or a wgmma that ptxas serialized (C7520: under a
    branch it cannot prove uniform; C7512: beside a spill; C7513: an input
    register written by another instruction while a group is in flight),
    fails."""
    from pose3d_tpu_torch.ops.kernels import _build

    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        report = _ptxas_report(name)
        wg = {k: v for k, v in report.items() if "wgmma" in k}
        if len(wg) != 2:
            raise SystemExit(f"{name}: want two wgmma kernels (D 48, 64) in "
                             f"the build log, found {sorted(wg)}")
        for kern, (regs, st, ld) in sorted(wg.items()):
            log(f"[kernel] {kern}: {regs} registers a thread at the entry "
                f"(384 threads; setmaxnreg gives the two consumer warpgroups "
                f"240, the producer 24), spills {st} B stored / {ld} B "
                f"loaded")
            if st or ld:
                raise SystemExit(f"{kern} spills registers")
        serial = [line.strip() for line in
                  _build.build_info[name]["log"].splitlines()
                  if any(c in line for c in ("C7520", "C7512", "C7513"))]
        if serial:
            raise SystemExit(f"{name}: ptxas serialized wgmma: {serial}")


def phase_kernels(torch) -> dict:
    from pose3d_tpu_torch.ops.kernels import flash_attention as fa
    from pose3d_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _check_attention_build()
    worst = 0.0
    worst_bwd = 0.0
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for i, (Tq, Tk, H, D, Dv, packed) in enumerate(_attention_cases()):
            shape = (f"B=2 Tq={Tq:4d} Tk={Tk:4d} H={H:2d} D={D} Dv={Dv}"
                     + (" packed" if packed else ""))
            cfg = fa.launch_config(2, Tq, Tk, H, D, Dv, dtype.itemsize)
            path_ok = (cfg["path"] == _attention_path(name, D, Dv)
                       and fa.library_config(2, Tq, Tk, H, D, Dv,
                                             dtype.itemsize) == cfg)
            g = torch.Generator(device="cuda").manual_seed(i)
            mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(  # noqa: E731
                dtype)
            if packed:
                q, k, v = mk(2, Tq, 3, H, D).unbind(2)
            else:
                q, k, v = mk(2, Tq, H, D), mk(2, Tk, H, D), mk(2, Tk, H, Dv)
            o, lse = flash_attention_fwd(q, k, v)
            torch.cuda.synchronize()
            ro, rlse = flash_attention_fwd_reference(q, k, v)
            o2, lse2 = flash_attention_fwd(q, k, v)
            torch.cuda.synchronize()
            do = (o.float() - ro.float()).abs().max().item()
            dl = (lse - rlse).abs().max().item()
            same = torch.equal(o, o2) and torch.equal(lse, lse2)
            ok = (o.shape == ro.shape and lse.shape == rlse.shape
                  and o.dtype == dtype and torch.isfinite(o).all().item()
                  and do <= TOL_O[name] and dl <= TOL_LSE and same and path_ok)
            worst = max(worst, do)
            log(f"[kernel] {name:8s} {shape} {cfg['path']}: max|do|={do:.3e} "
                f"(tol {TOL_O[name]:.0e})  max|dlse|={dl:.3e} (tol "
                f"{TOL_LSE:.0e})  repeat {'equal' if same else 'DIFFERS'}  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append((name, Tq, Tk, H, D, Dv, packed))

            g = torch.Generator(device="cuda").manual_seed(1000 + i)
            do_ = torch.randn(o.shape, generator=g, device="cuda").to(dtype)
            grads = flash_attention_bwd(q, k, v, o, do_, lse)
            torch.cuda.synchronize()
            again = flash_attention_bwd(q, k, v, o, do_, lse)
            refs = flash_attention_bwd_reference(q, k, v, o, do_, lse)
            torch.cuda.synchronize()
            errs = []
            same = torch.equal(grads[1], again[1]) and torch.equal(
                grads[2], again[2])
            ok = same
            for x, r in zip(grads, refs):
                scale = max(1.0, r.float().abs().max().item())
                err = (x.float() - r.float()).abs().max().item()
                errs.append(err)
                worst_bwd = max(worst_bwd, err)
                ok &= (x.shape == r.shape and x.dtype == dtype
                       and torch.isfinite(x).all().item()
                       and err <= TOL_GRAD[name] * scale)
            log(f"[kernel] bwd {name:8s} {shape}: max|d(dq,dk,dv)|="
                + ",".join(f"{e:.2e}" for e in errs)
                + f" (tol {TOL_GRAD[name]:.0e}·max(1,|ref|))  dk, dv repeat "
                f"{'equal' if same else 'DIFFER'}  {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("bwd", name, Tq, Tk, H, D, Dv, packed))
    worst_bn, worst_bn_rel = _check_bn_stats(torch, failures)
    worst_lr = _check_lane_resample(torch, failures)
    worst_rows = _check_row_ops(torch, failures)
    if failures:
        raise SystemExit(f"kernel disagrees with its plain version: {failures}")
    # every value is a max |Δ| in the output's own units; bn_stats' sums
    # reach ~1e6, so its bound is relative and that reading goes beside it
    return {"flash_attention_fwd": {"max_abs_err": worst},
            "flash_attention_bwd": {"max_abs_err": worst_bwd},
            "bn_stats": {"max_abs_err": worst_bn,
                         "max_err_rel_to_max_1_ref": worst_bn_rel},
            "lane_resample": {"max_abs_err": worst_lr},
            **{name: {"max_abs_err": err} for name, err in worst_rows.items()}}


def _cnn_config(**kw):
    from pose3d_tpu_torch.core.config import CNNModelConfig

    return CNNModelConfig(**kw)


_BN_PATH = []      # (n per sample, C) of every bn_stats call, in call order


def _bn_path_shapes(torch, batch: int) -> list:
    """(n, C) of every bn_stats call in one train-mode forward of the
    full-width ``batch_pallas`` CNN at ``batch`` samples, in call order:
    read off one forward of a single sample on the card (every n is
    rows-per-sample x batch)."""
    from pose3d_tpu_torch.models import build_model, dummy_inputs
    from pose3d_tpu_torch.models.cnn import DotStatsBatchNorm

    if not _BN_PATH:
        cfg = _cnn_config(normalization="batch_pallas",
                          regression_dropout=0.0)
        model = build_model(cfg, device="cuda", stats_impl="reference").train()
        for mod in model.modules():
            if isinstance(mod, DotStatsBatchNorm):
                mod.register_forward_pre_hook(
                    lambda _m, a: _BN_PATH.append(
                        (a[0].numel() // a[0].shape[-1], a[0].shape[-1])))
        with torch.no_grad():
            model(*dummy_inputs(cfg, 1, device="cuda"))
    return [(n * batch, C) for n, C in _BN_PATH]


def _check_bn_stats(torch, failures: list) -> tuple:
    """bn_stats against its plain version, forward and through the
    Function's backward, at the path's shapes (microbatch 10) and the
    ragged ones. Returns the worst forward error seen: max |Δ| of the sums
    as it is, and relative to max(1, max|ref|) as the bound is stated."""
    from pose3d_tpu_torch.ops.kernels.bn_stats import (
        BnStats,
        bn_stats,
        bn_stats_reference,
    )

    path = sorted(set(_bn_path_shapes(torch, 10)), reverse=True)
    worst = worst_rel = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for i, (n, C) in enumerate(path + BN_RAGGED):
            g = torch.Generator(device="cuda").manual_seed(2000 + i)
            x = (torch.randn(n, C, generator=g, device="cuda") * 1.5
                 + 0.3).to(dtype)
            got = bn_stats(x)
            torch.cuda.synchronize()
            again = bn_stats(x)
            refs = bn_stats_reference(x)
            errs = []
            ok = all(torch.equal(a, b) for a, b in zip(got, again))
            for a, r in zip(got, refs):
                scale = max(1.0, r.abs().max().item())
                err_abs = (a - r).abs().max().item()
                err = err_abs / scale
                errs.append(err)
                worst = max(worst, err_abs)
                ok &= (a.shape == (C,) and a.dtype == torch.float32
                       and torch.isfinite(a).all().item() and err <= TOL_BN)
            worst_rel = max(worst_rel, *errs)
            # the Function: kernel forward, closed-form backward
            w = torch.randn(2, C, generator=g, device="cuda")
            grads = []
            for use_kernel in (True, False):
                leaf = x.clone().requires_grad_()
                s1, s2 = BnStats.apply(leaf, use_kernel)
                ((s1 * w[0]).sum() + (s2 * w[1]).sum()).backward()
                grads.append(leaf.grad)
            ok &= (grads[0].dtype == dtype
                   and torch.equal(grads[0], grads[1]))
            log(f"[kernel] bn_stats {name:8s} n={n:6d} C={C:4d}: "
                f"max|d(s1,s2)|/max(1,|ref|)="
                + ",".join(f"{e:.2e}" for e in errs)
                + f" (tol {TOL_BN:.0e}); repeats bitwise, backward equal  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("bn_stats", name, n, C))
    log(f"[kernel] bn_stats worst over all shapes: max|d| {worst:.3e} in the "
        f"sums' own units, {worst_rel:.3e} relative to max(1,|ref|)")
    return worst, worst_rel


def _lane_resample_inputs(torch, n: int, w: int, seed: int):
    """x in [0, 1], a in [-1.3, 1.3], o in ±0.3·W (counted from W−1 for
    the rows with a < 0, which are read right to left)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(n, w, generator=g, device="cuda")
    a = torch.rand(n, generator=g, device="cuda") * 2.6 - 1.3
    o = (torch.rand(n, generator=g, device="cuda") * 0.6 - 0.3) * w \
        + torch.where(a < 0, float(w - 1), 0.0)
    return x, a, o


def _check_lane_resample(torch, failures: list) -> float:
    """lane_resample against its plain version at the path's shapes and
    the ragged ones, both orders. Returns the worst max |Δ| seen."""
    from pose3d_tpu_torch.ops.kernels.lane_resample import (
        lane_resample,
        lane_resample_reference,
    )

    worst = 0.0
    for i, (n, w) in enumerate(LR_PATH + LR_RAGGED):
        x, a, o = _lane_resample_inputs(torch, n, w, 3000 + i)
        for order in (0, 1):
            got = lane_resample(x, a, o, order)
            torch.cuda.synchronize()
            again = lane_resample(x, a, o, order)
            ref = lane_resample_reference(x, a, o, order)
            err = (got - ref).abs().max().item()
            worst = max(worst, err)
            live = (got != 0).float().mean().item()
            ok = (got.shape == (n, w) and got.dtype == torch.float32
                  and torch.isfinite(got).all().item()
                  and torch.equal(got, again)
                  and (torch.equal(got, ref) if order == 0
                       else err <= TOL_LR)
                  and (n * w < 1000 or live > 0.3))
            log(f"[kernel] lane_resample order {order} N={n:6d} W={w:3d}: "
                f"max|d|={err:.2e} ("
                + ("must be equal" if order == 0 else f"tol {TOL_LR:.0e}")
                + f"), {live:.0%} of the outputs inside the row; repeats "
                f"bitwise  {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("lane_resample", order, n, w))
            del got, again, ref
        del x, a, o
    return worst


def _rel_err(got, ref) -> tuple:
    """(max |Δ|, the same relative to max(1, max|ref|)), in fp32."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(1.0, ref.float().abs().max().item())


def _row_inputs(torch, rows: int, D: int, H: int, dtype, seed: int) -> dict:
    """Seeded operands of both row ops at ``rows`` x D (x H): x off-centre
    (mean 0.3, spread 1.5), weights at 1/sqrt(fan-in), and a cotangent."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    return dict(
        x=(rand(rows, D) * 1.5 + 0.3).to(dtype), dy=rand(rows, D).to(dtype),
        scale=rand(D) * 0.1 + 1.0, bias=rand(D) * 0.1,
        w1=(rand(D, H) * D ** -0.5).to(dtype) if H else None,
        b1=rand(H) * 0.1 if H else None,
        w2=(rand(H, D) * H ** -0.5).to(dtype) if H else None,
        b2=rand(D) * 0.1)


def _check_row_ops(torch, failures: list) -> dict:
    """The four kernels of ``layer_norm`` and ``mlp_block`` against their
    plain versions, bf16 and fp32, at the lifter's row counts and widths
    and at ragged ones: outputs' shapes and dtypes, finite values, the
    bounds above, and a bitwise repeat of every output (none of the four
    uses atomics). Returns each kernel's worst max |Δ|."""
    from pose3d_tpu_torch.ops.kernels import layer_norm as ln
    from pose3d_tpu_torch.ops.kernels import mlp_block as mb

    worst = dict.fromkeys(("layer_norm_fwd", "layer_norm_bwd",
                           "mlp_block_fwd", "mlp_block_bwd"), 0.0)

    def held(kernel, label, names, got, again, refs, tols, dtypes):
        """Log one kernel's outputs against the plain version's."""
        ok, parts = True, []
        for name, a, b, r, tol, dt in zip(names, got, again, refs, tols,
                                          dtypes):
            err, rel = _rel_err(a, r)
            worst[kernel] = max(worst[kernel], err)
            ok &= (a.shape == r.shape and a.dtype == dt
                   and torch.isfinite(a).all().item() and torch.equal(a, b)
                   and rel <= tol)
            parts.append(f"{name} {rel:.2e} ({tol:.0e})")
        log(f"[kernel] {kernel} {label}: max|d|/max(1,|ref|) "
            + ", ".join(parts) + f"; repeats bitwise  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append((kernel, label))

    f32 = torch.float32
    for dtype in (torch.bfloat16, f32):
        name = str(dtype).removeprefix("torch.")
        shapes = [(r, ROW_WIDTH) for r in ROW_COUNTS] + LN_RAGGED
        for i, (rows, C) in enumerate(shapes):
            t = _row_inputs(torch, rows, C, 0, dtype, 5000 + i)
            x, scale, bias, dy = t["x"], t["scale"], t["bias"], t["dy"]
            got = ln.layer_norm_fwd(x, scale, bias, 1e-6)
            torch.cuda.synchronize()
            again = ln.layer_norm_fwd(x, scale, bias, 1e-6)
            refs = ln.layer_norm_fwd_reference(x, scale, bias, 1e-6)
            label = f"{name:8s} rows={rows:5d} C={C:4d}"
            held("layer_norm_fwd", label, ("y", "mean", "rstd"), got, again,
                 refs, (TOL_LN[name], TOL_LN_STATS, TOL_LN_STATS),
                 (dtype, f32, f32))
            if got[1].shape != (rows,):
                failures.append(("layer_norm_fwd", label, "stats shape"))
            grads = ln.layer_norm_bwd(x, scale, refs[1], refs[2], dy)
            torch.cuda.synchronize()
            again = ln.layer_norm_bwd(x, scale, refs[1], refs[2], dy)
            brefs = ln.layer_norm_bwd_reference(x, scale, refs[1], refs[2],
                                                dy)
            held("layer_norm_bwd", label, ("dx", "dscale", "dbias"), grads,
                 again, brefs, (TOL_LN[name], TOL_LN_STATS, TOL_LN_STATS),
                 (dtype, f32, f32))
        shapes = [(r, ROW_WIDTH, ROW_HIDDEN, "wgmma") for r in ROW_COUNTS] \
            + [(*s, "wgmma") for s in MLP_RAGGED] + MLP_EDGES
        for i, (rows, D, H, path) in enumerate(shapes):
            t = _row_inputs(torch, rows, D, H, dtype, 6000 + i)
            args = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"])
            # the path: what the plain-Python mirror says, what the built
            # libraries say, and what this shape is here to exercise
            want = path if dtype == torch.bfloat16 else "scalar"
            cfg = mb.launch_config(rows, D, H, t["x"].element_size())
            lib_cfg = mb.library_config(rows, D, H, t["x"].element_size())
            if cfg != lib_cfg or cfg["path"] != want or max(
                    cfg[k]["smem"] for k in ("fwd", "dx", "dw")) > mb.MAX_SMEM:
                log(f"[kernel] mlp_block {name} rows={rows} D={D} H={H}: "
                    f"path {want} expected; launch_config {cfg}; the "
                    f"libraries {lib_cfg}  FAIL")
                failures.append(("mlp_block", name, rows, D, H, "path"))
            out = mb.mlp_block_fwd(*args)
            torch.cuda.synchronize()
            again = mb.mlp_block_fwd(*args)
            ref = mb.mlp_block_fwd_reference(*args)
            label = (f"{name:8s} rows={rows:5d} D={D:3d} H={H:4d} "
                     f"{cfg['path']:6s} G={cfg['groups']}")
            held("mlp_block_fwd", label, ("out",), (out,), (again,), (ref,),
                 (TOL_MLP[name],), (dtype,))
            grads = mb.mlp_block_bwd(*args, t["dy"])
            torch.cuda.synchronize()
            again = mb.mlp_block_bwd(*args, t["dy"])
            # fp32 parameters for the plain version: it returns their
            # gradients in the parameters' dtype, the launcher in fp32
            brefs = mb.mlp_block_bwd_reference(
                t["x"], t["w1"].float(), t["b1"], t["w2"].float(), t["b2"],
                t["dy"])
            held("mlp_block_bwd", label, ("dx", "dw1", "db1", "dw2", "db2"),
                 grads, again, brefs, (TOL_MLP[name],) * 5,
                 (dtype, f32, f32, f32, f32))
            del t, args, out, again, ref, grads, brefs
    return worst


def phase_rowops(torch, card: str) -> dict:
    """The row-op path at full width (phase 9 of the module docstring).
    Returns the launches of the four kernels on it."""
    from pose3d_tpu_torch.core.config import TransformerModelConfig
    from pose3d_tpu_torch.models import build_model
    from pose3d_tpu_torch.models import transformer as tmod
    from pose3d_tpu_torch.ops.kernels.layer_norm import (
        layer_norm,
        layer_norm_params,
    )
    from pose3d_tpu_torch.ops.kernels.mlp_block import fused_mlp, mlp_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerModelConfig()
    D = cfg.transformer_embed_dim
    H = int(D * cfg.transformer_mlp_ratio)
    # train=True for parameters that take gradients; no generator is passed
    # to the modules below, so no dropout mask is drawn
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, train=True,
                        generator=torch.Generator("cuda").manual_seed(0))
    blocks = {"vit block 0 (fc1/fc2)": model.vit_backbone.blocks[0],
              "final block 0 (0/3)": model.final_encoder[0]}
    gen = torch.Generator(device="cuda").manual_seed(17)
    tokens = torch.randn(8, 1025, D, generator=gen, device="cuda") * 1.5 + 0.3
    cot = torch.randn(8, 1025, D, generator=gen, device="cuda")
    names = ("x", "scale", "bias", "w1", "b1", "w2", "b2")

    def op_pass(block, dtype, impl):
        """(out, the seven gradients) of one forward and backward pass of
        fused_mlp(layer_norm(x)) with the block's bridged parameters."""
        params = (*layer_norm_params(block.norm2), *mlp_params(block.mlp))
        leaves = [tokens.to(dtype).clone().requires_grad_()] + [
            p.detach().clone().requires_grad_() for p in params]
        x, scale, bias, *mlp = leaves
        out = fused_mlp(layer_norm(x, scale, bias, tmod.LN_EPS, impl), *mlp,
                        impl=impl)
        out.backward(cot.to(dtype))
        return out.detach(), [t.grad for t in leaves]

    def module_pass(block, dtype):
        """The same through the modules the model runs, by autograd; the
        Linears' [out, in] weight gradients transposed to the op's
        layout."""
        x = tokens.to(dtype).clone().requires_grad_()
        block.zero_grad(set_to_none=True)
        out = block.mlp(tmod.layer_norm(x, block.norm2, dtype), dtype)
        out.backward(cot.to(dtype))
        fc1, fc2 = (getattr(block.mlp, n) for n in block.mlp.names)
        grads = [x.grad, block.norm2.weight.grad, block.norm2.bias.grad,
                 fc1.weight.grad.t(), fc1.bias.grad, fc2.weight.grad.t(),
                 fc2.bias.grad]
        return out.detach(), [g.clone() for g in grads]

    # the main path: bf16, both blocks, one forward and one backward each
    bf16, f32 = torch.bfloat16, torch.float32
    zero_launch_counts()
    main = {tag: op_pass(blk, bf16, "auto") for tag, blk in blocks.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    ours = {k: counts[k] for k in ("layer_norm_fwd", "layer_norm_bwd",
                                   "mlp_block_fwd", "mlp_block_bwd")}
    log(f"[rowops] fused_mlp(layer_norm(x)) forward and backward, tokens "
        f"[8, 1025, {D}] bf16 x hidden {H}, the full-width lifter's seeded "
        f"weights, {len(blocks)} blocks, impl=auto: launches {counts} (want "
        f"{len(blocks)} of each of the four, one per pass, and no other)")
    if any(v != len(blocks) for v in ours.values()) or any(
            v for k, v in counts.items() if k not in ours):
        raise SystemExit("the row-op path did not launch each of its four "
                         "kernels once per pass")

    for tag, blk in blocks.items():
        for dtype in (bf16, f32):
            name = str(dtype).removeprefix("torch.")
            out, grads = main[tag] if dtype == bf16 else \
                op_pass(blk, dtype, "auto")
            before = launch_counts()
            r_out, r_grads = op_pass(blk, dtype, "reference")
            m_out, m_grads = module_pass(blk, dtype)
            if launch_counts() != before:
                raise SystemExit("impl='reference' or the module path "
                                 "launched a kernel")
            ok = out.dtype == dtype and out.shape == tokens.shape
            vs_plain, vs_module = [], []
            for n, a, r, m in zip(("out", *names), (out, *grads),
                                  (r_out, *r_grads), (m_out, *m_grads)):
                ok &= (a.shape == r.shape == m.shape and a.dtype == r.dtype
                       and torch.isfinite(a).all().item())
                rel = _rel_err(a, r)[1]
                ok &= rel <= TOL_MLP[name]
                vs_plain.append(f"{n} {rel:.1e}")
                if dtype == f32:
                    rel = _rel_err(a, m)[1]
                    ok &= rel <= TOL_ROWOPS_MODULE_F32
                else:
                    rel = ((a.double() - m.double()).norm()
                           / m.double().norm()).item()
                    ok &= rel <= TOL_ROWOPS_MODULE_BF16_REL_L2
                vs_module.append(f"{n} {rel:.1e}")
            mod_tol = (f"max|d|/max(1,|ref|), tol {TOL_ROWOPS_MODULE_F32:.0e}"
                       if dtype == f32 else
                       f"rel L2, tol {TOL_ROWOPS_MODULE_BF16_REL_L2:.0e}")
            log(f"[rowops] {tag} {name}: kernels vs the plain pair "
                f"(max|d|/max(1,|ref|), tol {TOL_MLP[name]:.0e}): "
                + ", ".join(vs_plain) + f"; vs the module path ({mod_tol}): "
                + ", ".join(vs_module) + f"  {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"the row-op path disagrees ({tag}, {name})")

    # one forward and backward pass of the composed op, each way
    blk = blocks["vit block 0 (fc1/fc2)"]
    ts = {}
    for what, fn in (("module", lambda: module_pass(blk, bf16)),
                     ("kernels", lambda: op_pass(blk, bf16, "auto")),
                     ("plain pair", lambda: op_pass(blk, bf16, "reference"))):
        ts[what] = _time_ms(torch, fn, 5, warmup=2)
    log(f"[time] fused_mlp(layer_norm(x)) forward + backward, [8, 1025, {D}]"
        f" bf16 x {H}, fp32 parameters (bridge, casts and cotangent copy "
        f"included): kernels {ts['kernels']:.3f} ms, plain pair "
        f"{ts['plain pair']:.3f} ms, the modules the model runs (cuBLAS "
        f"Linears, F.layer_norm, F.gelu, autograd) {ts['module']:.3f} ms  "
        f"[{card}]")
    del model, main
    torch.cuda.empty_cache()
    return ours


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

    hw, J = tuple(cfg.image_size), cfg.num_joints
    zero_launch_counts()
    with _serving(pth) as base:
        reqs = [_request_inputs(100 + i, b, hw, J)
                for i, b in enumerate(REQUEST_BATCHES)]
        with ThreadPoolExecutor(len(reqs)) as ex:
            answers = list(ex.map(lambda a: _post(base + "/predict", a), reqs))
        counts = launch_counts()
        launches = counts["flash_attention_fwd"]
        if any(v for k, v in counts.items() if k != "flash_attention_fwd"):
            raise SystemExit("serving the transformer launched a kernel "
                             f"that is not on its path: {counts}")
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
        flash_attention_bwd_reference,
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
    zero_launch_counts()
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
    launches = launch_counts()
    others = {k: launches.pop(k) for k in list(launches)
              if not k.startswith("flash_attention")}
    if any(others.values()):
        raise SystemExit("training the transformer launched a kernel that "
                         f"is not on its path: {others}")
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
    split = _kernel_split(_profile_once(torch, lambda: step(st, sb, gen)))
    log(f"[time] train step, {A}x{B} {ACCUM_MODE}, torch.profiler over one "
        f"step: {_split_text(split)}  [{card}]")
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


def _dev_total(e) -> float:
    """Device microseconds of a profiler row, its children's included."""
    return getattr(e, "device_time_total", None) \
        or getattr(e, "cuda_time_total", 0.0)


def _dev_own(e) -> float:
    return getattr(e, "self_device_time_total", None) \
        or getattr(e, "self_cuda_time_total", 0.0)


def _is_kernel(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _profile_once(torch, fn):
    """``torch.profiler``'s averaged rows of one synchronised call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def _device_busy_ms(rows) -> float:
    """ms the card spent in kernels and copies: what a host that launches
    late cannot stretch, unlike the time between two events."""
    return sum(_dev_own(e) for e in rows if _is_kernel(e)) / 1e3


def _kernel_split(rows) -> dict:
    """Device ms of profiled rows by kernel name: the attention forward
    kernels, the attention backward's (the rows or delta prologue, the main
    kernel, the dq cast), matrix products (cuBLAS / CUTLASS), the rest."""
    out = {"attention forward": 0.0, "attention backward": 0.0,
           "matmul": 0.0, "other": 0.0}
    for e in rows:
        if not _is_kernel(e):
            continue
        name, ms = e.key, _dev_own(e) / 1e3
        if "attn_fwd" in name:
            out["attention forward"] += ms
        elif any(w in name for w in ("attn_bwd", "bwd_rows", "bwd_prologue",
                                     "cast_to_bf16")):
            out["attention backward"] += ms
        elif any(w in name.lower() for w in ("gemm", "xmma", "nvjet",
                                             "cutlass")):
            out["matmul"] += ms
        else:
            out["other"] += ms
    return out


def _split_text(split: dict) -> str:
    total = sum(split.values())
    return f"{total:.1f} ms of device kernels: " + ", ".join(
        f"{k} {v:.1f} ({v / total:.0%})" for k, v in split.items())


def _profile_split(prof) -> dict:
    """Device ms of one profiled step by what launched the kernels:
    convolutions (``conv2d`` and its backward), BatchNorm statistics and
    normalise (the port's BatchNorm Function, forward and backward), the
    AdamW step, and everything else (activations, attention gates, casts,
    residual adds, loss, EMA)."""
    rows = prof.key_averages()
    total, own = _dev_total, _dev_own

    kernels = sum(own(e) for e in rows if _is_kernel(e))
    by = {"conv": 0.0, "batchnorm": 0.0, "optimizer": 0.0}
    for e in rows:
        if e.key in ("aten::conv2d", "aten::convolution_backward"):
            by["conv"] += total(e)
        elif e.key in ("_BatchNormTrain", "_BatchNormTrainBackward"):
            by["batchnorm"] += total(e)
        elif e.key.startswith("Optimizer.step"):
            by["optimizer"] += total(e)
    out = {k: v / 1e3 for k, v in by.items()}
    out["device"] = kernels / 1e3
    out["other"] = out["device"] - sum(by.values()) / 1e3
    return out


def phase_cnn(torch, tmp: Path, card: str) -> dict:
    import gc

    from torch.profiler import ProfilerActivity, profile

    from pose3d_tpu_torch.core.config import GlobalConfig
    from pose3d_tpu_torch.models import build_model
    from pose3d_tpu_torch.models.cnn import BatchNorm, DotStatsBatchNorm
    from pose3d_tpu_torch.ops.kernels.bn_stats import bn_stats
    from pose3d_tpu_torch.ops.losses import LossWeights
    from pose3d_tpu_torch.train import loop, state as tstate, step as tstep

    g = GlobalConfig()
    A, B = g.gradient_accumulation_steps, g.batch_size
    weights = LossWeights(g.mse_loss_weight, g.l1_loss_weight,
                          g.inter_joint_loss_weight, g.abs_root_loss_weight)
    compute = getattr(torch, g.compute_dtype)
    cfg_k = _cnn_config(normalization="batch_pallas")
    cfg_b = _cnn_config()
    hw, J = tuple(cfg_k.image_size), cfg_k.num_joints
    n_bn = len(_bn_path_shapes(torch, B))
    out = {}

    def seeded(cfg, **kw):
        return build_model(cfg, device="cuda", train=True,
                           generator=torch.Generator("cuda").manual_seed(0),
                           **kw)

    # (b) one batch-10 fp32 step, dropout off: kernel vs plain statistics
    cfg0 = dataclasses.replace(cfg_k, regression_dropout=0.0)
    sb = loop.to_device(next(loop._superbatches(
        _train_batches(21, 1, B, hw, J), 1)), "cuda")
    runs = {}
    for run, impl in (("reference", "reference"), ("again", "reference"),
                      ("auto", "auto")):
        model = seeded(cfg0, dtype=torch.float32, stats_impl=impl)
        kinds = [type(m) for m in model.modules()
                 if isinstance(m, (BatchNorm, DotStatsBatchNorm))]
        if kinds.count(DotStatsBatchNorm) != n_bn:
            raise SystemExit(f"{kinds.count(DotStatsBatchNorm)} kernel "
                             f"BatchNorms in the model, {n_bn} on its path")
        st = tstate.create_train_state(model)
        # every BatchNorm's input must be a dense NHWC tensor as the conv
        # handed it back: the [n, C] view is then free. (The modules' own
        # view() raises otherwise, in the bf16 runs below too.)
        layouts = []
        for mod in model.modules():
            if isinstance(mod, (BatchNorm, DotStatsBatchNorm)):
                mod.register_forward_pre_hook(
                    lambda _m, a: layouts.append(a[0].is_contiguous()))
        before = bn_stats.launches
        m = tstep.make_train_step(weights, accum_mode="scan")(st, sb)
        if len(layouts) != len(kinds) or not all(layouts):
            raise SystemExit(
                f"{layouts.count(False)} of {len(layouts)} BatchNorm inputs "
                f"({len(kinds)} modules) were not dense NHWC")
        runs[run] = (
            m["total_loss"].item(),
            torch.cat([p.grad.flatten() for p in st.trainable()]).double(),
            torch.cat([b.flatten() for b in
                       tstate.batch_stats(model).values()]).double(),
            bn_stats.launches - before)
        del model, st
    (l_ref, g_ref, s_ref, n_ref), (l_k, g_k, s_k, n_k) = \
        runs["reference"], runs["auto"]
    dl = abs(l_k - l_ref) / abs(l_ref)
    dg = ((g_k - g_ref).norm() / g_ref.norm()).item()
    floor = ((runs["again"][1] - g_ref).norm() / g_ref.norm()).item()
    ds = ((s_k - s_ref).abs().max()
          / s_ref.abs().max().clamp_min(1.0)).item()
    ok = (np.isfinite(l_k) and torch.isfinite(g_k).all().item()
          and max(dl, ds) <= TOL_CNN_STEP and dg <= TOL_CNN_STEP_GRAD
          and n_k == n_bn and n_ref == 0)
    log(f"[cnn] (b) batch-{B} fp32 step, TF32 off, full width, "
        f"{kinds.count(DotStatsBatchNorm)} kernel BatchNorms + "
        f"{kinds.count(BatchNorm)} plain, each fed a dense NHWC tensor by "
        f"its conv ({len(layouts)} of {len(layouts)} checked, no copy): "
        f"bn_stats kernel vs plain "
        f"statistics: loss {l_k:.6f} vs {l_ref:.6f} (rel {dl:.2e}), whole "
        f"gradient rel L2 {dg:.3e} over {g_k.numel()} values (the plain "
        f"step run twice: {floor:.3e}), running "
        f"mean/var max|d|/max(1,|ref|) {ds:.2e} over {s_k.numel()} values "
        f"(tol {TOL_CNN_STEP:.0e}, gradient {TOL_CNN_STEP_GRAD:.0e}); "
        f"launches {n_k} (want {n_bn}) and "
        f"{n_ref} (want 0)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the CNN step with the bn_stats kernel disagrees "
                         "with the plain statistics")
    del runs, g_ref, g_k, s_ref, s_k, sb
    torch.cuda.empty_cache()

    def train(cfg, mode, seed, steps, augment=None, **kw):
        """``train_model`` for ``steps`` optimizer steps at A x B, then the
        bare step twice on a device-resident superbatch (with ``augment``:
        the un-augmented step before and after, on the same state);
        returns the state and what was measured."""
        model = seeded(cfg, dtype=compute, **kw)
        if any(p.dtype != getattr(torch, g.param_dtype)
               for p in model.parameters()):
            raise SystemExit(f"parameters are not {g.param_dtype}")
        st = tstate.create_train_state(model, g.learning_rate,
                                       g.weight_decay, ema=True)
        if not st.ema_batch_stats:
            raise SystemExit("no ema_batch_stats for a BatchNorm model")
        writer = _Scalars()
        pth = tmp / f"cnn_{mode}.pth"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        t0 = time.perf_counter()
        st, n = loop.train_model(
            st, _train_batches(seed, A * steps, B, hw, J), writer=writer,
            loss_weights=weights, gradient_accumulation_steps=A,
            num_steps=steps, max_epochs=1, log_interval_steps=1,
            eval_interval_steps=10 ** 9, accum_mode=mode, ema_decay=0.999,
            generator=torch.Generator("cuda").manual_seed(g.random_seed),
            checkpoint_path=pth, augment=augment)
        torch.cuda.synchronize()
        r = dict(wall=time.perf_counter() - t0, launches=launch_counts(),
                 peak=torch.cuda.max_memory_allocated() / 2 ** 30, pth=pth,
                 losses=[v for _, v in writer.tags.get("Loss/train_step",
                                                       [])],
                 loop_ms=[v for _, v in writer.tags.get("Perf/step_time_ms",
                                                        [])])
        if (n != steps or len(r["losses"]) != steps
                or not np.isfinite(r["losses"]).all()):
            raise SystemExit(f"train_model ({mode}) did not take {steps} "
                             "steps with finite losses")
        live = tstate.batch_stats(model)
        moved = max((st.ema_batch_stats[k] - v).abs().max().item()
                    for k, v in live.items())
        if not (moved > 0 and all(torch.isfinite(v).all().item()
                                  for v in st.ema_batch_stats.values())):
            raise SystemExit("ema_batch_stats did not follow the running "
                             "statistics")
        sb = loop.to_device(next(loop._superbatches(
            _train_batches(seed + 1, A, B, hw, J), A)), "cuda")
        step = tstep.make_train_step(weights, accum_mode=mode,
                                     ema_decay=0.999, augment=augment)
        gen = torch.Generator("cuda").manual_seed(g.random_seed + 1)
        aug_gen = None if augment is None else \
            torch.Generator("cuda").manual_seed(g.random_seed + 2)

        def timed(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(st, sb, gen, aug_gen)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3

        if augment is not None:     # plain, augmented, augmented, plain
            bare = tstep.make_train_step(weights, accum_mode=mode,
                                         ema_decay=0.999)
            plain = [timed(bare)]
        ts = [timed(step) for _ in range(2)]
        if augment is not None:
            plain.append(timed(bare))
            # what the card itself ran, apart from the host's launch gaps
            r.update(plain_ms=statistics.mean(plain), plain_runs=plain,
                     busy=_device_busy_ms(_profile_once(
                         torch, lambda: step(st, sb, gen, aug_gen))),
                     plain_busy=_device_busy_ms(_profile_once(
                         torch, lambda: bare(st, sb, gen, aug_gen))))
        r.update(step_ms=statistics.mean(ts), runs=ts, st=st, sb=sb,
                 step=step, gen=gen)
        return r

    def report(tag, what, r, steps):
        log(f"[cnn] {tag} train_model, {what}, {A}x{B}, dropout "
            f"{cfg_k.regression_dropout}, EMA with ema_batch_stats: {steps} "
            f"steps in {r['wall']:.1f} s, losses {r['losses']}; launches "
            f"{r['launches']}; peak memory {r['peak']:.2f} GiB")
        log(f"[time] CNN train step, {A}x{B} {what}: {r['step_ms']:.1f} ms "
            f"(runs {'/'.join(f'{t:.1f}' for t in r['runs'])}) = "
            f"{A * B / r['step_ms'] * 1e3:.1f} images/s on a device-"
            f"resident superbatch; train_model's own step times "
            f"{[round(t, 1) for t in r['loop_ms']]} ms (host batches, H2D "
            f"included); peak memory {r['peak']:.2f} GiB  [{card}]")

    # (a) the kernel path: batch_pallas, scan
    ra = train(cfg_k, "scan", 31, CNN_STEPS)
    report("(a)", "batch_pallas scan", ra, CNN_STEPS)
    want = {**dict.fromkeys(KERNELS, 0), "bn_stats": n_bn * A * CNN_STEPS}
    log(f"[cnn] (a) bn_stats launches {ra['launches']['bn_stats']} = {n_bn} "
        f"BatchNorms x {A} microbatches x {CNN_STEPS} steps? "
        f"{ra['launches'] == want}")
    if ra["launches"] != want:
        raise SystemExit("the scan path did not launch bn_stats once per "
                         "BatchNorm per microbatch")
    out.update(launches=ra["launches"]["bn_stats"], scan_ms=ra["step_ms"],
               scan_peak=ra["peak"])

    # (d) evaluate (a full and a ragged batch), then (a)'s .pth, served
    st = ra["st"]
    ev = loop.evaluate(
        tstep.make_eval_step(weights), st,
        [next(_train_batches(41, 1, B, hw, J)),
         next(_train_batches(42, 1, 7, hw, J))])
    log(f"[cnn] (d) evaluate over {B}+7 samples: MPJPE {ev['mpjpe']:.4f}, "
        f"PA-MPJPE {ev['pa_mpjpe']:.4f}, loss {ev['total_loss']:.4f}")
    if not all(np.isfinite([ev["mpjpe"], ev["pa_mpjpe"]])):
        raise SystemExit("evaluate gave non-finite metrics")
    load_sd = torch.load(ra["pth"], map_location="cuda", weights_only=True)
    eval_model = build_model(cfg_k, device="cuda", dtype=compute)
    eval_model.load_state_dict(load_sd["model_state_dict"])
    req = _request_inputs(43, 2, hw, J)
    with torch.inference_mode():
        direct = eval_model(*[torch.from_numpy(x).cuda() for x in req]).cpu()
    del ra, st, eval_model, load_sd
    gc.collect()
    torch.cuda.empty_cache()
    zero_launch_counts()
    with _serving(tmp / "cnn_scan.pth") as base:
        got = _post(base + "/predict", req)
        _, meta = _get(base + "/meta")
    rel = float(np.linalg.norm(got - direct.numpy())
                / np.linalg.norm(direct.numpy()))
    log(f"[cnn] (d) cnn_scan.pth served ({meta['artifact']['model_type']}): "
        f"/predict {got.shape}, vs a direct eval-mode forward of the saved "
        f"weights rel L2 {rel:.3e} (tol {TOL_SLICE_REL_L2:.0e}); kernel "
        f"launches while serving {launch_counts()} (eval-mode BatchNorm "
        "reads its running statistics)")
    if (got.shape != (2, J, 3) or not rel <= TOL_SLICE_REL_L2
            or any(launch_counts().values())
            or meta["artifact"]["model_type"] != "cnn"):
        raise SystemExit("the trained CNN checkpoint does not serve its "
                         "weights")

    # (c) the default path: normalization="batch", grouped, no kernel
    def profiled(r):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r["step"](r["st"], r["sb"], r["gen"])
            torch.cuda.synchronize()
        return _profile_split(prof)

    def grouped(steps, remat):
        r = train(cfg_b, "grouped", 51, steps, remat=remat)
        if any(r["launches"].values()):
            raise SystemExit(f"the grouped path launched a kernel: "
                             f"{r['launches']}")
        return r

    peaks = {}
    try:
        rc = grouped(CNN_STEPS, False)
    except torch.cuda.OutOfMemoryError as e:
        rc = None
        peaks[False] = ("does not fit: out of memory at "
                        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
                        f"GiB allocated ({str(e)[:80]})")
    if rc is not None:
        leg = "batch grouped, no remat"
        peaks[False] = f"{rc['peak']:.2f} GiB"
        report("(c)", leg, rc, CNN_STEPS)
        out.update(grouped_ms=rc["step_ms"], grouped_peak=rc["peak"],
                   split=profiled(rc))
    del rc
    gc.collect()
    torch.cuda.empty_cache()
    # with remat: the leg itself when the flat batch did not fit, else one
    # step for its peak and time
    rr = grouped(CNN_STEPS if "split" not in out else 1, True)
    peaks[True] = f"{rr['peak']:.2f} GiB"
    if "split" not in out:
        leg = "batch grouped, remat=True (the flat batch of 100 does not " \
              "fit without it)"
        report("(c)", leg, rr, CNN_STEPS)
        out.update(grouped_ms=rr["step_ms"], grouped_peak=rr["peak"],
                   split=profiled(rr))
    else:
        log(f"[time] CNN train step, {A}x{B} batch grouped, remat=True: "
            f"{rr['step_ms']:.1f} ms (runs "
            f"{'/'.join(f'{t:.1f}' for t in rr['runs'])}) = "
            f"{A * B / rr['step_ms'] * 1e3:.1f} images/s  [{card}]")
    del rr
    gc.collect()
    torch.cuda.empty_cache()
    sp = out["split"]
    log(f"[cnn] (c) peak memory of the grouped {A}x{B} step: without remat "
        f"{peaks[False]}; with remat {peaks[True]}")
    if sp["device"] > 0:
        log(f"[time] CNN grouped step ({leg}), torch.profiler, one step: "
            f"device kernels {sp['device']:.1f} ms: convolutions "
            f"{sp['conv']:.1f}, BatchNorm statistics and normalise "
            f"{sp['batchnorm']:.1f}, AdamW {sp['optimizer']:.1f}, other "
            f"elementwise and reductions {sp['other']:.1f}  [{card}]")
    else:
        log("[time] CNN grouped step: the profiler recorded no device time")
    out["grouped_leg"] = leg
    out["augment"] = _cnn_augmented(torch, train, cfg_b, out, A, B, card,
                                    weights, (hw, J))
    return out


def _cnn_augmented(torch, train, cfg, base: dict, A: int, B: int, card: str,
                   weights, shape) -> dict:
    """(e) the full-width CNN trained through ``train_model(augment=...)``:
    grouped with rotation on (the two-pass warp on the kernel), grouped
    with rotation off (the separable warp), scan with rotation on. Counts
    the ``lane_resample`` launches of each leg (two passes each for image
    and depth: 4 per augmentation), times the augmented step beside the
    un-augmented one on the same state, and evaluates after."""
    import gc

    from pose3d_tpu_torch.ops.augment_device import (
        DeviceAugmentConfig,
        make_device_augment,
    )
    from pose3d_tpu_torch.train import loop, step as tstep

    hw, J = shape
    # remat as the un-augmented grouped leg of this run ran
    remat = {} if "no remat" in base["grouped_leg"] else {"remat": True}
    legs = [
        ("grouped, rotation on (two-pass warp, kernel)", "grouped", True,
         AUG_STEPS, 4 * AUG_STEPS, remat),
        ("grouped, rotation off (separable warp)", "grouped", False,
         AUG_STEPS, 0, remat),
        ("scan, rotation on (two-pass warp, kernel)", "scan", True,
         AUG_SCAN_STEPS, 4 * A * AUG_SCAN_STEPS, {}),
    ]
    res = {}
    for i, (what, mode, rotation, steps, want, kw) in enumerate(legs):
        aug = make_device_augment(DeviceAugmentConfig(
            enable_rotation=rotation))
        r = train(cfg, mode, 61 + 2 * i, steps, augment=aug, **kw)
        got = r["launches"]
        log(f"[cnn] (e) train_model(augment=...), {what}, {A}x{B}: {steps} "
            f"steps in {r['wall']:.1f} s, losses {r['losses']}; launches "
            f"{got} (want lane_resample {want} = 4 x "
            f"{want // 4} augmentations, no other); peak memory "
            f"{r['peak']:.2f} GiB")
        if got["lane_resample"] != want or any(
                v for k, v in got.items() if k != "lane_resample"):
            raise SystemExit(f"augmented training ({what}) did not launch "
                             f"lane_resample {want} times and nothing else")
        ev = loop.evaluate(
            tstep.make_eval_step(weights), r["st"],
            [next(_train_batches(71 + i, 1, B, hw, J)),
             next(_train_batches(81 + i, 1, 7, hw, J))])
        if not all(np.isfinite([ev["mpjpe"], ev["pa_mpjpe"]])):
            raise SystemExit("evaluate after augmented training gave "
                             "non-finite metrics")
        un = ("" if mode != "grouped" else
              f"; this run's un-augmented grouped leg: "
              f"{base['grouped_ms']:.1f} ms, {base['grouped_peak']:.2f} GiB")
        log(f"[time] CNN train step with device augmentation, {A}x{B} "
            f"{what}: {r['step_ms']:.1f} ms (runs "
            f"{'/'.join(f'{t:.1f}' for t in r['runs'])}) = "
            f"{A * B / r['step_ms'] * 1e3:.1f} images/s against "
            f"{r['plain_ms']:.1f} ms (runs "
            f"{'/'.join(f'{t:.1f}' for t in r['plain_runs'])}) for the "
            f"un-augmented step on the same state and superbatch, before "
            f"and after (host clock around a synchronised step); "
            f"torch.profiler, one step each: {r['busy']:.1f} ms of device "
            f"kernels augmented, {r['plain_busy']:.1f} un-augmented (+"
            f"{r['busy'] - r['plain_busy']:.1f}); peak memory {r['peak']:.2f} GiB{un}; evaluate "
            f"after: MPJPE {ev['mpjpe']:.4f}  [{card}]")
        res[what] = dict(launches=got["lane_resample"], step_ms=r["step_ms"],
                         plain_ms=r["plain_ms"], peak=r["peak"],
                         busy=r["busy"], plain_busy=r["plain_busy"])
        del r, aug
        gc.collect()
        torch.cuda.empty_cache()
    return res


def _time_ms(torch, fn, iters: int, warmup: int = 3,
             queue_behind: bool = False) -> float:
    """Device ms per call over ``iters`` calls between two CUDA events.
    ``queue_behind`` first occupies the stream for some milliseconds, so
    that the host has enqueued every call before the first one starts: for
    kernels shorter than their launch takes on the host."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queue_behind:
        torch.cuda._sleep(30_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _attention_bound(B, Tq, Tk, H, D, itemsize, backward: bool):
    """(ms, "bytes" or "operations"): the least time the card could take
    for one attention forward (two products; q, k, v read, o and lse
    written) or backward (five products; q, k, v, o, dO and lse read, dq,
    dk, dv written) in bf16 on the tensor cores."""
    flop = 4 * B * H * Tq * Tk * D * (2.5 if backward else 1.0)
    eq, ek = B * Tq * H * D, B * Tk * H * D
    nbytes = ((4 * eq + 4 * ek) if backward else (2 * eq + 2 * ek)) \
        * itemsize + B * H * Tq * 4
    t_ops, t_bytes = flop / PEAK_BF16 * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _sdpa_backend(torch, fn) -> str:
    """Which backend ``scaled_dot_product_attention`` dispatched to, read
    off the operator names of one profiled call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    keys = {e.key for e in prof.key_averages()}
    for tag in ("flash", "cudnn", "efficient", "math"):
        if any("scaled_dot_product" in k and tag in k for k in keys):
            return tag
    return "unknown"


def _interleaved(torch, plain, kern, iters: int, **kw):
    """(kernel ms, plain ms): plain, kernel, kernel, plain."""
    p1 = _time_ms(torch, plain, iters, **kw)
    k1 = _time_ms(torch, kern, iters, **kw)
    k2 = _time_ms(torch, kern, iters, **kw)
    p2 = _time_ms(torch, plain, iters, **kw)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _time_bn_stats(torch, card: str) -> dict:
    """bn_stats at every shape of the CNN's path (microbatch 10, bf16):
    kernel, plain version, ``torch.batch_norm_stats`` (the nearest library
    call; not the same function: it returns mean and 1/σ) and the bound
    n·C·itemsize over the memory rate. Each call reads a buffer the 50 MB
    L2 no longer holds (the inputs rotate through 256 MB of copies), and
    the calls are queued behind a busy stream, so the times are the
    device's and not the host's launch rate."""
    from pose3d_tpu_torch.ops.kernels.bn_stats import (
        bn_stats,
        bn_stats_reference,
    )

    times = {}
    shapes = _bn_path_shapes(torch, 10)
    for n, C in sorted(set(shapes), reverse=True):
        g = torch.Generator(device="cuda").manual_seed(n + C)
        x = torch.randn(n, C, generator=g, device="cuda").bfloat16()
        copies = max(1, min(64, -(-(256 << 20) // (n * C * 2))))
        xs = [x.clone() for _ in range(copies)]
        turn = [0]

        def nxt():
            turn[0] = (turn[0] + 1) % copies
            return xs[turn[0]]
        kt, pt = _interleaved(torch, lambda: bn_stats_reference(nxt()),
                              lambda: bn_stats(nxt()), 20, queue_behind=True)
        lt = _time_ms(torch, lambda: torch.batch_norm_stats(nxt(), 1e-5), 20,
                      queue_behind=True)
        nbytes = n * C * 2 + 2 * C * 4
        bound = max(nbytes / HBM_BYTES_S, 3 * n * C / PEAK_FP32) * 1e3
        times[("bn", n, C)] = dict(
            ms=kt, plain_ms=pt, library_ms=lt, bound_ms=bound,
            bound_by="bytes" if nbytes / HBM_BYTES_S >= 3 * n * C / PEAK_FP32
            else "operations")
        log(f"[time] bn_stats bf16 n={n} C={C} (x{shapes.count((n, C))} per "
            f"forward): kernel {kt:.4f} ms ({nbytes / kt / 1e6:.0f} GB/s), "
            f"plain {pt:.4f} ms, torch.batch_norm_stats (mean and 1/sigma, "
            f"not the same function) {lt:.4f} ms, bound {bound:.4f} ms "
            f"(bytes)  [{card}]")
        del xs, x
    return times


def _path_lane_calls(torch, b: int, h: int, w: int, seed: int) -> list:
    """(x, a, o, order) of the four ``lane_resample`` calls that one
    augmentation of a [b, h, w] batch makes with ``DeviceAugmentConfig()``'s
    seeded draws (rotation, flip, scale, translation): image pass 1 and 2,
    depth pass 1 and 2, recorded where ``_twopass_warp`` hands them to the
    kernel's dispatch."""
    from pose3d_tpu_torch.ops import augment_device

    calls = []
    dispatch = augment_device.resample_rows

    def record(x, a, o, order, impl="auto"):
        calls.append((x, a, o, order))
        return dispatch(x, a, o, order, impl)

    cfg = augment_device.DeviceAugmentConfig()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = _smooth_batch(torch, b, h, w, seed)
    with mock.patch.object(augment_device, "resample_rows", record), \
            torch.no_grad():
        augment_device.apply_params(
            cfg, batch, augment_device.draw_params(cfg, b, gen))
    if [c[3] for c in calls] != [1, 1, 0, 0]:
        raise SystemExit(f"one augmentation made the calls "
                         f"{[(tuple(c[0].shape), c[3]) for c in calls]}")
    return calls


def _lane_resample_bytes(torch, a, o, w: int, order: int) -> int:
    """Bytes one call must move for these lines: every output written once,
    a and o read once, and of each row only the source pixels between its
    first and last position that lie inside the row (both taps in order
    1), read once. A row read at |a| < 1 needs part of its source, a row
    whose positions leave the row needs none beyond the edge."""
    p0, p1 = o.double(), a.double() * (w - 1) + o.double()
    lo, hi = torch.minimum(p0, p1), torch.maximum(p0, p1)
    if order == 1:
        first, last = torch.floor(lo), torch.floor(hi) + 1
    else:
        first, last = torch.floor(lo + 0.5), torch.floor(hi + 0.5)
    touched = (last.clamp(max=w - 1) - first.clamp(min=0) + 1).clamp(min=0)
    n = a.numel()
    return int(4 * (touched.sum().item() + n * w) + 8 * n)


def _time_lane_resample(torch, card: str) -> dict:
    """lane_resample on the lines the path gives it: the four calls of one
    augmentation (``DeviceAugmentConfig()``'s seeded draws) of the CNN's
    grouped flat batch [100, 500, 500], of its scan microbatch [10, 500,
    500] and of the transformer's grouped flat batch [100, 512, 512]:
    kernel, plain version, and for order 1 ``grid_sample`` on a
    [N, 1, 1, W] view (bilinear, zero padding, align_corners, cuDNN off:
    the same function up to its own rounding; it reads a ready-made
    [N, 1, W, 2] grid besides; its nearest mode rounds ties another way,
    so order 0 has no library call), beside the bound: the bytes these
    lines need (:func:`_lane_resample_bytes`) over the memory rate. Inputs
    rotate through 256 MB of copies where one is smaller than the L2, and
    the calls are queued behind a busy stream."""
    times = {}
    for i, (b, h, w) in enumerate([(100, 500, 500), (10, 500, 500),
                                   (100, 512, 512)]):
        calls = _path_lane_calls(torch, b, h, w, 4000 + i)
        for k, (x, a, o, order) in enumerate(calls):
            times.update(_time_lane_call(torch, x, a, o, order, 1 + k % 2,
                                         card))
        del calls, x, a, o
        torch.cuda.empty_cache()
    return times


def _time_lane_call(torch, x, a, o, order: int, which: int,
                    card: str) -> dict:
    """One recorded call (pass ``which`` of the warp): see
    :func:`_time_lane_resample`."""
    import torch.nn.functional as F

    from pose3d_tpu_torch.ops.kernels.lane_resample import (
        lane_resample,
        lane_resample_reference,
    )

    n, w = x.shape
    copies = max(1, min(64, -(-(256 << 20) // (n * w * 4))))
    xs = [x.clone() for _ in range(copies)]
    turn = [0]

    def nxt():
        turn[0] = (turn[0] + 1) % copies
        return xs[turn[0]]
    kt, pt = _interleaved(
        torch, lambda: lane_resample_reference(nxt(), a, o, order),
        lambda: lane_resample(nxt(), a, o, order), 20, queue_behind=True)
    lt, lib = None, "no library call of the same function"
    if order == 1:
        j = torch.arange(w, dtype=torch.float32, device="cuda")
        p = a[:, None] * j[None, :] + o[:, None]
        grid = torch.stack([2.0 * p / (w - 1) - 1.0,
                            torch.zeros_like(p)], -1)[:, None]
        del p
        call = lambda: F.grid_sample(  # noqa: E731
            nxt().view(n, 1, 1, w), grid, mode="bilinear",
            padding_mode="zeros", align_corners=True)
        # cuDNN's sampler refuses a batch of this many rows
        with torch.backends.cudnn.flags(enabled=False):
            dl = (call().view(n, w)
                  - lane_resample(x, a, o, 1)).abs().max()
            lt = _time_ms(torch, call, 20, queue_behind=True)
        lib = (f"grid_sample (PyTorch's own kernel) {lt:.4f} ms (max "
               f"|Δ| to the kernel "
               f"{dl.item():.1e}: its own position arithmetic)")
        del grid
    nbytes = _lane_resample_bytes(torch, a, o, w, order)
    flop = (16 if order == 1 else 7) * n * w
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flop / PEAK_FP32 * 1e3
    bound = max(t_bytes, t_ops)
    log(f"[time] lane_resample order {order} N={n} W={w}, pass {which} of "
        f"the two-pass warp (|a| {a.abs().min().item():.2f} to "
        f"{a.abs().max().item():.2f}; {nbytes / 1e6:.0f} MB needed of "
        f"{(2 * n * w * 4 + 8 * n) / 1e6:.0f} if every row were read "
        f"whole): kernel {kt:.4f} ms ({nbytes / kt / 1e6:.0f} GB/s, "
        f"{bound / kt:.0%} of the bound), plain {pt:.4f} ms, {lib}, bound "
        f"{bound:.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})  [{card}]")
    return {("lr", n, w, order, which): dict(
        ms=kt, plain_ms=pt, library_ms=lt, bound_ms=bound,
        bound_by="bytes" if t_bytes >= t_ops else "operations")}


def _smooth_batch(torch, b: int, h: int, w: int, seed: int) -> dict:
    """A decompacted batch on the card: smooth low-frequency images with a
    little seeded noise and a planar depth (the images the JAX package's
    augmentation tests use), random keypoints and joints."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    yy = torch.arange(h, device="cuda", dtype=torch.float32)[None, :, None,
                                                              None] / h
    xx = torch.arange(w, device="cuda", dtype=torch.float32)[None, None, :,
                                                              None] / w
    k = torch.arange(3, device="cuda", dtype=torch.float32)
    s = torch.arange(b, device="cuda", dtype=torch.float32)[:, None, None,
                                                             None]
    img = 0.5 + 0.4 * torch.sin(2 * np.pi * (xx + 0.3 * k + 0.37 * s)) \
        * torch.cos(2 * np.pi * (yy - 0.2 * k))
    img = img + 0.01 * torch.randn(img.shape, generator=g, device="cuda")
    return {
        "image": img.clamp(0, 1),
        "depth": 2.0 + 3.0 * xx + 1.5 * yy + 0.1 * s,
        "keypoints_2d": torch.rand(b, 17, 2, generator=g, device="cuda")
        * 0.7 + 0.15,
        "joints_3d": torch.randn(b, 17, 3, generator=g, device="cuda") * 120,
    }


def phase_augment(torch, card: str) -> None:
    """The device augmentor on the card at 500 x 500 (phase 8 of the module
    docstring)."""
    from pose3d_tpu_torch.ops.augment_device import (
        DeviceAugmentConfig,
        apply_params,
        draw_params,
        make_device_augment,
    )
    from pose3d_tpu_torch.ops.kernels.lane_resample import lane_resample

    H = W = 500
    batch = _smooth_batch(torch, 4, H, W, 5)
    gen = torch.Generator(device="cuda").manual_seed(6)

    def diff(a, b, k):
        return (a[k].float() - b[k].float()).abs()

    # the two-pass warp: kernel against plain version, and against the
    # exact single-pass oracle, for random draws and for the fixed
    # transform of the JAX package's own test
    fixed = DeviceAugmentConfig(
        enable_color=False, rotation_range=(-28.0, -28.0),
        scale_range=(1.1, 1.1), translate_range=(0.04, 0.04), flip_prob=1.0)
    for name, cfg in (("default ranges", DeviceAugmentConfig()),
                      ("flip, -28 deg, x1.1, +0.04", fixed)):
        params = draw_params(cfg, 4, gen)
        before = lane_resample.launches
        kern = apply_params(cfg, batch, params)
        launched = lane_resample.launches - before
        plain = apply_params(cfg, batch, params, resample_impl="reference")
        exact = apply_params(dataclasses.replace(cfg, resample="gather"),
                             batch, params)
        torch.cuda.synchronize()
        d_img = diff(kern, plain, "image").max().item()
        d = diff(kern, exact, "image")
        dk = diff(kern, exact, "keypoints_2d").max().item()
        dj = diff(kern, exact, "joints_3d").max().item()
        ok = (launched == 4
              and torch.equal(kern["depth"], plain["depth"])
              and torch.equal(kern["keypoints_2d"], plain["keypoints_2d"])
              and torch.equal(kern["joints_3d"], plain["joints_3d"])
              and d_img <= TOL_AUG_IMPL and dk <= 1e-6 and dj <= 1e-4
              and d.mean().item() < 0.01 and d.max().item() < 0.2
              and all(torch.isfinite(v).all().item() for v in kern.values()))
        log(f"[augment] two-pass warp, 4 x {H}x{W}, {name}: {launched} "
            f"launches (want 4); kernel vs plain version: keypoints, joints "
            f"and depth equal, image max|d| {d_img:.1e} (tol "
            f"{TOL_AUG_IMPL:.0e}); vs the single-pass oracle: keypoints "
            f"{dk:.1e} (1e-6), joints {dj:.1e} (1e-4), image mean|d| "
            f"{d.mean().item():.2e} (< 0.01) max {d.max().item():.3f} "
            f"(< 0.2)  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the two-pass warp on the kernel disagrees")

    # a bright blob painted at a keypoint lands where the transformed
    # keypoint says
    kp = torch.tensor([0.4, 0.6], device="cuda")
    yy = torch.arange(H, device="cuda", dtype=torch.float32)[:, None]
    xx = torch.arange(W, device="cuda", dtype=torch.float32)[None, :]
    blob = torch.exp(-((xx - kp[0] * W) ** 2 + (yy - kp[1] * H) ** 2)
                     / (2 * 3.0 ** 2))
    one = {k: v[:1].clone() for k, v in batch.items()}
    one["keypoints_2d"][0, 0] = kp
    one["image"] = (0.2 * one["image"] + 0.8 * blob[None, ..., None]).clamp(
        0, 1)
    aug = make_device_augment(DeviceAugmentConfig(
        enable_color=False, rotation_range=(-25.0, 25.0),
        scale_range=(0.9, 1.1), translate_range=(-0.05, 0.05)))
    worst, checked = 0.0, 0
    for seed in range(8):
        out = aug(one, torch.Generator(device="cuda").manual_seed(seed))
        kp2 = out["keypoints_2d"][0, 0]
        if not (0.1 < kp2[0] < 0.9 and 0.1 < kp2[1] < 0.9):
            continue
        at = out["image"][0].sum(-1).argmax().item()
        py, px = divmod(at, W)
        worst = max(worst, abs(px - kp2[0].item() * W),
                    abs(py - kp2[1].item() * H))
        checked += 1
    log(f"[augment] blob at a keypoint, {checked} random transforms: "
        f"argmax within {worst:.2f} px of the transformed keypoint "
        f"(tol 2)  {'ok' if checked >= 4 and worst <= 2.0 else 'FAIL'}")
    if checked < 4 or worst > 2.0:
        raise SystemExit("the augmented image does not follow its keypoints")

    # rotation off: the separable warp against the oracle, with TF32
    # switched on around it (the warp pins full fp32 itself)
    sep = DeviceAugmentConfig(enable_rotation=False)
    params = draw_params(sep, 4, gen)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        before = lane_resample.launches
        a = apply_params(sep, batch, params)
        launched = lane_resample.launches - before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    b = apply_params(dataclasses.replace(sep, resample="gather"), batch,
                     params)
    d_img = diff(a, b, "image").max().item()
    ok = (launched == 0 and torch.equal(a["depth"], b["depth"])
          and d_img <= TOL_AUG_SEPARABLE
          and diff(a, b, "keypoints_2d").max().item() <= 1e-6)
    log(f"[augment] separable warp (rotation off, TF32 allowed around it), "
        f"4 x {H}x{W}: {launched} launches (want 0); vs the oracle: depth "
        f"equal {torch.equal(a['depth'], b['depth'])}, image max|d| "
        f"{d_img:.1e} (tol {TOL_AUG_SEPARABLE:.0e})  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the separable warp disagrees with the oracle")
    del batch, a, b, kern, plain, exact, one, out

    # one augmentation of the grouped step's flat batch of 100: between
    # events over 10 calls, and one profiled call split by what ran on the
    # card: the lane_resample launches, the copies (aten::copy_: the
    # two-pass warp's layout changes and its materialised lines) and the
    # rest
    big = _smooth_batch(torch, 100, H, W, 7)
    on = make_device_augment(DeviceAugmentConfig())
    off = make_device_augment(sep)
    with torch.no_grad():
        t_on = _time_ms(torch, lambda: on(big, gen), 10)
        t_off = _time_ms(torch, lambda: off(big, gen), 10)
        rows = _profile_once(torch, lambda: on(big, gen))
        rows_off = _profile_once(torch, lambda: off(big, gen))
    busy = _device_busy_ms(rows)
    lanes = [e for e in rows if _is_kernel(e) and "lane_resample" in e.key]
    t_k = sum(_dev_own(e) for e in lanes) / 1e3
    n_k = sum(e.count for e in lanes)
    t_cp = sum(_dev_total(e) for e in rows if e.key == "aten::copy_") / 1e3
    n_all = sum(e.count for e in rows if _is_kernel(e))
    if busy > 0 and n_k != 4:
        raise SystemExit(f"the profile of one augmentation shows {n_k} "
                         "lane_resample kernels, not 4")
    if busy > 0:
        log(f"[time] one device augmentation of [100, {H}, {W}] (image fp32 "
            f"x3, depth fp32 x1), rotation on: {t_on:.3f} ms between events "
            f"(mean of 10); torch.profiler, one call: {busy:.3f} ms of "
            f"device kernels in {n_all} launches = {n_k} lane_resample "
            f"launches {t_k:.3f} + layout copies (aten::copy_) {t_cp:.3f} + "
            f"the rest (draws, matrices, crop mask, colour, keypoints) "
            f"{busy - t_k - t_cp:.3f}; rotation off (separable, two fp32 "
            f"products each for image and depth): {t_off:.3f} ms between "
            f"events, {_device_busy_ms(rows_off):.3f} of device kernels  "
            f"[{card}]")
    else:
        log(f"[time] one device augmentation of [100, {H}, {W}], rotation "
            f"on: {t_on:.3f} ms between events, rotation off {t_off:.3f}; "
            f"the profiler recorded no device time, so no split  [{card}]")


def _rotating(torch, tensors, nbytes: int):
    """A function that returns, turn by turn, one of enough copies of
    ``tensors`` (a tuple) to exceed 256 MB, so that a call finds its inputs
    in device memory and not in the 50 MB L2."""
    copies = max(1, min(64, -(-(256 << 20) // nbytes)))
    sets = [tuple(t.clone() for t in tensors) for _ in range(copies)]
    turn = [0]

    def nxt():
        turn[0] = (turn[0] + 1) % copies
        return sets[turn[0]]
    return nxt


def _bound(nbytes: float, flop: float, peak: float) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flop / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ptxas_report(name: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} from the
    build log of ``csrc/<name>.cu`` (``-Xptxas -v``) for the kernels named
    ``mlp_*`` and ``attn_*``; a kernel's key is its name, with its template
    arguments as ``<64>`` or ``<32,64>``."""
    import re

    from pose3d_tpu_torch.ops.kernels import _build

    out, entry = {}, None
    for line in _build.build_info[name]["log"].splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"Compiling entry function '\w*?\d+"
                          r"((?:mlp|attn)_[a-z0-9_]*[a-z0-9])(I(?:Li\d+E)+E)?",
                          line)
            entry = None
            if m:
                args = re.findall(r"Li(\d+)E", m.group(2) or "")
                entry = m.group(1) + (f"<{','.join(args)}>" if args else "")
                out[entry] = [None, None, None]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            out[entry][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def _time_row_ops(torch, card: str) -> dict:
    """The four kernels of ``layer_norm`` and ``mlp_block`` in bf16 at the
    lifter's 8·1025 rows (``layer_norm`` also at the 100·1025 rows of a
    grouped 10 x 10 step), C = D 768, H 3072: kernel, plain version, the
    library's calls and the bound. ``layer_norm`` is bound by bytes and its
    inputs rotate through 256 MB of copies; ``mlp_block`` is bound by
    operations and reads the same inputs every time (the weights belong in
    L2). The library's ``F.layer_norm`` takes bf16 scale and bias (it wants
    one dtype); for the MLP no single call computes the function, so the
    yardstick is the three calls ``F.linear → F.gelu → F.linear`` and their
    autograd backward, which write the [rows, H] hidden activation to
    device memory, timed whole and call by call."""
    import torch.nn.functional as F

    from pose3d_tpu_torch.ops.kernels import layer_norm as ln
    from pose3d_tpu_torch.ops.kernels import mlp_block as mb

    times = {}
    bf16 = torch.bfloat16
    C, H = ROW_WIDTH, ROW_HIDDEN
    for rows in (ROW_COUNTS[0], TRAIN_ROWS):
        t = _row_inputs(torch, rows, C, 0, bf16, 7000)
        scale, bias = t["scale"], t["bias"]
        sb, bb = scale.to(bf16), bias.to(bf16)
        _, mean, rstd = ln.layer_norm_fwd(t["x"], scale, bias, 1e-6)
        nxt = _rotating(torch, (t["x"], t["dy"]), rows * C * 2)
        kt, pt = _interleaved(
            torch,
            lambda: ln.layer_norm_fwd_reference(nxt()[0], scale, bias, 1e-6),
            lambda: ln.layer_norm_fwd(nxt()[0], scale, bias, 1e-6), 20,
            queue_behind=True)
        lt = _time_ms(torch, lambda: F.layer_norm(nxt()[0], (C,), sb, bb,
                                                  1e-6), 20,
                      queue_behind=True)
        nbytes = 2 * rows * C * 2 + 2 * C * 4 + 2 * rows * 4
        bound, by = _bound(nbytes, 8 * rows * C, PEAK_FP32)
        times[("ln_fwd", rows, C)] = dict(ms=kt, plain_ms=pt, library_ms=lt,
                                          bound_ms=bound, bound_by=by)
        log(f"[time] layer_norm forward bf16 rows={rows} C={C}: kernel "
            f"{kt:.4f} ms ({nbytes / kt / 1e6:.0f} GB/s, {bound / kt:.0%} "
            f"of the bound), plain {pt:.4f} ms, F.layer_norm {lt:.4f} ms, "
            f"bound {bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB)  [{card}]")

        kt, pt = _interleaved(
            torch,
            lambda: ln.layer_norm_bwd_reference(nxt()[0], scale, mean, rstd,
                                                nxt()[1]),
            lambda: ln.layer_norm_bwd(nxt()[0], scale, mean, rstd,
                                      nxt()[1]), 20, queue_behind=True)
        # the library's backward: one graph per rotating copy
        graphs = []
        for _ in range(max(1, min(64, -(-(256 << 20) // (rows * C * 2))))):
            xl = t["x"].clone().requires_grad_()
            sl, bl = sb.clone().requires_grad_(), bb.clone().requires_grad_()
            graphs.append((F.layer_norm(xl, (C,), sl, bl, 1e-6),
                           (xl, sl, bl), t["dy"].clone()))
        turn = [0]

        def lib_bwd():
            turn[0] = (turn[0] + 1) % len(graphs)
            y, leaves, dy = graphs[turn[0]]
            return torch.autograd.grad(y, leaves, dy, retain_graph=True)
        lt = _time_ms(torch, lib_bwd, 20, queue_behind=True)
        nbytes = 3 * rows * C * 2 + 2 * rows * 4 + 3 * C * 4
        bound, by = _bound(nbytes, 14 * rows * C, PEAK_FP32)
        times[("ln_bwd", rows, C)] = dict(ms=kt, plain_ms=pt, library_ms=lt,
                                          bound_ms=bound, bound_by=by)
        log(f"[time] layer_norm backward bf16 rows={rows} C={C} (two "
            f"launches a call: the rows, then the partial rows of dscale "
            f"and dbias): kernel {kt:.4f} ms ({nbytes / kt / 1e6:.0f} GB/s, "
            f"{bound / kt:.0%} of the bound), plain {pt:.4f} ms, "
            f"F.layer_norm's autograd backward {lt:.4f} ms, bound "
            f"{bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB)  [{card}]")
        del t, nxt, graphs, mean, rstd
        torch.cuda.empty_cache()

    N, D = ROW_COUNTS[0], ROW_WIDTH
    t = _row_inputs(torch, N, D, H, bf16, 7001)
    args = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"])
    dy = t["dy"]
    kt, pt = _interleaved(torch, lambda: mb.mlp_block_fwd_reference(*args),
                          lambda: mb.mlp_block_fwd(*args), 10)
    # the library's three calls, nn.Linear's [out, in] layout, bf16 biases
    xl = t["x"].clone().requires_grad_()
    lw1 = t["w1"].t().contiguous().requires_grad_()
    lw2 = t["w2"].t().contiguous().requires_grad_()
    lb1 = t["b1"].to(bf16).requires_grad_()
    lb2 = t["b2"].to(bf16).requires_grad_()
    with torch.no_grad():
        seq = lambda: F.linear(F.gelu(F.linear(xl, lw1, lb1)), lw2, lb2)  # noqa: E731
        lt = _time_ms(torch, seq, 10)
        hid = F.linear(xl, lw1, lb1)
        parts = (_time_ms(torch, lambda: F.linear(xl, lw1, lb1), 10),
                 _time_ms(torch, lambda: F.gelu(hid), 10),
                 _time_ms(torch, lambda: F.linear(hid, lw2, lb2), 10))
    flop = 4 * N * D * H
    nbytes = (2 * N * D + 2 * D * H) * 2 + (H + D) * 4
    bound, by = _bound(nbytes, flop, PEAK_BF16)
    times[("mlp_fwd", N, D, H)] = dict(
        ms=kt, plain_ms=pt, library_ms=lt, bound_ms=bound, bound_by=by)
    cfg = mb.launch_config(N, D, H, 2)
    if cfg["path"] != "wgmma" or mb.library_config(N, D, H, 2) != cfg:
        raise SystemExit(f"mlp_block at N={N} D={D} H={H} bf16 must take "
                         f"the wgmma path: {cfg}")
    report = {**_ptxas_report("mlp_block_fwd"),
              **_ptxas_report("mlp_block_bwd")}
    for kern, which in (("mlp_fwd_wgmma", "fwd"), ("mlp_bwd_dx_wgmma", "dx"),
                        ("mlp_bwd_dw_wgmma", "dw")):
        regs, st, ld = report[kern]
        log(f"[time] {kern}: {regs} registers a thread at the entry (384 "
            f"threads; setmaxnreg then gives the two computing warpgroups "
            f"240 and leaves the producer 24), spills {st} B stored / {ld} "
            f"B loaded, {cfg[which]['smem']} B of dynamic shared memory, "
            f"{cfg[which]['blocks']} blocks of {cfg[which]['rows']} rows"
            + (f", G={cfg['groups']} row groups, "
               f"{cfg['scratch_bytes'] / 1e6:.1f} MB of partials"
               if which == "dw" else ""))
        if st or ld:
            raise SystemExit(f"{kern} spills registers: {report[kern]}")
    log(f"[time] mlp_block forward bf16 N={N} D={D} H={H}: kernel {kt:.4f} "
        f"ms ({flop / kt / 1e9:.1f} TFLOP/s, {bound / kt:.1%} of the "
        f"bound), plain {pt:.4f} ms, F.linear -> F.gelu -> F.linear (three "
        f"calls that write the [{N}, {H}] hidden to device memory) "
        f"{lt:.4f} ms = {parts[0]:.4f} + {parts[1]:.4f} + {parts[2]:.4f} "
        f"call by call (the GELU pass is hidden traffic only: "
        f"{2 * N * H * 2 / 1e6:.0f} MB read and written), bound "
        f"{bound:.4f} ms ({by}: {flop / 1e9:.1f} GFLOP; bytes "
        f"{nbytes / HBM_BYTES_S * 1e3:.4f})  [{card}]")

    kt, pt = _interleaved(
        torch,
        lambda: mb.mlp_block_bwd_reference(t["x"], t["w1"], t["b1"], t["w2"],
                                           t["b2"], dy),
        lambda: mb.mlp_block_bwd(*args, dy), 10)
    out = seq()
    lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
        out, (xl, lw1, lb1, lw2, lb2), dy, retain_graph=True)
    lt_events = _time_ms(torch, lib_bwd, 10)
    # the time between events holds the host's launches of some ten small
    # kernels, which a shared host stretches; their device time does not,
    # and it is the harder yardstick: that one goes into library_ms
    lt = _device_busy_ms(_profile_once(
        torch, lambda: [lib_bwd() for _ in range(3)])) / 3
    if lt <= 0.0:
        raise SystemExit("the trace holds no kernel of the library's "
                         "backward")
    flop = 10 * N * D * H
    nbytes = (3 * N * D + 2 * D * H) * 2 + H * 4 + (2 * D * H + H + D) * 4
    bound, by = _bound(nbytes, flop, PEAK_BF16)
    times[("mlp_bwd", N, D, H)] = dict(
        ms=kt, plain_ms=pt, library_ms=lt, bound_ms=bound, bound_by=by)
    # what the two launches execute: each recomputes a and dga
    flop_dx, flop_dw = 6 * N * D * H, 8 * N * D * H
    bound_exec = (flop_dx + flop_dw) / PEAK_BF16 * 1e3
    log(f"[time] mlp_block backward bf16 N={N} D={D} H={H} (dx over row "
        f"tiles, the parameters' gradients over hidden chunks x row groups, "
        f"then the partials' reduce; 14·N·D·H operations executed for the "
        f"10·N·D·H counted): kernel {kt:.4f} ms ({flop / kt / 1e9:.1f} "
        f"TFLOP/s of the counted operations, {bound / kt:.1%} of the bound; "
        f"{(flop_dx + flop_dw) / kt / 1e9:.1f} TFLOP/s and "
        f"{bound_exec / kt:.1%} of the {bound_exec:.4f} ms that the executed "
        f"operations need), plain {pt:.4f} ms, "
        f"the three calls' autograd backward {lt:.4f} ms of device kernels "
        f"(torch.profiler; {lt_events:.4f} ms between events, host launches "
        f"included), bound "
        f"{bound:.4f} ms ({by}: {flop / 1e9:.1f} GFLOP; bytes "
        f"{nbytes / HBM_BYTES_S * 1e3:.4f})  [{card}]")
    # which of the backward's two launches takes the time: the mean over the
    # launches the trace holds (it can miss the first kernel after it starts)
    prof = _profile_once(torch, lambda: [mb.mlp_block_bwd(*args, dy)
                                         for _ in range(3)])

    def mean_ms(key):
        found = [e for e in prof if _is_kernel(e) and key in e.key]
        return sum(_dev_own(e) for e in found) / 1e3 / max(
            1, sum(e.count for e in found))
    dx_ms, dw_ms = mean_ms("mlp_bwd_dx"), mean_ms("mlp_bwd_dw")
    red_ms, db2_ms = mean_ms("mlp_bwd_reduce"), mean_ms("mlp_bwd_db2")
    n_kernels = sum(e.count for e in prof if _is_kernel(e))
    part_bytes = cfg["scratch_bytes"] + (2 * D * H + H + D) * 4
    log(f"[time] mlp_block backward, torch.profiler over three calls "
        f"({n_kernels} kernels, {_device_busy_ms(prof):.4f} ms of device "
        f"time in the trace), mean of a launch: mlp_bwd_dx (row tiles: dx) "
        f"{dx_ms:.4f} ms = {flop_dx / max(dx_ms, 1e-9) / 1e9:.1f} TFLOP/s of "
        f"its 6·N·D·H, mlp_bwd_dw (hidden chunks x {cfg['groups']} row "
        f"groups: partials of dW1, db1, dW2) {dw_ms:.4f} ms = "
        f"{flop_dw / max(dw_ms, 1e-9) / 1e9:.1f} TFLOP/s of its 8·N·D·H, "
        f"mlp_bwd_reduce (the partials added in fixed order) {red_ms:.4f} ms "
        f"= {part_bytes / max(red_ms, 1e-9) / 1e6:.0f} GB/s, "
        f"mlp_bwd_db2_partial (g's column sums) {db2_ms:.4f} ms  [{card}]")
    if min(dx_ms, dw_ms, red_ms, db2_ms) <= 0.0:
        raise SystemExit("the trace misses one of the backward's kernels")
    return times


def phase_times(torch, card: str, sl: dict) -> dict:
    import torch.nn.functional as F

    from pose3d_tpu_torch.checkpoint import load_pose_model
    from pose3d_tpu_torch.models import dummy_inputs
    from pose3d_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    from pose3d_tpu_torch.ops.kernels import flash_attention as fa

    times = {}
    per_pass = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}   # kernels, library
    for i, (Tq, Tk, H, D) in enumerate(PATH_SHAPES):
        cfg = fa.launch_config(8, Tq, Tk, H, D, D, 2)
        if cfg["path"] != "wgmma" or fa.library_config(
                8, Tq, Tk, H, D, D, 2) != cfg:
            raise SystemExit(f"attention at {(Tq, Tk, H, D)} bf16 must take "
                             f"the wgmma path: {cfg}")
        n = PASS_LAUNCHES[(Tq, Tk, H, D)]
        q, k, v = _qkv(torch, 8, Tq, Tk, H, D, torch.bfloat16, seed=50 + i)
        kt, pt = _interleaved(
            torch, lambda: flash_attention_fwd_reference(q, k, v),
            lambda: flash_attention_fwd(q, k, v), 20, queue_behind=True)
        # the library's call, [B, H, T, D] views of the same tensors; a
        # yardstick only, the port never calls it
        ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        with torch.no_grad():
            lib = lambda: F.scaled_dot_product_attention(ql, kl, vl)  # noqa: E731
            lt_events = _time_ms(torch, lib, 20, queue_behind=True)
            lt = _device_busy_ms(_profile_once(
                torch, lambda: [lib() for _ in range(3)])) / 3
            backend = _sdpa_backend(torch, lib)
        flop = 2 * 8 * H * Tq * Tk * (D + D)
        bound, by = _attention_bound(8, Tq, Tk, H, D, 2, False)
        times[("fwd", Tq, Tk, H, D)] = dict(
            ms=kt, plain_ms=pt, library_ms=lt, bound_ms=bound, bound_by=by)
        per_pass["fwd"][0] += n * kt
        per_pass["fwd"][1] += n * lt
        log(f"[time] attention bf16 B=8 Tq={Tq} Tk={Tk} H={H} D={D} "
            f"({cfg['path']}: {cfg['fwd']['grid']} blocks of "
            f"{cfg['fwd']['rows']} query rows, {cfg['fwd']['smem']} B of "
            f"shared memory; {n} launches a pass): kernel {kt:.4f} ms "
            f"({flop / kt / 1e9:.1f} TFLOP/s, {bound / kt:.1%} of the bound), "
            f"plain {pt:.4f} ms, scaled_dot_product_attention ({backend}) "
            f"{lt:.4f} ms of device kernels ({lt_events:.4f} between events), "
            f"bound {bound:.4f} ms ({by})  [{card}]")

        o, lse = flash_attention_fwd(q, k, v)
        do_ = torch.randn_like(o)
        kt, pt = _interleaved(
            torch,
            lambda: flash_attention_bwd_reference(q, k, v, o, do_, lse),
            lambda: flash_attention_bwd(q, k, v, o, do_, lse), 10,
            queue_behind=True)
        ol = F.scaled_dot_product_attention(ql, kl, vl)
        dol = do_.transpose(1, 2)
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            ol, (ql, kl, vl), dol, retain_graph=True)
        lt_events = _time_ms(torch, lib_bwd, 10, queue_behind=True)
        # the time between events holds the host's launches of its few
        # kernels, which a shared host stretches; their device time is the
        # harder yardstick, and it goes into library_ms
        lt = _device_busy_ms(_profile_once(
            torch, lambda: [lib_bwd() for _ in range(3)])) / 3
        if lt <= 0.0:
            raise SystemExit("the trace holds no kernel of the library's "
                             "attention backward")
        bound, by = _attention_bound(8, Tq, Tk, H, D, 2, True)
        times[("bwd", Tq, Tk, H, D)] = dict(
            ms=kt, plain_ms=pt, library_ms=lt, bound_ms=bound, bound_by=by)
        per_pass["bwd"][0] += n * kt
        per_pass["bwd"][1] += n * lt
        log(f"[time] attention backward bf16 B=8 Tq={Tq} Tk={Tk} H={H} "
            f"D={D} ({cfg['bwd']['grid']} blocks of {cfg['bwd']['rows']} "
            f"keys, {cfg['bwd']['smem']} B; the rows prologue, the main "
            f"kernel and the dq cast): kernel {kt:.4f} ms "
            f"({5 * flop / 2 / kt / 1e9:.1f} TFLOP/s, {bound / kt:.1%} of the "
            f"bound), plain {pt:.4f} ms, scaled_dot_product_attention's "
            f"backward ({backend}) {lt:.4f} ms of device kernels "
            f"(torch.profiler; {lt_events:.4f} between events), bound "
            f"{bound:.4f} ms ({by})  [{card}]")
        del q, k, v, o, do_, lse, ql, kl, vl, ol, dol
    for way, (k_ms, l_ms) in per_pass.items():
        log(f"[time] attention {way} per pass of the lifter at batch 8 "
            f"(sum of launches x ms over the four shapes: "
            f"{' + '.join(str(n) for n in PASS_LAUNCHES.values())} = "
            f"{sum(PASS_LAUNCHES.values())} launches): kernels {k_ms:.3f} ms, "
            f"scaled_dot_product_attention {l_ms:.3f} ms of device kernels "
            f"({k_ms / l_ms:.2f}x)  [{card}]")

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
        split = _kernel_split(_profile_once(torch, f_kern))
    log(f"[time] batch-8 forward, full config bf16: kernel attention "
        f"{(k1 + k2) / 2:.3f} ms, plain attention {(p1 + p2) / 2:.3f} ms "
        f"between events (runs {k1:.3f}/{k2:.3f} vs {p1:.3f}/{p2:.3f}); "
        f"torch.profiler, one forward with the kernel: {_split_text(split)} "
        f"(the rest of the time between events is the card waiting for the "
        f"host's launches)  [{card}]")
    for b, ms in sl["latency"].items():
        log(f"[time] /predict latency, batch {b}, median of 10 sequential "
            f"requests: {ms:.2f} ms  [{card}]")
    del model, ref_model, args
    times.update(_time_bn_stats(torch, card))
    times.update(_time_lane_resample(torch, card))
    times.update(_time_row_ops(torch, card))
    return times


def phase_imports() -> None:
    """The port, every module of it imported, has loaded nothing of JAX,
    flax or the JAX package."""
    import importlib
    import pkgutil

    import pose3d_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(
        pose3d_tpu_torch.__path__, "pose3d_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                        "pose3d_tpu"))
    log(f"[imports] {len(names)} modules of pose3d_tpu_torch imported; "
        f"of jax, jaxlib, flax, pose3d_tpu in sys.modules: {bad or 'none'}")
    if bad:
        raise SystemExit(f"the port imported {bad}")


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
        phase_augment(torch, card)
        rows = phase_rowops(torch, card)
        tr = phase_train(torch, Path(tmp), card)
        cnn = phase_cnn(torch, Path(tmp), card)
    phase_imports()
    # (file:line of the TPU kernel, launches on its main path, key of the
    # shape its times are given at)
    kernels = {
        "flash_attention_fwd": (
            "pose3d_tpu/ops/pallas/flash_attention.py:49",
            tr["launches"]["flash_attention_fwd"], ("fwd", *PATH_SHAPES[0])),
        "flash_attention_bwd": (
            "pose3d_tpu/ops/pallas/flash_attention.py:90",
            tr["launches"]["flash_attention_bwd"], ("bwd", *PATH_SHAPES[0])),
        "bn_stats": ("pose3d_tpu/ops/pallas/bn_stats.py:34",
                     cnn["launches"], ("bn", *BN_STEM)),
        "lane_resample": (
            "pose3d_tpu/ops/pallas/lane_resample.py:41",
            next(iter(cnn["augment"].values()))["launches"],
            ("lr", *LR_IMAGE, 1)),
        "layer_norm_fwd": (
            "pose3d_tpu/ops/pallas/layer_norm.py:43", rows["layer_norm_fwd"],
            ("ln_fwd", ROW_COUNTS[0], ROW_WIDTH)),
        "layer_norm_bwd": (
            "pose3d_tpu/ops/pallas/layer_norm.py:58", rows["layer_norm_bwd"],
            ("ln_bwd", ROW_COUNTS[0], ROW_WIDTH)),
        "mlp_block_fwd": (
            "pose3d_tpu/ops/pallas/mlp_block.py:72", rows["mlp_block_fwd"],
            ("mlp_fwd", ROW_COUNTS[0], ROW_WIDTH, ROW_HIDDEN)),
        "mlp_block_bwd": (
            "pose3d_tpu/ops/pallas/mlp_block.py:88", rows["mlp_block_bwd"],
            ("mlp_bwd", ROW_COUNTS[0], ROW_WIDTH, ROW_HIDDEN)),
    }
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"pose3d_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": launches,
        **worst[name],
        **times[key],
    } for name, (replaces, launches, key) in kernels.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

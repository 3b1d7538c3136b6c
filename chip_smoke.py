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
     register/shared-memory/spill lines; a spill in ``bn_stats`` or in
     either ``layer_norm`` kernel fails);
  3. kernels: each kernel against its plain PyTorch version at every shape
     the paths give it and at ragged ones, in bf16 and fp32, with the
     tolerances below (attention: also at the edges of the ``wgmma``
     kernels' tiles, on packed q/k/v views read in place, at YOLO11x's
     PSA pair with a value depth twice the key depth, at head depth 16,
     and at every shape of the tools phase's two models: the lifecycle's
     tiny transformer and the overfit's reduced ViT), the path each shape
     takes — ``wgmma`` / ``wmma`` / ``scalar`` — asserted from
     ``launch_config`` and from the built libraries, and the ``wgmma``
     kernels' ptxas report read: a spill or a serialized ``wgmma`` (C7520,
     C7512) fails; ``bn_stats``: forward and the Function's backward;
     ``bn_stats`` and the ``layer_norm`` backward, which add partial rows
     across blocks inside their one launch, and the ``layer_norm``
     forward, a persistent row stream: one kernel launch a call as
     ``torch.profiler`` sees it, and the plan the Python mirror computes
     (``launch_config``, ``fwd_launch_config``) equal to the built
     library's, at every shape;
     ``lane_resample``: order 0 equal, order 1 within 1e-6;
     ``layer_norm`` and ``mlp_block``: forward and backward at the
     lifter's row counts and widths and at ragged ones; ``mlp_block``
     also at the edges of its ``wgmma`` tiling, with the path each shape
     takes (``wgmma`` / ``wmma`` / ``scalar``) asserted from
     ``launch_config`` and from the built libraries; repeats bitwise
     for every kernel that uses no atomics);
  3b. contracts: the shapes the TPU kernels take beyond the built ones,
     each held against its plain version: both attention kernels at head
     depths 8, 24, 80, 96, 200 and 256 and the pairs (48, 96) and (24, 40),
     in bf16 and fp32, ragged, and at transformer_heads=8's B 8 x (1025,
     1025, 8, 96), each run on the smallest built pair that holds it
     (``padded_pair``; the (256, 256) pair's backward on 32-key blocks),
     its path and plan asserted from ``launch_config`` and the built
     libraries, o, lse, dk and dv bitwise on a repeat; a depth of 264
     refused on the card; ``lane_resample`` in bf16, equal to its plain
     version in both orders; ``mlp_block`` past D 1,280 refused (ViT-L's
     and ViT-H's widths and the odd widths 40 and 776 run in phase 3's
     row-op check, with D's column slices asserted); one full-width
     training step with ``transformer_heads=8`` (B 2 x A 1, dropout off)
     through the kernels against the plain pair, fp32 and bf16, its first
     layer's gradient finite and nonzero; and the times of the new shapes:
     attention at (8, 1025, 1025, 8, 96) and (8, 1025, 1025, 3, 256)
     beside cuDNN's time at each (phase 6 times the lifter's (8, 1025,
     1025, 12, 64)),
     ``mlp_block`` at ViT-L's and ViT-H's widths beside ``F.linear →
     F.gelu → F.linear``, bf16 ``lane_resample`` on the CNN's first warp
     pass;
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
     ``bn_stats``'s sum over the 59 calls of one microbatch forward beside
     the bound's sum,
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
     per BatchNorm per microbatch, the step's device time from
     ``torch.profiler`` beside its host time; (b) one batch-10 fp32 step
     with the kernel and with the plain statistics (loss, whole gradient,
     every running mean and variance); (c) ``normalization="batch"`` in the
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
     with TF32 off, in fp32;
 10. cli: the training path from the shell on the committed chunk fixture
     (``tests/torch_port_fixtures``): the decode route this machine has
     (the native library built from ``native/*.cc``, else cv2) held against
     the fixture's committed pixels (PNG equal, JPEG within one level); the
     full-width CNN from ``pose3d_tpu_torch.cli.main`` at 10 × 10 with
     rotation, stopped by SIGTERM after its step-2 checkpoint and resumed
     by the same command line (``--checkpoint auto``) to step 4: resumed at
     the saved step and data position, retention and the best pointer as
     the JAX rules say, ``lane_resample`` 4 a step, finite losses; the
     transformer for 2 steps with a validation (20 attention launches a
     pass each way); the ``batch_pallas`` CNN in scan for a step
     (``bn_stats`` once per BatchNorm per microbatch); ``cli.evaluate
     --per-action`` on the best checkpoint against an in-process
     ``evaluate`` of the restored state; and the host feed:
     ``train_model``'s step time with the device prefetch, without its
     feeder thread and with the synchronous copy, beside the bare step, the
     CNN from the chunk pipeline, and a checkpoint save of each model;
 11. data: the data path from the shell: a synthetic preprocessed
     Human3.6M layout (subjects 1, 5, 6, 7, 8, 9, 11; 1000×1000 JPEG
     frames, 8-bit depth PNGs, keypoint JSON, the three annotation JSONs)
     through ``pose3d_tpu_torch.cli.chunker``, ``cli.split`` (train
     1, 5, 6, 7, 8; test 9, 11) and ``cli.rechunker``, each timed in its
     own process, with the sample counts, the routing by subject and the
     shuffled set checked; ``PoseAugmentor``'s time a sample at 500×500;
     the host feed alone, twice with and twice without the augmentor;
     the full-width CNN (4 grouped 10×10 steps, no kernel) and the
     transformer (4 steps and a validation, 20 attention launches a pass
     each way) trained with ``--augment`` from the shuffled archives,
     beside the same runs without it, their step times read after the
     first epoch; a ``batch_pallas:N`` CNN in scan for
     a step (``bn_stats`` once per BatchNorm at or above N pixels a sample
     per microbatch, none below); ``cli.evaluate`` on the test split from
     bare state_dicts (the CNN with no hint, the transformer with
     ``--model-type transformer`` and refused without it); a
     ``batch_dot`` ``.pth`` loaded and served;
 12. export: (a) the full transformer from ``cli.main`` on the fixture,
     grouped 10 × 10 with the published dropout, with and without
     ``--remat`` (40 forward and 20 backward attention launches a pass
     with it), and the bare remat step against the plain one from one
     seeded state and generator (loss, whole gradient, step time, peak
     memory); (b) one timed grouped 10 × 10 step of the full-width CNN with
     each of ``identity``, ``instance``, ``layer`` and ``group``; (c)
     ``cli.infer`` in its own process for a full-width transformer and CNN
     ``.pth`` on 16 cached 1,000×1,000 frames at batch 8, the saved joints
     against a direct forward on the same decompacted inputs; (d)
     ``cli.export`` of both lifters (dynamic ``xla``, the transformer's
     ``pallas`` with the custom operator in its graph and 20 launches a
     call, ``--batch-size 8``, ``--quantize int8``), each artifact against
     the live model at batches 1, 3 and 8 (int8: the dequantised weights'),
     the ``xla`` ones in a process that cannot import the port; (e)
     ``serve_http --artifact`` of the ``pallas`` and the static artifacts,
     ``/predict`` timed at batch 1 and 8, a batch of 3 padded.
 13. stage1: YOLO11x-pose at 640 and DepthPro (apple/DepthPro-hf's
     architecture) at 1536², with seeded random weights written as a plain
     upstream-named ``.pt`` and as a ``.safetensors`` by a minimal writer
     here (the architecture read from its shapes); the main path, the
     provider with ``attention_backend="pallas"`` on two frames (2 + 72
     launches); (a) each network's ``"pallas"`` against ``"xla"``, fp32
     and bf16, the path of each attention shape asserted, a zeroed
     attention as a control beyond the bf16 bound; (b) launches a call;
     (c) ``cli.preprocess`` on 8 1000x1000 frames in two folders, its
     artifacts against the provider, a second run that skips, ``cli.infer
     --stage1 cached`` and ``--stage1 jax``; (d) ``serve_http
     --checkpoint`` (the full pipeline) at batch 1 and 8 against a direct
     provider + lifter call; (e) times: forwards, the attention kernel at
     the two stage-1 shapes, the preprocess pieces, ``/predict_image``;
     ``cli.preprocess`` and ``cli.infer --stage1 jax`` again with
     ``--data-parallel``, against the runs without it;
 14. parallel: (a) ``cli.main`` at a world of one over NCCL
     (``--coordinator``, ``--num-processes 1``, ``--process-id 0``) with
     ``--param-sharding fsdp``, the CNN stopped by SIGTERM and resumed, the
     transformer for 2 steps, against the same command lines without the
     flags; (b) two ranks sharing the card (``chip_smoke.py
     --parallel-rank``) over gloo, every collective through host memory
     (NCCL refuses two ranks on one device): one step each of DP (the CNN
     grouped 10×10 with rotation, and scan ``batch_pallas`` 2×10, both
     fp32), FSDP (the transformer 10×10) and TP, TP+SP and PP (the
     transformer 1×10, cut from 10×10 to hold two ranks on 80 GB), against
     the same step in one process (loss, gradient, running statistics,
     parameters), the launches of each kernel on each rank against the
     counts the code implies, then (the DP CNN alone, ``PAR_TIMED``) a warm
     step timed with its collectives' host time, each rank's peak and
     parameter + moment bytes; (c) the
     untrained stage-1 provider over two replicas on the card against one.
 15. tools: (a) ``python -m pose3d_tpu_torch.cli.doctor --probe --json`` in
     its own process: the card the environment phase found, with its power
     limit, and all eight kernel libraries loaded, its probes logged; then,
     started before phase 14 and run beside it, side by side, each in
     processes of its own, (b)
     ``scripts/torch_lifecycle_e2e.py`` for the CNN and the transformer
     (head depth 16): train, SIGTERM, ``--checkpoint auto`` resume held
     bitwise to an uninterrupted control (both families: every attention
     of the tiny transformer fits one key block, so its dQ takes one
     atomic add an element and repeats),
     ``cli.evaluate --per-action``, ``cli.export --ema`` against the live
     model, ``serve_http --artifact`` answering ``/predict``; (c)
     ``scripts/torch_overfit_demo.py --model-type transformer`` for 600
     steps on one superbatch, which must learn (the last loss below a
     quarter of step 1's, the train batch's MPJPE below half the untrained
     value); (d)
     ``scripts/torch_quantize_accuracy.py`` on its checkpoint, the int8 −
     fp32 MPJPE printed, the attention kernel inside the programs.

Standard output ends with a JSON line of the kernels (``launches`` on
the path that first drives each kernel, ``cli_launches`` on phase 10's
runs, ``data_launches`` on phase 11's, ``export_launches`` on phase 12's,
``stage1_launches`` on phase 13's main path, ``parallel_launches`` on each
of phase 14's two ranks, ``tools_launches`` summed over phase 15's
processes, ``contract_launches`` on phase 3b's ``transformer_heads=8``
step, ``contract_times`` the times of phase 3b's shapes)
and, last, one JSON line ``{"ok": true, "device": {...}}``. Without CUDA,
or without the repository beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import textwrap
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
# (T, H, D) of self-attention whose every score is about -110 (q along a
# direction, k against it), so each row's lse is below -100: the rows a
# trained lifter gives some tokens. Keys past Tk must add nothing to dQ;
# T = 130 and 257 leave 2 and 1 keys in the last 128-key block.
LOW_LSE_SHAPES = [(130, 2, 48), (130, 2, 64), (257, 4, 48)]
LOW_LSE_SCORE = 110.0
# (Tq, Tk, H, D) at head depth 16, on the WMMA (bf16) and scalar (fp32)
# kernels, at B 2 like the cases above: one token, and lengths across a
# 64-row tile
D16_SHAPES = [(1, 1, 4, 16), (70, 130, 2, 16), (130, 70, 2, 16)]
# (B, Tq, Tk, H, D) of every attention call of the tools phase's two models
# (read off their forwards): the lifecycle's tiny transformer (embed 64 over
# 4 heads, D 16: the ViT's 1 + 16 tokens, the fusion block's cross
# attentions between 16 image and 4 heatmap tokens, the final encoder's
# 1 + 16 + 4) at its batch of 4 and at the grouped pair's 8, and the
# overfit's reduced ViT (embed 192 over 4 heads, D 48: 1 + 256 image and 16
# heatmap tokens) at its batch of 8
TOOLS_ATTN_SHAPES = ([(b, Tq, Tk, 4, 16) for b in (4, 8) for Tq, Tk in
                      ((17, 17), (16, 4), (4, 16), (21, 21))]
                     + [(8, Tq, Tk, 4, 48) for Tq, Tk in
                        ((257, 257), (256, 16), (16, 256), (273, 273))])
# The kernels' full contracts: attention at head depths off the built pairs
# (B, Tq, Tk, H, D, Dv), each run on the smallest built pair that holds it
# (padded_pair), in bf16 and fp32: D 96 (transformer_heads=8 at embed
# 768), 80 (ViT-H's), 200 and 256 (the widest, on the (256, 256) instance:
# 32 keys a backward block), 8 and 24, (48, 96) and (24, 40), at ragged
# lengths, and transformer_heads=8's B 8 x (1025, 1025, 8, 96); a depth
# past 256 must be refused. Then the times of the padded route at
# (B, Tq, Tk, H, D) in bf16.
PADDED_ATTN = [(2, 130, 67, 4, 96, 96), (2, 67, 130, 3, 200, 200),
               (2, 65, 33, 2, 256, 256), (2, 100, 100, 4, 80, 80),
               (2, 33, 70, 4, 8, 8), (2, 70, 33, 4, 24, 24),
               (2, 129, 65, 4, 48, 96), (2, 65, 129, 4, 24, 40),
               (8, 1025, 1025, 8, 96, 96)]
PADDED_ATTN_TIMES = [(8, 1025, 1025, 8, 96), (8, 1025, 1025, 3, 256)]
# the kernel each key of phase 3b's times belongs to
CONTRACT_KERNEL = {"fwd": "flash_attention_fwd", "bwd": "flash_attention_bwd",
                   "mlp_fwd": "mlp_block_fwd", "mlp_bwd": "mlp_block_bwd",
                   "lr": "lane_resample"}
# lane_resample in bf16 (the TPU kernel takes any float type): the
# positions stay fp32, the rest is bf16 rounded after each operation in both
# versions, so they agree bit for bit; (N, W) as in fp32
LR_BF16 = [(150000, 500), (153600, 512)] + [(13, w) for w in (1, 50, 129)]
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
# mlp_block at the widths the TPU kernel takes beyond the lifter's: ViT-L's
# (1,024 x 4,096) and ViT-H's (1,280 x 5,120) at the lifter's 8,200 rows,
# with D's output columns split across blocks (two slices of 512 and 640,
# on the WMMA kernels), and widths that are no multiple of 16 (zero-padded
# by the launcher: D 40 with H 100, D 776 with H 3,104, whose padded 784
# also splits); a D past 1,280 must be refused.
MLP_WIDE = [(8200, 1024, 4096, "wmma"), (8200, 1280, 5120, "wmma"),
            (257, 40, 100, "wmma"), (257, 776, 3104, "wmma")]
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
             (7, 48, 80, "wmma"), (33, 720, 160, "wmma")] + MLP_WIDE

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
# the row kernels on csrc/row_reduce.cuh's stream (the two that add partial
# rows across blocks in their own launch, and the layer_norm forward): their
# sources' kernels as ptxas names them
ROW_REDUCE_KERNELS = {"bn_stats": ("bn_stats_kernel",),
                      "layer_norm_bwd": ("layer_norm_bwd_wide",
                                         "layer_norm_bwd"),
                      "layer_norm_fwd": ("layer_norm_fwd_ring",
                                         "layer_norm_fwd_rows")}
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


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)
    # the script's clock beside the head of each line, on standard error:
    # where the time went when a run nears its limit
    print(f"[chip_smoke +{time.perf_counter() - _T0:.1f} s] {msg[:90]}",
          file=sys.stderr, flush=True)


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
    from pose3d_tpu_torch.ops.kernels import wrappers

    return {fn.__name__: fn for fn in wrappers()}


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
    """(B, Tq, Tk, H, D, Dv, packed) of every attention check."""
    return ([(2, Tq, Tk, H, D, D, False)
             for Tq, Tk, H, D in PATH_SHAPES + RAGGED_SHAPES + ATTN_EDGES]
            + [(2, T, T, H, D, D, True) for T, H, D in PACKED_SHAPES]
            + [(2, *PSA_SHAPE, False)]
            + [(2, Tq, Tk, H, D, D, False) for Tq, Tk, H, D in D16_SHAPES]
            + [(B, Tq, Tk, H, D, D, False)
               for B, Tq, Tk, H, D in TOOLS_ATTN_SHAPES])


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


def _check_attention_low_lse(torch, failures: list) -> float:
    """Both attention kernels against the plain pair where every score is
    about -``LOW_LSE_SCORE`` (``LOW_LSE_SHAPES``), in bf16 and fp32: finite
    outputs and gradients within the usual bounds. Before the ``wgmma``
    backward kept the P of keys past Tk finite, such rows made its dQ NaN
    (a zero score there gave exp2(-lse·log2 e) = inf, times K's zero row).
    Returns the worst gradient error."""
    from pose3d_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for i, (T, H, D) in enumerate(LOW_LSE_SHAPES):
            g = torch.Generator(device="cuda").manual_seed(2000 + i)
            rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
            e = rnd(1, 1, H, D)
            e = e / e.norm(dim=-1, keepdim=True)
            c = (LOW_LSE_SCORE * D ** 0.5) ** 0.5
            q = (c * e + 0.05 * rnd(2, T, H, D)).to(dtype)
            k = (-c * e + 0.05 * rnd(2, T, H, D)).to(dtype)
            v, do = rnd(2, T, H, D).to(dtype), rnd(2, T, H, D).to(dtype)
            o, lse = flash_attention_fwd(q, k, v)
            grads = flash_attention_bwd(q, k, v, o, do, lse)
            ro, rlse = flash_attention_fwd_reference(q, k, v)
            refs = flash_attention_bwd_reference(q, k, v, o, do, lse)
            torch.cuda.synchronize()
            ok = (torch.isfinite(o).all().item()
                  and (o.float() - ro.float()).abs().max().item()
                  <= TOL_O[name]
                  and (lse - rlse).abs().max().item() <= TOL_LSE)
            errs = []
            for x, r in zip(grads, refs):
                err = (x.float() - r.float()).abs().max().item()
                errs.append(err)
                ok &= (torch.isfinite(x).all().item()
                       and err <= TOL_GRAD[name]
                       * max(1.0, r.float().abs().max().item()))
            worst = max([worst] + [x for x in errs if x == x])
            log(f"[kernel] low lse {name:8s} B=2 T={T} H={H} D={D} "
                f"{_attention_path(name, D, D)}: lse max {lse.max().item():.1f}"
                f", max|d(dq,dk,dv)|=" + ",".join(f"{x:.2e}" for x in errs)
                + f" (tol {TOL_GRAD[name]:.0e}·max(1,|ref|))  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("low lse", name, T, H, D))
    return worst


def _row_reduce_ptxas(name: str) -> dict:
    """{kernel<type,args>: (registers, spill store bytes, spill load bytes,
    shared bytes)} of every instantiation in the build log of
    ``csrc/<name>.cu`` (a key of ``ROW_REDUCE_KERNELS``)."""
    import re

    from pose3d_tpu_torch.ops.kernels import _build

    bases = "|".join(ROW_REDUCE_KERNELS[name])
    out, entry = {}, None
    for line in _build.build_info[name]["log"].splitlines():
        if "Compiling entry function" in line:
            m = re.search(rf"\d+({bases})I(f|13__nv_bfloat16)((?:Li\d+E)+)E",
                          line)
            entry = None
            if m:
                args = ["bf16" if m.group(2) != "f" else "f32"] + re.findall(
                    r"Li(\d+)E", m.group(3))
                entry = f"{m.group(1)}<{','.join(args)}>"
                out[entry] = [None, 0, 0, 0]
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[entry][1:3] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry][0] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[entry][3] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def _check_row_reduce_build() -> None:
    """ptxas's registers, spills and shared memory for every kernel of the
    three row sources; a spill fails the run."""
    for name in ROW_REDUCE_KERNELS:
        report = _row_reduce_ptxas(name)
        if not report:
            raise SystemExit(f"{name}: no kernel in the build log")
        for kern, (regs, st, ld, smem) in sorted(report.items()):
            log(f"[build] {kern}: {regs} registers, spills {st} B stored / "
                f"{ld} B loaded, {smem} B shared")
            if st or ld:
                raise SystemExit(f"{kern} spills registers")


def _launches_per_call(torch, fn, calls: int = 3, tries: int = 3) -> dict:
    """{kernel name: launches per call} that ``torch.profiler`` records
    over ``calls`` calls of ``fn`` (after one call outside the trace). The
    trace starts with a short sleep kernel, left out: a trace can miss the
    first kernel after it starts, and now and then records none; a trace
    without the sleep kernel is taken again, up to ``tries`` times."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out, slept = {}, False
        for e in prof.key_averages():
            if not _is_kernel(e):       # the host's runtime calls
                continue
            if "spin" in e.key or "sleep" in e.key:
                slept = True
                continue
            key = e.key.replace("(anonymous namespace)::", "")
            name = re.split(r"[<(]", re.sub(r"^void ", "", key))[0]
            name = name.split("::")[-1].strip()
            out[name] = out.get(name, 0) + e.count / calls
        if slept:
            break
    return out


def _one_launch(torch, fn, kernel: str) -> tuple:
    """(ok, what torch.profiler saw): one launch of ``kernel`` a call and
    no other kernel."""
    seen = _launches_per_call(torch, fn)
    return (len(seen) == 1 and next(iter(seen)).startswith(kernel)
            and next(iter(seen.values())) == 1), seen


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
    _check_row_reduce_build()
    worst = 0.0
    worst_bwd = 0.0
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for i, (B, Tq, Tk, H, D, Dv, packed) in enumerate(
                _attention_cases()):
            shape = (f"B={B} Tq={Tq:4d} Tk={Tk:4d} H={H:2d} D={D} Dv={Dv}"
                     + (" packed" if packed else ""))
            cfg = fa.launch_config(B, Tq, Tk, H, D, Dv, dtype.itemsize)
            path_ok = (cfg["path"] == _attention_path(name, D, Dv)
                       and fa.library_config(B, Tq, Tk, H, D, Dv,
                                             dtype.itemsize) == cfg)
            g = torch.Generator(device="cuda").manual_seed(i)
            mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(  # noqa: E731
                dtype)
            if packed:
                q, k, v = mk(B, Tq, 3, H, D).unbind(2)
            else:
                q, k, v = mk(B, Tq, H, D), mk(B, Tk, H, D), mk(B, Tk, H, Dv)
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
    worst_bwd = max(worst_bwd, _check_attention_low_lse(torch, failures))
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


def _check_padded_attention(torch, failures: list) -> tuple:
    """Both attention kernels at ``PADDED_ATTN``, bf16 and fp32, against
    the plain pair at the true depths: the pair each shape runs on read
    from ``padded_pair``, its path and plan from ``launch_config`` held
    equal to the built libraries', outputs of the true depths within the
    bounds above, one launch counted a call, o, lse, dk and dv bitwise on
    a repeat. Then a depth past 256 is refused before any launch. Returns
    (worst forward, worst backward) max |Δ|."""
    from pose3d_tpu_torch.ops.kernels import flash_attention as fa

    worst = worst_bwd = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for i, (B, Tq, Tk, H, D, Dv) in enumerate(PADDED_ATTN):
            Dp, Dvp = fa.padded_pair(D, Dv)
            cfg = fa.launch_config(B, Tq, Tk, H, Dp, Dvp, dtype.itemsize)
            path_ok = (cfg["path"] == _attention_path(name, Dp, Dvp)
                       and fa.library_config(B, Tq, Tk, H, Dp, Dvp,
                                             dtype.itemsize) == cfg)
            g = torch.Generator(device="cuda").manual_seed(7000 + i)
            mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(  # noqa: E731
                dtype)
            q, k, v = mk(B, Tq, H, D), mk(B, Tk, H, D), mk(B, Tk, H, Dv)
            before = fa.flash_attention_fwd.launches
            o, lse = fa.flash_attention_fwd(q, k, v)
            torch.cuda.synchronize()
            o2, lse2 = fa.flash_attention_fwd(q, k, v)
            ro, rlse = fa.flash_attention_fwd_reference(q, k, v)
            torch.cuda.synchronize()
            do = (o.float() - ro.float()).abs().max().item()
            dl = (lse - rlse).abs().max().item()
            ok = (o.shape == (B, Tq, H, Dv) and o.dtype == dtype
                  and torch.isfinite(o).all().item() and do <= TOL_O[name]
                  and dl <= TOL_LSE and torch.equal(o, o2)
                  and torch.equal(lse, lse2) and path_ok
                  and fa.flash_attention_fwd.launches == before + 2)
            worst = max(worst, do)
            dy = mk(B, Tq, H, Dv)
            grads = fa.flash_attention_bwd(q, k, v, o, dy, lse)
            torch.cuda.synchronize()
            again = fa.flash_attention_bwd(q, k, v, o, dy, lse)
            refs = fa.flash_attention_bwd_reference(q, k, v, o, dy, lse)
            torch.cuda.synchronize()
            ok &= torch.equal(grads[1], again[1]) and torch.equal(grads[2],
                                                                  again[2])
            errs = []
            for x, r in zip(grads, refs):
                err = (x.float() - r.float()).abs().max().item()
                errs.append(err)
                worst_bwd = max(worst_bwd, err)
                ok &= (x.shape == r.shape and x.dtype == dtype
                       and torch.isfinite(x).all().item()
                       and err <= TOL_GRAD[name]
                       * max(1.0, r.float().abs().max().item()))
            log(f"[kernel] padded attention {name:8s} B={B} Tq={Tq} Tk={Tk} "
                f"H={H} D={D} Dv={Dv} on the ({Dp}, {Dvp}) pair, "
                f"{cfg['path']} ({cfg['bwd']['rows']} keys a backward block, "
                f"{cfg['fwd']['smem']} / {cfg['bwd']['smem']} B), the "
                f"library's plan {'the same' if path_ok else 'DIFFERS'}: "
                f"max|do|={do:.2e} (tol {TOL_O[name]:.0e}) max|dlse|="
                f"{dl:.2e}; max|d(dq,dk,dv)|="
                + ",".join(f"{e:.2e}" for e in errs)
                + f" (tol {TOL_GRAD[name]:.0e}·max(1,|ref|)); o, lse, dk, dv "
                f"repeat bitwise  {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("padded attention", name, B, Tq, Tk, H, D,
                                 Dv))
            del q, k, v, o, o2, ro, grads, again, refs
    q = torch.zeros(1, 4, 1, 264, device="cuda", dtype=torch.bfloat16)
    counts = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    refused = []
    for call in (lambda: fa.flash_attention_fwd(q, q, q),
                 lambda: fa.flash_attention_bwd(
                     q, q, q, q, q, torch.zeros(1, 1, 4, device="cuda"))):
        try:
            call()
            refused.append(False)
        except ValueError as e:
            refused.append("256" in str(e))
    ok = all(refused) and counts == (fa.flash_attention_fwd.launches,
                                     fa.flash_attention_bwd.launches)
    log(f"[kernel] attention at D = Dv = 264 on the card: both launchers "
        f"refuse it naming the limit 256, no launch  {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(("attention", "D 264 not refused"))
    return worst, worst_bwd


def _check_lane_resample_bf16(torch, failures: list) -> float:
    """lane_resample in bf16 against its plain version (``LR_BF16``), both
    orders: equal, and bitwise on a repeat. Returns the worst max |Δ|."""
    from pose3d_tpu_torch.ops.kernels.lane_resample import (
        lane_resample,
        lane_resample_reference,
    )

    worst = 0.0
    for i, (n, w) in enumerate(LR_BF16):
        x, a, o = _lane_resample_inputs(torch, n, w, 3500 + i)
        x = x.to(torch.bfloat16)
        for order in (0, 1):
            got = lane_resample(x, a, o, order)
            torch.cuda.synchronize()
            again = lane_resample(x, a, o, order)
            ref = lane_resample_reference(x, a, o, order)
            err = (got.float() - ref.float()).abs().max().item()
            worst = max(worst, err)
            ok = (got.shape == (n, w) and got.dtype == torch.bfloat16
                  and torch.equal(got, again) and torch.equal(got, ref))
            log(f"[kernel] lane_resample bf16 order {order} N={n:6d} W={w:3d}"
                f": max|d|={err:.2e} (must be equal); repeats bitwise  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(("lane_resample bf16", order, n, w))
            del got, again, ref
        del x, a, o
    return worst


def _check_mlp_refusal(torch, failures: list) -> None:
    """A D past 1,280 is refused on the card, naming the limit, before any
    launch."""
    from pose3d_tpu_torch.ops.kernels import mlp_block as mb

    t = _row_inputs(torch, 4, 1296, 64, torch.bfloat16, 6500)
    args = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"])
    counts = (mb.mlp_block_fwd.launches, mb.mlp_block_bwd.launches)
    refused = []
    for call in (lambda: mb.mlp_block_fwd(*args),
                 lambda: mb.mlp_block_bwd(*args, t["dy"])):
        try:
            call()
            refused.append(False)
        except ValueError as e:
            refused.append("1280" in str(e))
    ok = all(refused) and counts == (mb.mlp_block_fwd.launches,
                                     mb.mlp_block_bwd.launches)
    log(f"[kernel] mlp_block at D 1,296 on the card: both launchers refuse it "
        f"naming the limit 1280, no launch  {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(("mlp_block", "D 1296 not refused"))


def _heads8_step(torch) -> dict:
    """One training step of the full-width lifter with
    ``transformer_heads=8`` (head depth 96 in the fusion and final blocks:
    the padded route), batch 2 x accumulation 1, dropout off, through the
    kernels against the plain pair from the same seeded init, in fp32 and
    bf16: the loss within the step bounds of phase 5, and the first
    layer's gradient finite and nonzero. Returns the kernels' launches of
    the bf16 step."""
    from pose3d_tpu_torch.core.config import TransformerModelConfig
    from pose3d_tpu_torch.models import build_model
    from pose3d_tpu_torch.train import loop, state as tstate, step as tstep

    cfg = TransformerModelConfig(transformer_heads=8,
                                 transformer_dropout_rate=0.0,
                                 regression_dropout=0.0)
    sb = loop.to_device(next(loop._superbatches(_train_batches(
        8, 1, 2, tuple(cfg.image_size), cfg.num_joints), 1)), "cuda")
    launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        out = {}
        for impl in ("reference", "auto"):
            model = build_model(
                cfg, device="cuda", dtype=dtype, train=True,
                attention_impl=impl,
                generator=torch.Generator("cuda").manual_seed(0))
            st = tstate.create_train_state(model)
            before = launch_counts()
            m = tstep.make_train_step()(st, sb)
            torch.cuda.synchronize()
            after = launch_counts()
            pname, first = next(iter(model.named_parameters()))
            out[impl] = (m["total_loss"].item(), pname, first.grad)
            if impl == "auto":
                launches = {k: after[k] - before[k] for k in after}
            del model, st
        (l_ref, _, _), (l_k, pname, grad) = out["reference"], out["auto"]
        dl = abs(l_k - l_ref) / abs(l_ref)
        gmax = grad.float().abs().max().item() if grad is not None else 0.0
        ok = (np.isfinite(l_k) and dl <= TOL_STEP_LOSS[name]
              and grad is not None and torch.isfinite(grad).all().item()
              and gmax > 0.0)
        attn = {k: v for k, v in launches.items() if "attention" in k}
        log(f"[kernel] transformer_heads=8 full-width step {name} B=2 x A=1 "
            f"(fusion and final attention at head depth 96 on the (128, "
            f"128) pair): loss {l_k:.6f} vs plain pair {l_ref:.6f} (rel "
            f"{dl:.2e}, tol {TOL_STEP_LOSS[name]:.0e}); first layer "
            f"{pname}'s gradient finite, max |g| {gmax:.3e}; launches "
            f"{attn if dtype == torch.bfloat16 else '(fp32)'}  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the transformer_heads=8 step through the "
                             "kernels disagrees with the plain pair")
        del out, grad
        torch.cuda.empty_cache()
    return launches


def _time_padded_attention(torch, card: str) -> dict:
    """The padded route's times at ``PADDED_ATTN_TIMES`` (bf16), both
    directions: kernel (padding and slicing included), plain pair,
    ``scaled_dot_product_attention``'s device time at the true depth (a
    yardstick only) and the bound of the true depth's work (phase 6 times
    the lifter's (1025, 1025, 12, 64) on its own wgmma pair beside them)."""
    import torch.nn.functional as F

    from pose3d_tpu_torch.ops.kernels import flash_attention as fa

    times = {}
    for i, (B, T, _, H, D) in enumerate(PADDED_ATTN_TIMES):
        Dp, Dvp = fa.padded_pair(D, D)
        cfg = fa.launch_config(B, T, T, H, Dp, Dvp, 2)
        q, k, v = _qkv(torch, B, T, T, H, D, torch.bfloat16, seed=90 + i)
        ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        with torch.no_grad():
            lib = lambda: F.scaled_dot_product_attention(ql, kl, vl)  # noqa: E731
            lt = _device_busy_ms(_profile_once(
                torch, lambda: [lib() for _ in range(3)])) / 3
            backend = _sdpa_backend(torch, lib)
        kt, pt = _interleaved(
            torch, lambda: fa.flash_attention_fwd_reference(q, k, v),
            lambda: fa.flash_attention_fwd(q, k, v), 10, queue_behind=True)
        bound, by = _attention_bound(B, T, T, H, D, 2, False)
        times[("fwd", B, T, H, D)] = dict(ms=kt, plain_ms=pt, library_ms=lt,
                                          bound_ms=bound, bound_by=by)
        route = ("its own pair" if (Dp, Dvp) == (D, D)
                 else f"padded to the ({Dp}, {Dvp}) pair")
        log(f"[time] attention bf16 B={B} T={T} H={H} D={D}, {route} "
            f"({cfg['path']}): kernel {kt:.4f} ms ({bound / kt:.1%} of the "
            f"bound), plain {pt:.4f} ms, scaled_dot_product_attention "
            f"({backend}) {lt:.4f} ms of device kernels, bound {bound:.4f} "
            f"ms ({by}, the true depth's work)  [{card}]")
        o, lse = fa.flash_attention_fwd(q, k, v)
        dy = torch.randn_like(o)
        kt, pt = _interleaved(
            torch, lambda: fa.flash_attention_bwd_reference(q, k, v, o, dy,
                                                            lse),
            lambda: fa.flash_attention_bwd(q, k, v, o, dy, lse), 5,
            queue_behind=True)
        ol = F.scaled_dot_product_attention(ql, kl, vl)
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            ol, (ql, kl, vl), dy.transpose(1, 2), retain_graph=True)
        lt = _device_busy_ms(_profile_once(
            torch, lambda: [lib_bwd() for _ in range(3)])) / 3
        bound, by = _attention_bound(B, T, T, H, D, 2, True)
        times[("bwd", B, T, H, D)] = dict(ms=kt, plain_ms=pt, library_ms=lt,
                                          bound_ms=bound, bound_by=by)
        log(f"[time] attention backward bf16 B={B} T={T} H={H} D={D}, "
            f"{route} ({cfg['path']}, {cfg['bwd']['rows']} keys a block): "
            f"kernel {kt:.4f} ms ({bound / kt:.1%} of the bound), plain "
            f"{pt:.4f} ms, scaled_dot_product_attention's autograd backward "
            f"{lt:.4f} ms of device kernels, bound {bound:.4f} ms ({by})  "
            f"[{card}]")
        del q, k, v, ql, kl, vl, o, lse, dy, ol
        torch.cuda.empty_cache()
    return times


def _time_mlp_wide(torch, card: str) -> dict:
    """mlp_block in bf16 at ViT-L's and ViT-H's widths over the lifter's
    8,200 rows, both directions: kernel, plain pair, the library's three
    calls ``F.linear → F.gelu → F.linear`` and their autograd backward (a
    yardstick: they write the hidden activation to device memory), and the
    bound of the counted operations (4·N·D·H forward, 10·N·D·H backward)."""
    import torch.nn.functional as F

    from pose3d_tpu_torch.ops.kernels import mlp_block as mb

    times = {}
    bf16 = torch.bfloat16
    for i, (N, D, H, _) in enumerate(MLP_WIDE[:2]):
        cfg = mb.launch_config(N, D, H, 2)
        t = _row_inputs(torch, N, D, H, bf16, 7100 + i)
        args = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"])
        kt, pt = _interleaved(torch, lambda: mb.mlp_block_fwd_reference(
            *args), lambda: mb.mlp_block_fwd(*args), 5)
        xl = t["x"].clone().requires_grad_()
        lw1 = t["w1"].t().contiguous().requires_grad_()
        lw2 = t["w2"].t().contiguous().requires_grad_()
        lb1 = t["b1"].to(bf16).requires_grad_()
        lb2 = t["b2"].to(bf16).requires_grad_()
        with torch.no_grad():
            lt = _time_ms(torch, lambda: F.linear(F.gelu(F.linear(
                xl, lw1, lb1)), lw2, lb2), 5)
        nbytes = (2 * N * D + 2 * D * H) * 2 + (H + D) * 4
        bound, by = _bound(nbytes, 4 * N * D * H, PEAK_BF16)
        times[("mlp_fwd", N, D, H)] = dict(ms=kt, plain_ms=pt, library_ms=lt,
                                           bound_ms=bound, bound_by=by)
        log(f"[time] mlp_block forward bf16 N={N} D={D} H={H} ({cfg['path']}"
            f", {cfg['slices']} column slices of {cfg['cols']}, each "
            f"recomputing x·w1: {2 * (1 + cfg['slices'])}·N·D·H executed for "
            f"4·N·D·H counted): kernel {kt:.4f} ms ({bound / kt:.1%} of the "
            f"bound), plain {pt:.4f} ms, F.linear -> F.gelu -> F.linear "
            f"{lt:.4f} ms, bound {bound:.4f} ms ({by})  [{card}]")
        kt, pt = _interleaved(
            torch, lambda: mb.mlp_block_bwd_reference(*args, t["dy"]),
            lambda: mb.mlp_block_bwd(*args, t["dy"]), 3)
        out = F.linear(F.gelu(F.linear(xl, lw1, lb1)), lw2, lb2)
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            out, (xl, lw1, lb1, lw2, lb2), t["dy"], retain_graph=True)
        lt = _device_busy_ms(_profile_once(
            torch, lambda: [lib_bwd() for _ in range(3)])) / 3
        nbytes = (3 * N * D + 2 * D * H) * 2 + H * 4 + (2 * D * H + H + D) * 4
        bound, by = _bound(nbytes, 10 * N * D * H, PEAK_BF16)
        times[("mlp_bwd", N, D, H)] = dict(ms=kt, plain_ms=pt, library_ms=lt,
                                           bound_ms=bound, bound_by=by)
        log(f"[time] mlp_block backward bf16 N={N} D={D} H={H} "
            f"({cfg['path']}, dx over {cfg['dx']['blocks']} blocks, dW over "
            f"{cfg['dw']['blocks']}): kernel {kt:.4f} ms ({bound / kt:.1%} of "
            f"the bound), plain {pt:.4f} ms, the three calls' autograd "
            f"backward {lt:.4f} ms of device kernels, bound {bound:.4f} ms "
            f"({by})  [{card}]")
        del t, args, xl, lw1, lw2, lb1, lb2, out
        torch.cuda.empty_cache()
    return times


def phase_contracts(torch, card: str) -> dict:
    """The kernels at the shapes their TPU kernels take beyond the built
    ones (phase 3b of the module docstring): attention at every head depth
    up to 256 through the padded route, ``mlp_block`` up to ViT-H's width
    (``MLP_WIDE`` runs in phase 3's row-op check), bf16 ``lane_resample``,
    the refusals past the limits, one full-width ``transformer_heads=8``
    training step, and the times of the new shapes."""
    failures = []
    worst = _check_padded_attention(torch, failures)
    worst_lr = _check_lane_resample_bf16(torch, failures)
    _check_mlp_refusal(torch, failures)
    if failures:
        raise SystemExit(f"kernel disagrees with its plain version: "
                         f"{failures}")
    launches = _heads8_step(torch)
    times = {**_time_padded_attention(torch, card),
             **_time_mlp_wide(torch, card)}
    calls = _path_lane_calls(torch, 100, 500, 500, 4000)
    x, a, o, order = calls[0]
    times.update(_time_lane_call(torch, x.to(torch.bfloat16), a, o, order, 1,
                                 card))
    del calls, x, a, o
    torch.cuda.empty_cache()
    return {"worst": worst, "worst_lr_bf16": worst_lr,
            "heads8_launches": launches, "times": times}


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
    from pose3d_tpu_torch.ops.kernels import bn_stats as bn
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
            # one launch a call, on the plan the Python mirror computes
            one, seen = _one_launch(torch, lambda: bn_stats(x),
                                    "bn_stats_kernel")
            plans = [(bn.launch_config(n, C, dtype.itemsize, al),
                      bn.library_config(n, C, dtype.itemsize, al))
                     for al in (True, False)]
            ok &= one and all(a == b for a, b in plans)
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
            cfg = plans[0][0]
            log(f"[kernel] bn_stats {name:8s} n={n:6d} C={C:4d}: "
                f"max|d(s1,s2)|/max(1,|ref|)="
                + ",".join(f"{e:.2e}" for e in errs)
                + f" (tol {TOL_BN:.0e}); repeats bitwise, backward equal; "
                f"grid {cfg['tiles']}x{cfg['blocks']} as the library plans "
                f"it; launches a call {seen}  {'ok' if ok else 'FAIL'}")
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
        shapes = [(r, ROW_WIDTH) for r in ROW_COUNTS] + LN_RAGGED \
            + [(TRAIN_ROWS, ROW_WIDTH)]
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
            one, seen = _one_launch(
                torch, lambda: ln.layer_norm_fwd(x, scale, bias, 1e-6),
                "layer_norm_fwd")
            plans = [(ln.fwd_launch_config(rows, C, dtype.itemsize, al),
                      ln.fwd_library_config(rows, C, dtype.itemsize, al))
                     for al in (True, False)]
            same_plan = all(a == b for a, b in plans)
            cfg = plans[0][0]
            log(f"[kernel] layer_norm_fwd {label}: {cfg['blocks']} blocks "
                f"({cfg['blocks_per_sm']} an SM), {cfg['rows_per_warp']} "
                f"rows a warp, the library's plan "
                f"{'the same' if same_plan else 'DIFFERS'}; launches a call "
                f"{seen}  {'ok' if one and same_plan else 'FAIL'}")
            if not (one and same_plan):
                failures.append(("layer_norm_fwd", label, "launches/plan"))
            grads = ln.layer_norm_bwd(x, scale, refs[1], refs[2], dy)
            torch.cuda.synchronize()
            again = ln.layer_norm_bwd(x, scale, refs[1], refs[2], dy)
            brefs = ln.layer_norm_bwd_reference(x, scale, refs[1], refs[2],
                                                dy)
            held("layer_norm_bwd", label, ("dx", "dscale", "dbias"), grads,
                 again, brefs, (TOL_LN[name], TOL_LN_STATS, TOL_LN_STATS),
                 (dtype, f32, f32))
            one, seen = _one_launch(
                torch, lambda: ln.layer_norm_bwd(x, scale, refs[1], refs[2],
                                                 dy), "layer_norm_bwd")
            plans = [(ln.launch_config(rows, C, dtype.itemsize, al),
                      ln.library_config(rows, C, dtype.itemsize, al))
                     for al in (True, False)]
            same_plan = all(a == b for a, b in plans)
            log(f"[kernel] layer_norm_bwd {label}: {plans[0][0]['blocks']} "
                f"blocks, the library's plan "
                f"{'the same' if same_plan else 'DIFFERS'}; launches a call "
                f"{seen}  {'ok' if one and same_plan else 'FAIL'}")
            if not (one and same_plan):
                failures.append(("layer_norm_bwd", label, "launches/plan"))
            del grads, again, brefs
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
                     f"{cfg['path']:6s} G={cfg['groups']}"
                     + (f" padded to {cfg['padded']}"
                        if cfg["padded"] != (D, H) else "")
                     + (f" {cfg['slices']} column slices of {cfg['cols']}"
                        if cfg["slices"] > 1 else ""))
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
    """The port's HTTP server on a free local port for a ``.pth`` (or, with
    ``artifact``, an exported artifact directory), healthy on entry (its
    URL), shut down and joined on exit."""

    def __init__(self, pth, artifact: bool = False):
        self.pth = pth
        self.artifact = artifact

    def __enter__(self) -> str:
        from pose3d_tpu_torch.serve_http import (
            make_artifact_server,
            make_server,
        )

        self.srv = (make_artifact_server(self.pth, "127.0.0.1", 0,
                                         max_batch=8) if self.artifact
                    else make_server(self.pth, "127.0.0.1", 0, device="cuda",
                                     max_batch=8))
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

    def plain_fwd(q, k, v):
        # in place of the launch behind the forward's custom operator
        return tuple(t.contiguous()
                     for t in flash_attention_fwd_reference(q, k, v))

    plain = runs[bf16, "reference"][1]
    iso = one_step(bf16, "auto", _launch_fwd=plain_fwd)[1]
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


def _profile_once(torch, fn, tries: int = 3, host: bool = True):
    """``torch.profiler``'s averaged rows of one synchronised call. Now and
    then a trace records no kernel at all; the call is then traced again,
    up to ``tries`` times (the caller's check of an empty trace stays).
    ``host=False`` traces the card's kernels and copies alone, without the
    host's operators: a step of thousands of launches (the scan CNN's) then
    takes seconds to trace, not half a minute."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host else []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=activities
                     + [ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
        if any(_is_kernel(e) for e in rows):
            break
    return rows


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
                         torch, lambda: step(st, sb, gen, aug_gen),
                         host=False)),
                     plain_busy=_device_busy_ms(_profile_once(
                         torch, lambda: bare(st, sb, gen, aug_gen),
                         host=False)))
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
    busy = _device_busy_ms(_profile_once(
        torch, lambda: ra["step"](ra["st"], ra["sb"], ra["gen"]),
        host=False))
    log(f"[time] CNN train step, {A}x{B} batch_pallas scan: device kernels "
        f"{busy:.1f} ms of the {ra['step_ms']:.1f} ms step (torch.profiler, "
        f"one step; the rest is the card waiting for the host's launches)  "
        f"[{card}]")
    out.update(launches=ra["launches"]["bn_stats"], scan_ms=ra["step_ms"],
               scan_peak=ra["peak"], scan_busy=busy)

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
    tot = dict(ms=0.0, bound=0.0, library=0.0)
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
        calls = shapes.count((n, C))
        tot["ms"] += calls * kt
        tot["bound"] += calls * bound
        tot["library"] += calls * lt
        log(f"[time] bn_stats bf16 n={n} C={C} (x{calls} per "
            f"forward): kernel {kt:.4f} ms ({nbytes / kt / 1e6:.0f} GB/s, "
            f"{bound / kt:.0%} of the bound), "
            f"plain {pt:.4f} ms, torch.batch_norm_stats (mean and 1/sigma, "
            f"not the same function) {lt:.4f} ms, bound {bound:.4f} ms "
            f"(bytes)  [{card}]")
        del xs, x
    share = tot["bound"] / tot["ms"]
    log(f"[time] bn_stats over one microbatch forward of the CNN "
        f"({len(shapes)} calls, sum of calls x ms): kernel {tot['ms']:.4f} "
        f"ms against a bound of {tot['bound']:.4f} ms ({share:.0%}), "
        f"torch.batch_norm_stats {tot['library']:.4f} ms; "
        f"a scan 10x10 step's 10 microbatches: {10 * tot['ms']:.3f} ms "
        f"against {10 * tot['bound']:.3f}  [{card}]")
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


def _lane_resample_bytes(torch, a, o, w: int, order: int,
                         itemsize: int = 4) -> int:
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
    return int(itemsize * (touched.sum().item() + n * w) + 8 * n)


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
    size = x.element_size()
    copies = max(1, min(64, -(-(256 << 20) // (n * w * size))))
    xs = [x.clone() for _ in range(copies)]
    turn = [0]

    def nxt():
        turn[0] = (turn[0] + 1) % copies
        return xs[turn[0]]
    kt, pt = _interleaved(
        torch, lambda: lane_resample_reference(nxt(), a, o, order),
        lambda: lane_resample(nxt(), a, o, order), 20, queue_behind=True)
    lt, lib = None, "no library call of the same function"
    if order == 1 and x.dtype == torch.float32:
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
    nbytes = _lane_resample_bytes(torch, a, o, w, order, size)
    flop = (16 if order == 1 else 7) * n * w
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flop / PEAK_FP32 * 1e3
    bound = max(t_bytes, t_ops)
    dtype = str(x.dtype).removeprefix("torch.")
    log(f"[time] lane_resample {dtype} order {order} N={n} W={w}, pass "
        f"{which} of the two-pass warp (|a| {a.abs().min().item():.2f} to "
        f"{a.abs().max().item():.2f}; {nbytes / 1e6:.0f} MB needed of "
        f"{(2 * n * w * size + 8 * n) / 1e6:.0f} if every row were read "
        f"whole): kernel {kt:.4f} ms ({nbytes / kt / 1e6:.0f} GB/s, "
        f"{bound / kt:.0%} of the bound), plain {pt:.4f} ms, {lib}, bound "
        f"{bound:.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})  [{card}]")
    key = ("lr", n, w, order, which) + ((dtype,) if size != 4 else ())
    return {key: dict(ms=kt, plain_ms=pt, library_ms=lt, bound_ms=bound,
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
        log(f"[time] layer_norm backward bf16 rows={rows} C={C} (one "
            f"launch a call: the rows, then dscale and dbias added across "
            f"the blocks in it): kernel {kt:.4f} ms ({nbytes / kt / 1e6:.0f} GB/s, "
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


# --- the training CLI on chunk files (pose3d_tpu_torch.cli) ----------------

FIXTURE = ROOT / "tests" / "torch_port_fixtures"
# The committed fixture's pixels were decoded at their stored size by the
# native decoder (libjpeg's integer IDCT): the depth PNG must come back
# equal from any route, a JPEG within one level of it (another libjpeg
# build, or a route without DCT scaling, rounds its IDCT or upsampling
# differently by at most one level on these smooth images).
TOL_JPEG_LEVELS = 1
CLI_STEPS = 4           # the CNN: stopped after step 2, resumed to step 4
CLI_EVAL = 2            # --eval-interval of the CNN and transformer runs
CLI_TF_STEPS = 2
CLI_SCAN_STEPS = 1
TOL_CLI_EVAL = 1e-4     # cli.evaluate against an in-process evaluate
FEED_STEPS, FEED_WINDOW = 9, 3  # train_model runs of the host-feed times


class _CliWriter(_Scalars):
    """The recording writer handed to the CLI's ``train_model``."""

    def add_image(self, *a, **k):
        pass

    def add_text(self, *a, **k):
        pass

    def close(self):
        pass


def _cli_decode(card: str) -> str:
    """Decode the fixture's committed samples at their stored size through
    the route this machine has, and hold them against the committed
    pixels; time a 500 x 500 decode of a whole chunk."""
    from pose3d_tpu_torch.data import chunks, native

    route = native.decode_route()
    why = native.build_error()
    if route == "cv2":
        import cv2

        route_text = (f"cv2 {cv2.__version__} (the native library did not "
                      f"build: {why.splitlines()[0] if why else '?'})")
    else:
        route_text = f"native ({native.library_path().relative_to(ROOT)})"
    want = np.load(FIXTURE / "pixels.npz")
    files = [str(f) for f in want["image_file"]]
    store = chunks.open_chunk_store(
        FIXTURE / "train" / "dataset_chunk_000000.tar.gz", mode="stream")
    samples = sorted((s for s in store.samples if s["image_file"] in files),
                     key=lambda s: files.index(s["image_file"]))
    hw = tuple(want["image"].shape[1:3])
    recs = chunks.decode_chunk_samples(samples, store, hw,
                                       pixel_dtype="uint8")
    got_img = np.stack([r["image"] for r in recs]).astype(np.int16)
    got_dep = np.stack([r["depth"] for r in recs]).astype(np.int16)
    d_img = int(np.abs(got_img - want["image"]).max())
    d_dep = int(np.abs(got_dep - want["depth"]).max())
    ok = (len(recs) == len(files) and d_dep == 0
          and d_img <= TOL_JPEG_LEVELS)
    ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        full = chunks.decode_chunk_samples(store.samples, store, (500, 500),
                                           pixel_dtype="uint8")
        ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[cli] decode route: {route_text}; the fixture's {len(files)} "
        f"committed samples at {hw[0]}x{hw[1]}: JPEG max |d| {d_img} levels "
        f"(tol {TOL_JPEG_LEVELS}), PNG max |d| {d_dep} (tol 0)  "
        f"{'ok' if ok else 'FAIL'}")
    per = (f"{'/'.join(f'{t:.1f}' for t in ms)} ms = "
           f"{min(ms) / len(full):.2f}-{max(ms) / len(full):.2f} ms a sample")
    log(f"[time] host decode of one chunk ({len(full)} samples, "
        f"{store.samples[0]['image_size'][1]}x"
        f"{store.samples[0]['image_size'][0]} JPEG + depth PNG → 500x500 "
        f"uint8, {route}): {per} (this fixture's small sources, not "
        f"Human3.6M's 1000x1000)  [{card}]")
    if not ok:
        raise SystemExit("the decode route does not give the committed "
                         "pixels")
    return route


def _run_cli(torch, cli_main, argv, cwd: Path, stop_after=None) -> dict:
    """``cli.main.main(argv)`` in ``cwd``; its ``train_model`` gets a
    recording writer, the launch counts are zeroed just before it and read
    just after. ``stop_after``: SIGTERM to this process right after the
    checkpoint of that step is written (the CLI's handler then stops the
    run at the next step, as a preemption would)."""
    import os
    import signal

    from pose3d_tpu_torch.train import loop

    cwd.mkdir(parents=True, exist_ok=True)
    rec = {}
    real_train, real_save = cli_main.train_model, loop.ckpt.save_checkpoint

    def train(state, *a, **kw):
        rec.update(start_step=kw["start_step"], data_state=kw["data_state"],
                   writer=_CliWriter())
        kw["writer"] = rec["writer"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        t0 = time.perf_counter()
        out = real_train(state, *a, **kw)
        torch.cuda.synchronize()
        rec.update(launches=launch_counts(), wall=time.perf_counter() - t0,
                   peak=torch.cuda.max_memory_allocated() / 2 ** 30)
        return out

    def save(path, *a, **kw):
        out = real_save(path, *a, **kw)
        if stop_after is not None and str(path).endswith(
                f"_step_{stop_after}"):
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    here = os.getcwd()
    os.chdir(cwd)
    try:
        with mock.patch.object(cli_main, "train_model", train), \
                mock.patch.object(loop.ckpt, "save_checkpoint", save):
            rec["last_step"] = cli_main.main(argv)
    finally:
        os.chdir(here)
    tags = rec["writer"].tags
    rec["losses"] = [v for _, v in tags.get("Loss/train_step", [])]
    rec["val"] = dict(tags.get("Metrics/MPJPE_validation_epoch_avg", []))
    return rec


def _checkpoints(cwd: Path, model_type: str) -> dict:
    from pose3d_tpu_torch.core.config import GlobalConfig
    from pose3d_tpu_torch.train import checkpoint as ckpt

    prefix = str(cwd / GlobalConfig().checkpoint_prefix)
    best = ckpt.best_checkpoint_path(prefix, model_type)
    return {"steps": [s for s, _ in ckpt._sibling_checkpoints(prefix,
                                                              model_type)],
            "best": json.loads(best.read_text()) if best.exists() else None,
            "path": lambda step: ckpt.checkpoint_path(prefix, model_type,
                                                      step)}


def _cli_cnn(torch, cli_main, tmp: Path, card: str) -> dict:
    """The full-width CNN through the CLI with rotation: a run stopped by
    SIGTERM after step 2's checkpoint, then the same command line resumed
    to step 4 from ``--checkpoint auto``."""
    from pose3d_tpu_torch.core.config import GlobalConfig
    from pose3d_tpu_torch.train import checkpoint as ckpt

    g = GlobalConfig()
    cwd = tmp / "cli_cnn"
    argv = ["--chunks-dir", str(FIXTURE), "--device", "cuda",
            "--model-type", "cnn", "--batch-size", str(g.batch_size),
            "--grad-accum", str(g.gradient_accumulation_steps),
            "--pixel-dtype", "uint8", "--augment-device",
            "--augment-device-rotation", "--eval-interval", str(CLI_EVAL),
            "--keep-checkpoints", "1", "--no-tensorboard",
            "--num-steps", str(CLI_STEPS), "--log-interval", "1",
            "--checkpoint", "auto", "--cache-dir", str(tmp / "cli_cache")]
    first = _run_cli(torch, cli_main, argv, cwd, stop_after=CLI_EVAL)
    saved = _checkpoints(cwd, "cnn")
    meta2 = ckpt.load_checkpoint_meta(saved["path"](CLI_EVAL))
    second = _run_cli(torch, cli_main, argv, cwd)
    after = _checkpoints(cwd, "cnn")
    vals = {**first["val"], **second["val"]}
    best_step = min(sorted(vals), key=lambda s: vals[s])
    want_lane = {**dict.fromkeys(KERNELS, 0), "lane_resample": 4 * CLI_EVAL}
    checks = {
        "stopped at step 2 by SIGTERM": (first["last_step"] == CLI_EVAL
                                          and first["start_step"] == 0),
        "a checkpoint at step 2 with its data_state": (
            CLI_EVAL in saved["steps"] and "data_state" in meta2),
        "resumed at step 2 with the saved data_state": (
            second["start_step"] == CLI_EVAL
            and second["data_state"] == meta2["data_state"]),
        "ran to step 4": second["last_step"] == CLI_STEPS,
        "best = lowest validation MPJPE": (
            after["best"] is not None and after["best"]["step"] == best_step),
        "retention keeps the newest and the best": (
            after["steps"] == sorted({CLI_STEPS, best_step})),
        "lane_resample 4 a step, no other kernel": (
            first["launches"] == want_lane
            and second["launches"] == want_lane),
        "finite losses at every step": (
            len(first["losses"] + second["losses"]) == CLI_STEPS
            and np.isfinite(first["losses"] + second["losses"]).all()),
    }
    log(f"[cli] (a) CNN 500x500 from the CLI, 10x10 grouped, rotation on: "
        f"run 1 stopped at step {first['last_step']} "
        f"({first['wall']:.1f} s, losses {first['losses']}), run 2 resumed "
        f"at step {second['start_step']} with data_state "
        f"{second['data_state']} (saved: {meta2.get('data_state')}) to step "
        f"{second['last_step']} ({second['wall']:.1f} s, losses "
        f"{second['losses']}); validation MPJPE {vals}; checkpoints left "
        f"{after['steps']}, best {after['best'] and after['best']['step']}; "
        f"launches {first['launches']['lane_resample']} + "
        f"{second['launches']['lane_resample']} lane_resample; peak "
        f"{max(first['peak'], second['peak']):.2f} GiB")
    for what, ok in checks.items():
        log(f"[cli] (a) {what}: {'ok' if ok else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("the CNN from the CLI failed a check")
    return {"cwd": cwd, "best": after["best"], "launches": {
        k: first["launches"][k] + second["launches"][k] for k in KERNELS}}


def _cli_transformer(torch, cli_main, tmp: Path) -> dict:
    """Two grouped 10 x 10 steps of the full transformer from the CLI, a
    validation at step 2: 20 forward launches a pass (train and
    validation batches), 20 backward launches a step."""
    from pose3d_tpu_torch.core.config import GlobalConfig

    g = GlobalConfig()
    B = g.batch_size
    rec = _run_cli(torch, cli_main, [
        "--chunks-dir", str(FIXTURE), "--device", "cuda",
        "--model-type", "transformer", "--batch-size", str(B),
        "--grad-accum", str(g.gradient_accumulation_steps),
        "--eval-interval", str(CLI_EVAL), "--num-steps", str(CLI_TF_STEPS),
        "--no-tensorboard", "--log-interval", "1", "--checkpoint", "auto",
        "--cache-dir", str(tmp / "cli_cache")], tmp / "cli_transformer")
    n_val = sum(int(np.ceil(n / B)) for n in _fixture_counts("test"))
    attn = sum(PASS_LAUNCHES.values())
    want = {**dict.fromkeys(KERNELS, 0),
            "flash_attention_fwd": attn * (CLI_TF_STEPS + n_val),
            "flash_attention_bwd": attn * CLI_TF_STEPS}
    ok = (rec["last_step"] == CLI_TF_STEPS and rec["launches"] == want
          and len(rec["losses"]) == CLI_TF_STEPS
          and np.isfinite(rec["losses"]).all() and bool(rec["val"]))
    log(f"[cli] (b) transformer 512x512 from the CLI, 10x10 grouped: "
        f"{rec['last_step']} steps in {rec['wall']:.1f} s, losses "
        f"{rec['losses']}, validation MPJPE {rec['val']}; launches "
        f"{rec['launches']} (want {attn} forward a pass over "
        f"{CLI_TF_STEPS} train + {n_val} validation batches, {attn} "
        f"backward a step); peak {rec['peak']:.2f} GiB  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the transformer from the CLI failed a check")
    return rec["launches"]


def _cli_scan(torch, cli_main, tmp: Path) -> dict:
    """The full-width CNN with ``normalization="batch_pallas"`` in the scan
    mode from the CLI: ``bn_stats`` once per BatchNorm per microbatch."""
    from pose3d_tpu_torch.core.config import GlobalConfig

    g = GlobalConfig()
    A, B = g.gradient_accumulation_steps, g.batch_size
    rec = _run_cli(torch, cli_main, [
        "--chunks-dir", str(FIXTURE), "--device", "cuda",
        "--model-type", "cnn", "--model-args",
        json.dumps({"normalization": "batch_pallas"}),
        "--accum-mode", "scan", "--batch-size", str(B), "--grad-accum",
        str(A), "--eval-interval", "1000", "--num-steps",
        str(CLI_SCAN_STEPS), "--no-tensorboard", "--log-interval", "1",
        "--checkpoint", "auto", "--cache-dir", str(tmp / "cli_cache")],
        tmp / "cli_scan")
    n_bn = len(_bn_path_shapes(torch, B))
    want = {**dict.fromkeys(KERNELS, 0),
            "bn_stats": n_bn * A * CLI_SCAN_STEPS}
    ok = (rec["last_step"] == CLI_SCAN_STEPS and rec["launches"] == want
          and np.isfinite(rec["losses"]).all())
    log(f"[cli] (c) CNN batch_pallas scan from the CLI: {rec['last_step']} "
        f"step in {rec['wall']:.1f} s, losses {rec['losses']}; launches "
        f"{rec['launches']} (want {n_bn} BatchNorms x {A} microbatches x "
        f"{CLI_SCAN_STEPS})  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the scan CNN from the CLI failed a check")
    return rec["launches"]


def _fixture_counts(prefix: str) -> list:
    from pose3d_tpu_torch.data.chunks import (
        count_chunk_samples,
        list_chunk_files,
    )

    return [count_chunk_samples(f) for f in list_chunk_files(FIXTURE, prefix)]


def _cli_evaluate(torch, cnn: dict) -> None:
    """``cli.evaluate --per-action`` on the CNN's best checkpoint against an
    in-process ``evaluate`` of the same restored state."""
    import contextlib as _ctx
    import io as _io

    from pose3d_tpu_torch.cli import evaluate as cli_eval
    from pose3d_tpu_torch.core.config import GlobalConfig, make_model_config
    from pose3d_tpu_torch.data.pipeline import (
        BatchLoader,
        StreamingChunkedDataset,
    )
    from pose3d_tpu_torch.models import build_model
    from pose3d_tpu_torch.train import checkpoint as ckpt, loop
    from pose3d_tpu_torch.train.state import create_train_state
    from pose3d_tpu_torch.train.step import make_eval_step

    g = GlobalConfig()
    path = Path(cnn["best"]["path"])
    out = _io.StringIO()
    with _ctx.redirect_stdout(out):
        got = cli_eval.main(["--checkpoint", str(path), "--chunks-dir",
                             str(FIXTURE), "--per-action", "--device",
                             "cuda"])
    printed = json.loads(out.getvalue().strip().splitlines()[-1])
    meta = ckpt.load_checkpoint_meta(path)
    cfg = make_model_config(meta["model_type"], **meta["model_args"])
    model = build_model(cfg, device="cuda",
                        dtype=getattr(torch, g.compute_dtype), train=True)
    st, _ = ckpt.restore_train_state(create_train_state(model), path)
    ds = StreamingChunkedDataset("test", str(FIXTURE),
                                 image_size=tuple(cfg.image_size),
                                 shuffle=False, shuffle_chunks=False,
                                 pixel_dtype="uint8")
    want = loop.evaluate(make_eval_step(), st,
                         BatchLoader(ds, g.batch_size, drop_last=False),
                         per_action=True)
    errs = {k: abs(got[k] - want[k]) / abs(want[k])
            for k in ("mpjpe", "pa_mpjpe")}
    ok = (max(errs.values()) <= TOL_CLI_EVAL and printed == got
          and set(got["per_action"]) == set(want["per_action"])
          and got["checkpoint_step"] == cnn["best"]["step"])
    log(f"[cli] (d) cli.evaluate --per-action on the best checkpoint (step "
        f"{got['checkpoint_step']}): MPJPE {got['mpjpe']:.4f}, PA-MPJPE "
        f"{got['pa_mpjpe']:.4f} mm, {len(got['per_action'])} actions; an "
        f"in-process evaluate of the restored state {want['mpjpe']:.4f} / "
        f"{want['pa_mpjpe']:.4f} (relative {errs['mpjpe']:.1e} / "
        f"{errs['pa_mpjpe']:.1e}, tol {TOL_CLI_EVAL:.0e})  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("cli.evaluate disagrees with evaluate")


def _sync_feed(iterator, device, depth: int = 2):
    """The port's host feed before the device prefetch: each superbatch
    copied from pageable memory on the step's stream when the step needs
    it, nothing read ahead."""
    from pose3d_tpu_torch.train import loop

    for b in iterator:
        yield {**loop.to_device(b, device),
               **{k: v for k, v in b.items() if k.startswith("_")}}


def _cli_host_feed(torch, tmp: Path, card: str) -> dict:
    """``train_model``'s ``Perf/step_time_ms`` (log windows of
    ``FEED_WINDOW`` steps after the first) with the device prefetch and with
    the synchronous feed, in turns, from in-memory numpy batches; the bare
    grouped step on a device-resident superbatch; the CNN from the chunk
    pipeline; and a checkpoint save of each model."""
    from pose3d_tpu_torch.core.config import (
        CNNModelConfig,
        GlobalConfig,
        TransformerModelConfig,
    )
    from pose3d_tpu_torch.data.pipeline import (
        BatchLoader,
        StreamingChunkedDataset,
    )
    from pose3d_tpu_torch.models import build_model
    from pose3d_tpu_torch.train import checkpoint as ckpt, loop, \
        state as tstate, step as tstep

    g = GlobalConfig()
    A, B = g.gradient_accumulation_steps, g.batch_size
    out = {}
    for cfg in (CNNModelConfig(), TransformerModelConfig()):
        name = cfg.model_type
        hw, J = tuple(cfg.image_size), cfg.num_joints
        model = build_model(cfg, device="cuda", dtype=torch.bfloat16,
                            train=True,
                            generator=torch.Generator("cuda").manual_seed(0))
        st = tstate.create_train_state(model, ema=True)

        def run(loader, feed, epochs=1):
            w = _Scalars()
            ctx = (contextlib.nullcontext() if feed == "prefetch" else
                   mock.patch.object(loop, "_device_prefetch", _sync_feed))
            with ctx:
                loop.train_model(
                    st, loader, writer=w, gradient_accumulation_steps=A,
                    num_steps=st.step + FEED_STEPS, max_epochs=epochs,
                    log_interval_steps=FEED_WINDOW,
                    eval_interval_steps=10 ** 9,
                    preview_interval_steps=10 ** 9, ema_decay=0.999)
            return [v for _, v in w.tags["Perf/step_time_ms"]]

        # in memory before the runs: the feed's own work is all they time
        batches = list(_train_batches(50, A * FEED_STEPS, B, hw, J))
        times = {"prefetch": [], "sync": []}
        for feed in ("prefetch", "sync", "sync", "prefetch"):
            times[feed] += run(iter(batches), feed)
        del batches
        sb = loop.to_device(next(loop._superbatches(
            _train_batches(60, A, B, hw, J), A)), "cuda")
        step = tstep.make_train_step(ema_decay=0.999)
        gen = torch.Generator("cuda").manual_seed(1)
        bare = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(st, sb, gen)
            torch.cuda.synchronize()
            bare.append((time.perf_counter() - t) * 1e3)
        bare = bare[1:]
        del sb
        chunks_ms = None
        if name == "cnn":
            ds = StreamingChunkedDataset(
                "train", str(FIXTURE), image_size=hw,
                cache_dir=tmp / "feed_cache", pixel_dtype="uint8")
            # a looping loader: the epoch cap is the stream's own counter
            chunks_ms = run(BatchLoader(ds, B, loop=True), "prefetch",
                            epochs=10 ** 6)
        torch.cuda.synchronize()
        t = time.perf_counter()
        saved = ckpt.save_checkpoint(tmp / f"save_{name}", st, name,
                                     cfg.to_dict())
        save_ms = (time.perf_counter() - t) * 1e3
        size = (saved / "state.pt").stat().st_size
        out[name] = dict(**times, bare=bare, chunks=chunks_ms,
                         save_ms=save_ms, save_bytes=size)
        fmt = lambda xs: "/".join(f"{x:.1f}" for x in xs)  # noqa: E731
        log(f"[time] host feed, {name} 10x10 grouped, train_model's "
            f"Perf/step_time_ms over windows of {FEED_WINDOW} steps: device "
            f"prefetch {fmt(times['prefetch'])} ms, synchronous copy "
            f"(the port before it) {fmt(times['sync'])} ms, the bare step "
            f"on a device-resident superbatch {fmt(bare)} ms"
            + (f"; from the chunk pipeline (decode, collate, prefetch) "
               f"{fmt(chunks_ms)} ms" if chunks_ms else "")
            + f"  [{card}]")
        log(f"[time] checkpoint save, {name} (model, AdamW moments, EMA): "
            f"{save_ms:.0f} ms for {size / 2 ** 20:.0f} MiB  [{card}]")
        shutil.rmtree(saved, ignore_errors=True)
        del st, model, step, gen
        torch.cuda.empty_cache()
    return out


def phase_cli(torch, tmp: Path, card: str) -> dict:
    """The training path from the shell: the decode route, the CNN from
    ``cli.main`` stopped and resumed, the transformer, the scan CNN with
    ``bn_stats``, ``cli.evaluate``, and the host feed's times."""
    from pose3d_tpu_torch.cli import main as cli_main

    torch.cuda.empty_cache()
    route = _cli_decode(card)
    cnn = _cli_cnn(torch, cli_main, tmp, card)
    torch.cuda.empty_cache()
    tf = _cli_transformer(torch, cli_main, tmp)
    torch.cuda.empty_cache()
    scan = _cli_scan(torch, cli_main, tmp)
    torch.cuda.empty_cache()
    _cli_evaluate(torch, cnn)
    torch.cuda.empty_cache()
    feed = _cli_host_feed(torch, tmp, card)
    launches = {k: cnn["launches"][k] + tf[k] + scan[k] for k in KERNELS}
    return {"route": route, "launches": launches, "feed": feed}


# --- phase 11: the data path from the shell ----------------------------------

# Frames per subject of the synthetic Human3.6M layout: the train subjects
# give 300 samples, three 10 x 10 steps in one epoch; the test subjects 20.
DATA_FRAMES = {1: 60, 5: 60, 6: 60, 7: 60, 8: 60, 9: 10, 11: 10}
DATA_TRAIN, DATA_TEST = (1, 5, 6, 7, 8), (9, 11)
DATA_HW = (1000, 1000)  # Human3.6M's frame size (height, width)
DATA_CHUNK = 100        # samples an archive: chunker, splitter, shuffler
# Steps of each training run from the shuffled archives: 4 steps are the
# first epoch of the 300 train samples and one step of the second, as many
# steps after the first epoch as the script's time limit leaves to read.
# The step time read is the one after the first epoch (step 4): by then
# the read-ahead of up to two archives, filled while step 1 builds, is
# spent, and each step waits on the feed.
DATA_STEPS, DATA_WARM = 4, 3
# batch_pallas:N: at 500 x 500 the stem and stage 1 have 250² and 125²
# pixels a sample, stage 2 63², stage 3 32²: N = 4000 leaves the stem and
# stage 1 on the kernel and puts stage 2 and after under the gate.
DATA_GATE = 4000
AUG_TIMED = 40          # samples PoseAugmentor is timed over


def _smooth_u8(rng, hw, channels: int) -> np.ndarray:
    """A smooth seeded uint8 field of ``hw``: a 12 x 12 draw resized with
    cubic interpolation (a JPEG of it stays small, unlike noise)."""
    import cv2

    small = rng.integers(0, 256, (12, 12, channels), dtype=np.uint8)
    big = cv2.resize(small, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
    return big.reshape(*hw, channels) if channels > 1 else big


def _write_raw_layout(root: Path, frames: dict, hw) -> int:
    """A synthetic preprocessed Human3.6M layout: per frame a JPEG, an
    8-bit depth PNG and a metadata JSON (YOLO-style keypoints, depth range)
    from stage 1, and per subject the three annotation JSONs (data,
    camera, joint_3d). Returns the number of frames."""
    import cv2

    rng = np.random.default_rng(20)
    ann, imgs, proc = root / "annotations", root / "images", root / "processed"
    ann.mkdir(parents=True)
    h, w = hw
    jobs = []
    for subject, n in frames.items():
        images, annotations, joints, cameras = [], [], {}, {}
        for cam in (1, 2):
            a = rng.uniform(-0.3, 0.3)
            R = [[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                 [-np.sin(a), 0.0, np.cos(a)]]
            cameras[str(cam)] = {"R": R, "t": rng.normal(0, 50, 3).tolist(),
                                 "f": [1145.0, 1143.8], "c": [512.5, 515.4]}
        for i in range(n):
            action, cam = 2 + i % 3, 1 + i % 2
            folder = (f"s_{subject:02d}_act_{action:02d}_subact_01_"
                      f"ca_{cam:02d}")
            stem = f"{folder}_{i:06d}"
            (imgs / folder).mkdir(parents=True, exist_ok=True)
            (proc / folder).mkdir(parents=True, exist_ok=True)
            kpts = rng.uniform(0.2, 0.8, (17, 2)) * [w, h]
            meta = {"image_size": [w, h],
                    "keypoints": [[{"x": float(x), "y": float(y),
                                    "confidence": 0.9} for x, y in kpts]],
                    "depth_min": 1.5, "depth_max": 7.5}
            (proc / folder / f"{stem}.json").write_text(json.dumps(meta))
            jobs.append((imgs / folder / f"{stem}.jpg",
                         proc / folder / f"{stem}_depth.png",
                         int(rng.integers(1 << 30))))
            img_id = subject * 100000 + i
            images.append({"id": img_id, "file_name": f"{folder}/{stem}.jpg",
                           "action_idx": action, "subaction_idx": 1,
                           "frame_idx": i, "cam_idx": cam,
                           "subject": subject, "width": w, "height": h})
            annotations.append({"image_id": img_id, "bbox": [0, 0, w, h]})
            joints.setdefault(str(action), {}).setdefault("1", {})[str(i)] = (
                rng.normal(0, 250, (17, 3)) + [0, 0, 5000]).tolist()
        for name, blob in (("data", {"images": images,
                                     "annotations": annotations}),
                           ("camera", cameras), ("joint_3d", joints)):
            (ann / f"Human36M_subject{subject}_{name}.json").write_text(
                json.dumps(blob))

    def write(job):
        jpg, png, seed = job
        r = np.random.default_rng(seed)
        if not (cv2.imwrite(str(jpg), _smooth_u8(r, hw, 3))
                and cv2.imwrite(str(png), _smooth_u8(r, hw, 1))):
            raise SystemExit(f"cv2 could not write {jpg}")

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(write, jobs))
    return len(jobs)


def _data_tool(name: str, argv, cwd: Path) -> tuple:
    """``python -m pose3d_tpu_torch.cli.<name> argv`` in a process of its
    own: (seconds, standard output); a non-zero exit fails the phase."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", f"pose3d_tpu_torch.cli.{name}", *argv],
        cwd=cwd, env={**os.environ, "PYTHONPATH": str(ROOT)},
        capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    if out.returncode:
        log(out.stderr[-4000:])
        raise SystemExit(f"cli.{name} exited {out.returncode}")
    return dt, out.stdout


def _archive_samples(d: Path) -> list:
    """(subject, action, frame, camera) of every sample of every archive
    under ``d``, in archive order, and the number of archives."""
    from pose3d_tpu_torch.data import chunks

    keys, tars = [], sorted(d.glob("*.tar.*"))
    for tar in tars:
        for s in chunks.open_chunk_store(tar, mode="stream").samples:
            keys.append((s["subject"], s["action"], s["frame_idx"],
                         s["cam_idx"]))
    return keys, len(tars)


def _data_tools(tmp: Path, card: str) -> Path:
    """Raw layout → ``cli.chunker`` → ``cli.split`` → ``cli.rechunker``,
    each checked; returns the training directory (``train/`` the shuffled
    set, ``test/`` the test split)."""
    root = tmp / "h36m"
    t0 = time.perf_counter()
    n = _write_raw_layout(root, DATA_FRAMES, DATA_HW)
    log(f"[data] raw layout: {n} frames of {DATA_HW[1]}x{DATA_HW[0]} JPEG + "
        f"8-bit depth PNG + keypoint JSON, subjects {list(DATA_FRAMES)}, "
        f"written in {time.perf_counter() - t0:.1f} s "
        f"({sum(f.stat().st_size for f in root.rglob('*') if f.is_file()) / 2**20:.1f} MiB)")
    flow = tmp / "flow"
    flow.mkdir()
    times = {}
    times["chunker"], _ = _data_tool("chunker", [
        "--subjects", *map(str, DATA_FRAMES), "--output", "chunks",
        "--chunk-size", str(DATA_CHUNK),
        "--annotations-path", str(root / "annotations"),
        "--images-path", str(root / "images"),
        "--processed-path", str(root / "processed")], tmp)
    times["split"], said = _data_tool("split", [
        "--input-dir", "chunks", "--output-dir", "split",
        "--train-subjects", ",".join(map(str, DATA_TRAIN)),
        "--test-subjects", ",".join(map(str, DATA_TEST)),
        "--new-chunk-size", str(DATA_CHUNK)], tmp)
    times["rechunker"], _ = _data_tool("rechunker", [
        "--input-dir", "split/train", "--output-dir", str(flow / "train"),
        "--chunk-size", str(DATA_CHUNK), "--seed", "3"], tmp)
    (flow / "test").symlink_to(tmp / "split" / "test")
    chunked, n_chunks = _archive_samples(tmp / "chunks")
    train, n_train = _archive_samples(tmp / "split" / "train")
    test, n_test = _archive_samples(tmp / "split" / "test")
    shuffled, n_shuf = _archive_samples(flow / "train")
    want = {s: sum(DATA_FRAMES[k] for k in subs)
            for s, subs in (("train", DATA_TRAIN), ("test", DATA_TEST))}
    checks = {
        f"the chunker wrote all {n} frames in {n_chunks} archives": (
            len(chunked) == n and len(set(chunked)) == n and n_chunks > 1),
        f"the split holds {want['train']} train and {want['test']} test "
        "samples": (len(train), len(test)) == (want["train"], want["test"]),
        "routing by subject exact": (
            {k[0] for k in train} == set(DATA_TRAIN)
            and {k[0] for k in test} == set(DATA_TEST)
            and sorted(train + test) == sorted(chunked)),
        "the shuffled set equals the train split, in another order": (
            sorted(shuffled) == sorted(train) and shuffled != train),
    }
    log(f"[data] cli.split said {said.strip()!r}; archives: chunker "
        f"{n_chunks}, train {n_train}, test {n_test}, shuffled {n_shuf}")
    for what, ok in checks.items():
        log(f"[data] {what}: {'ok' if ok else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("the data tools failed a check")
    for name, samples in (("chunker", n), ("split", n),
                          ("rechunker", len(train))):
        log(f"[time] cli.{name} (its own process, interpreter start "
            f"included): {times[name]:.2f} s for {samples} samples = "
            f"{samples / times[name]:.1f} samples/s  [{card}]")
    return flow


def _time_host_augment(flow: Path, card: str) -> None:
    """``PoseAugmentor``'s ms per sample on 500 x 500 uint8 samples decoded
    from the shuffled archives, on this host's CPU."""
    from pose3d_tpu_torch.data import augment, chunks

    tar = sorted((flow / "train").glob("*.tar.*"))[0]
    store = chunks.open_chunk_store(tar, mode="stream")
    recs = chunks.decode_chunk_samples(store.samples[:AUG_TIMED], store,
                                       (500, 500), pixel_dtype="uint8")
    aug = augment.PoseAugmentor(seed=0)
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        outs = [aug(r) for r in recs]
        ms.append((time.perf_counter() - t0) * 1e3 / len(recs))
    ok = all(o["image"].shape == (500, 500, 3) and o["image"].dtype
             == np.float32 and np.isfinite(o["joints_3d"]).all()
             for o in outs)
    log(f"[time] host PoseAugmentor (flip, rotation, scale, translate, "
        f"colour; cv2 on one thread) at 500x500 from uint8: "
        f"{'/'.join(f'{t:.2f}' for t in ms)} ms a sample over {len(recs)} "
        f"samples  [{card}]")
    if not ok:
        raise SystemExit("PoseAugmentor gave a bad sample")


def _time_host_feed(flow: Path, card: str) -> None:
    """The host feed alone, no step: one epoch of the shuffled archives
    through ``StreamingChunkedDataset`` + ``BatchLoader`` at 500 x 500 in
    batches of 10, without and with the host augmentor, one after the
    other: the least time a 10 x 10 step fed from these archives can
    take."""
    from pose3d_tpu_torch.data.pipeline import (
        BatchLoader,
        StreamingChunkedDataset,
    )

    ms = {False: [], True: []}
    for augment in (False, True):
        ds = StreamingChunkedDataset("train", str(flow),
                                     image_size=(500, 500),
                                     pixel_dtype="uint8",
                                     use_augmentation=augment)
        ds.training = True
        t0 = time.perf_counter()
        n = sum(len(b["image"]) for b in BatchLoader(ds, 10))
        ms[augment].append((time.perf_counter() - t0) / n * 100 * 1e3)
    for augment in (False, True):
        log(f"[time] host feed alone, {'with' if augment else 'without'} "
            f"PoseAugmentor: an epoch of {n} samples decoded from "
            f"{DATA_HW[1]}x{DATA_HW[0]} to 500x500 and collated, "
            f"{'/'.join(f'{t:.0f}' for t in ms[augment])} ms per 100 samples "
            f"(a 10x10 step's) in one epoch  [{card}]")


def _data_train(torch, cli_main, flow: Path, cwd: Path, model_type: str,
                augment: bool, extra=(), steps=None) -> dict:
    """``cli.main`` at 10 x 10 from the shuffled archives in ``cwd``; the
    CNN without validation, the transformer with one at its last step."""
    from pose3d_tpu_torch.core.config import GlobalConfig

    g = GlobalConfig()
    steps = steps or DATA_STEPS
    rec = _run_cli(torch, cli_main, [
        "--chunks-dir", str(flow), "--device", "cuda",
        "--model-type", model_type, "--batch-size", str(g.batch_size),
        "--grad-accum", str(g.gradient_accumulation_steps),
        "--pixel-dtype", "uint8", "--num-steps", str(steps),
        "--eval-interval", str(steps if model_type == "transformer"
                               else 1000),
        "--no-tensorboard", "--log-interval", "1",
        *(["--augment"] if augment else []), *extra], cwd)
    rec["step_ms"] = [v for s, v in rec["writer"].tags.get(
        "Perf/step_time_ms", []) if s > DATA_WARM]
    return rec


def _data_evaluate(torch, flow: Path, tmp: Path) -> dict:
    """``cli.evaluate`` on the test split from bare state_dicts of both
    full-width lifters: the CNN with no hint, the transformer with
    ``--model-type transformer`` (and refused as a CNN without it)."""
    import contextlib as _ctx
    import io as _io

    from pose3d_tpu_torch.cli import evaluate as cli_eval
    from pose3d_tpu_torch.core.config import (
        CNNModelConfig,
        TransformerModelConfig,
    )
    from pose3d_tpu_torch.models import build_model

    launches = dict.fromkeys(KERNELS, 0)
    n_val = int(np.ceil(sum(DATA_FRAMES[s] for s in DATA_TEST) / 10))
    for cfg in (CNNModelConfig(), TransformerModelConfig()):
        model = build_model(cfg, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(21))
        pth = tmp / f"bare_{cfg.model_type}.pth"
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, pth)
        del model
        torch.cuda.empty_cache()
        argv = ["--checkpoint", str(pth), "--chunks-dir", str(flow),
                "--device", "cuda"]
        refused = None
        if cfg.model_type == "transformer":
            try:
                cli_eval.main(argv)
            except ValueError as e:
                refused = str(e)
            argv += ["--model-type", "transformer"]
        out = _io.StringIO()
        zero_launch_counts()
        with _ctx.redirect_stdout(out):
            got = cli_eval.main(argv)
        counts = launch_counts()
        want = ({**dict.fromkeys(KERNELS, 0), "flash_attention_fwd":
                 sum(PASS_LAUNCHES.values()) * n_val}
                if cfg.model_type == "transformer"
                else dict.fromkeys(KERNELS, 0))
        ok = (np.isfinite([got["mpjpe"], got["pa_mpjpe"]]).all()
              and json.loads(out.getvalue().strip().splitlines()[-1]) == got
              and counts == want
              and (cfg.model_type == "cnn" or (
                  refused is not None and "cnn" in refused)))
        log(f"[data] cli.evaluate of a bare {cfg.model_type} state_dict "
            f"({'--model-type transformer' if refused else 'no hint'}) on "
            f"the test split: MPJPE {got['mpjpe']:.2f}, PA-MPJPE "
            f"{got['pa_mpjpe']:.2f} mm; launches {counts}"
            + (f"; without the hint: {refused[:90]!r}"
               if cfg.model_type == "transformer" else "")
            + f"  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("cli.evaluate of a bare state_dict failed")
        for k in KERNELS:
            launches[k] += counts[k]
    return launches


def _data_serve_batch_dot(torch, tmp: Path) -> None:
    """A ``normalization="batch_dot"`` CNN written as a ``.pth`` loads and
    ``serve_http`` answers one ``/predict`` with its eval forward."""
    from pose3d_tpu_torch.checkpoint import load_pose_model, save_pose_model
    from pose3d_tpu_torch.core.config import CNNModelConfig
    from pose3d_tpu_torch.models import build_model

    cfg = CNNModelConfig(normalization="batch_dot")
    model = build_model(cfg, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(22))
    pth = save_pose_model(model, tmp / "cnn_batch_dot.pth")
    del model
    loaded, lcfg = load_pose_model(pth, "cuda")
    req = _request_inputs(23, 2, tuple(cfg.image_size), cfg.num_joints)
    with torch.no_grad():
        direct = loaded(*[torch.from_numpy(a).cuda() for a in req]).float()
    del loaded
    torch.cuda.empty_cache()
    zero_launch_counts()
    with _serving(pth) as base:
        got = _post(base + "/predict", req)
        _, meta = _get(base + "/meta")
    rel = float(np.linalg.norm(got - direct.cpu().numpy())
                / np.linalg.norm(direct.cpu().numpy()))
    ok = (lcfg.normalization == "batch_dot" and got.shape == (2, 17, 3)
          and rel <= TOL_SLICE_REL_L2 and not any(launch_counts().values())
          and meta["artifact"]["model_type"] == "cnn")
    log(f"[data] batch_dot .pth loaded ({lcfg.normalization}) and served: "
        f"/predict {got.shape}, vs its eval forward rel L2 {rel:.3e} (tol "
        f"{TOL_SLICE_REL_L2:.0e})  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the batch_dot checkpoint does not serve")


def phase_data(torch, tmp: Path, card: str) -> dict:
    """The data path from the shell: a synthetic Human3.6M layout through
    ``cli.chunker``, ``cli.split`` and ``cli.rechunker``; the host
    augmentor's time; the full-width CNN and the transformer trained with
    ``--augment`` from the shuffled archives beside the same runs without
    it; a ``batch_pallas:N`` CNN in scan with its gate; ``cli.evaluate``
    from bare state_dicts; a ``batch_dot`` ``.pth`` served."""
    from pose3d_tpu_torch.cli import main as cli_main

    torch.cuda.empty_cache()
    flow = _data_tools(tmp, card)
    _time_host_augment(flow, card)
    _time_host_feed(flow, card)
    attn = sum(PASS_LAUNCHES.values())
    n_val = int(np.ceil(sum(DATA_FRAMES[s] for s in DATA_TEST) / 10))
    runs = {}
    for model_type in ("cnn", "transformer"):
        for augment in (True, False):
            rec = _data_train(torch, cli_main, flow,
                              tmp / f"data_{model_type}_{augment}",
                              model_type, augment)
            gc.collect()
            torch.cuda.empty_cache()
            steps = DATA_STEPS
            want = dict.fromkeys(KERNELS, 0)
            if model_type == "transformer":
                want.update(flash_attention_fwd=attn * (steps + n_val),
                            flash_attention_bwd=attn * steps)
            ok = (rec["last_step"] == steps and rec["launches"] == want
                  and len(rec["losses"]) == steps
                  and np.isfinite(rec["losses"]).all()
                  and (model_type == "cnn" or bool(rec["val"])))
            log(f"[data] {model_type} {'--augment' if augment else 'no augmentation'} "
                f"from the shuffled archives, 10x10 grouped: "
                f"{rec['last_step']} steps in {rec['wall']:.1f} s, losses "
                f"{rec['losses']}, validation {rec['val']}; launches "
                f"{rec['launches']}; peak {rec['peak']:.2f} GiB  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"the {model_type} from the shuffled "
                                 "archives failed a check")
            runs[model_type, augment] = rec
    for model_type in ("cnn", "transformer"):
        def fmt(xs):
            return (f"median {statistics.median(xs):.1f} ms (min "
                    f"{min(xs):.1f}, max {max(xs):.1f}, {len(xs)} steps)")

        log(f"[time] {model_type} 10x10 grouped from the shuffled archives "
            f"({DATA_HW[1]}x{DATA_HW[0]} JPEG decoded to the model's size by "
            f"the route of [cli]), train_model's Perf/step_time_ms of steps "
            f"{DATA_WARM + 1}-{DATA_STEPS}, after the first epoch: --augment "
            f"{fmt(runs[model_type, True]['step_ms'])}, without "
            f"{fmt(runs[model_type, False]['step_ms'])}  [{card}]")

    A = 10
    gate = f"batch_pallas:{DATA_GATE}"
    rec = _data_train(torch, cli_main, flow, tmp / "data_gate", "cnn", True,
                      extra=("--model-args",
                             json.dumps({"normalization": gate}),
                             "--accum-mode", "scan"), steps=1)
    per_sample = [n for n, _ in _bn_path_shapes(torch, 1)]
    over = sum(n >= DATA_GATE for n in per_sample)
    want = {**dict.fromkeys(KERNELS, 0), "bn_stats": over * A}
    ok = (rec["last_step"] == 1 and rec["launches"] == want
          and 0 < over < len(per_sample) and np.isfinite(rec["losses"]).all())
    log(f"[data] CNN {gate} in scan, --augment, one step: losses "
        f"{rec['losses']}; launches {rec['launches']} (want {over} of "
        f"{len(per_sample)} BatchNorms at or above {DATA_GATE} pixels a "
        f"sample x {A} microbatches)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the batch_pallas:N gate failed a check")
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in runs.values())
                + rec["launches"][k] for k in KERNELS}
    ev = _data_evaluate(torch, flow, tmp)
    _data_serve_batch_dot(torch, tmp)
    return {k: launches[k] + ev[k] for k in KERNELS}


# -- phase 12: export -----------------------------------------------------------

EXPORT_STEPS = 3        # the transformer from the CLI, with and without --remat
INFER_IMAGES, INFER_BATCH = 16, 8
INFER_HW = (1000, 1000)  # Human3.6M's frame size (height, width)
EXPORT_BATCHES = (1, 3, 8)
EXPORT_STATIC = 8
CNN_NORMS = ("identity", "instance", "layer", "group")
# a remat step against the plain step from the same state, masks and
# batch: the forward is the same arithmetic, so the loss must come out
# bitwise; the gradients differ by the order of the attention backward's
# dQ reductions only (7.8e-4 to 8.1e-4 whole-gradient relative L2 on the
# card), held to the attention backward's bound TOL_BWD_STEP_REL_L2. The
# loss cannot see a recomputation that draws other dropout masks, so every
# run also takes the step with a plain checkpoint, which redraws them from
# the generator, and fails unless that control lands beyond the bound.


def _remat_cli(torch, cli_main, tmp: Path, remat: bool) -> dict:
    """The full transformer from the CLI on the committed fixture, grouped
    10 x 10 with the published dropout, for ``EXPORT_STEPS`` steps, with or
    without ``--remat``; no validation."""
    from pose3d_tpu_torch.core.config import GlobalConfig

    g = GlobalConfig()
    return _run_cli(torch, cli_main, [
        "--chunks-dir", str(FIXTURE), "--device", "cuda",
        "--model-type", "transformer", "--batch-size", str(g.batch_size),
        "--grad-accum", str(g.gradient_accumulation_steps),
        "--eval-interval", str(10 ** 6), "--num-steps", str(EXPORT_STEPS),
        "--no-tensorboard", "--log-interval", "1",
        "--cache-dir", str(tmp / "cli_cache"), *(["--remat"] if remat else [])],
        tmp / f"export_remat_{int(remat)}")


def _remat_steps(torch, card: str) -> dict:
    """The bare grouped 10 x 10 step of the full transformer (published
    dropout, bf16) with and without remat, from the same seeded state,
    generator and device-resident superbatch: loss, whole gradient, launch
    counts, peak memory and step time."""
    from pose3d_tpu_torch.core.config import GlobalConfig, \
        TransformerModelConfig
    from torch.utils.checkpoint import checkpoint

    from pose3d_tpu_torch.models import build_model, transformer
    from pose3d_tpu_torch.ops.losses import LossWeights
    from pose3d_tpu_torch.train import loop, state as tstate, step as tstep

    def _redrawing_remat(fn, gen, *tensors):
        return checkpoint(fn, *tensors, use_reentrant=False,
                          preserve_rng_state=False)

    g = GlobalConfig()
    A, B = g.gradient_accumulation_steps, g.batch_size
    weights = LossWeights(g.mse_loss_weight, g.l1_loss_weight,
                          g.inter_joint_loss_weight, g.abs_root_loss_weight)
    cfg = TransformerModelConfig()
    hw, J = tuple(cfg.image_size), cfg.num_joints
    sb = loop.to_device(next(loop._superbatches(
        _train_batches(31, A, B, hw, J), A)), "cuda")
    runs = {}
    for remat in (False, True, "control"):
        gc.collect()
        torch.cuda.empty_cache()
        model = build_model(cfg, device="cuda", dtype=torch.bfloat16,
                            train=True, remat=bool(remat),
                            generator=torch.Generator("cuda").manual_seed(0))
        st = tstate.create_train_state(model, g.learning_rate,
                                       g.weight_decay)
        step = tstep.make_train_step(weights, accum_mode="grouped")
        gen = torch.Generator("cuda").manual_seed(g.random_seed + 5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        with (mock.patch.object(transformer, "_remat", _redrawing_remat)
              if remat == "control" else contextlib.nullcontext()):
            m = step(st, sb, gen)
        torch.cuda.synchronize()
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        grad = torch.cat([p.grad.flatten() for p in st.trainable()]).clone()
        if remat == "control":
            runs[remat] = dict(loss=m["total_loss"].item(), grad=grad)
            del model, st, step, m
            continue
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(st, sb, gen)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        runs[remat] = dict(loss=m["total_loss"].item(), grad=grad,
                           launches=launches, peak=peak, runs=ts,
                           ms=statistics.median(ts))
        del model, st, step, m
    del sb
    return runs


def _export_remat(torch, cli_main, tmp: Path, card: str) -> dict:
    attn = sum(PASS_LAUNCHES.values())
    plain_cli = _remat_cli(torch, cli_main, tmp, False)
    gc.collect()
    torch.cuda.empty_cache()
    remat_cli = _remat_cli(torch, cli_main, tmp, True)
    gc.collect()
    torch.cuda.empty_cache()
    for rec, remat in ((plain_cli, False), (remat_cli, True)):
        fwd = attn * (2 if remat else 1) * EXPORT_STEPS
        want = {**dict.fromkeys(KERNELS, 0), "flash_attention_fwd": fwd,
                "flash_attention_bwd": attn * EXPORT_STEPS}
        ms = [v for _, v in rec["writer"].tags.get("Perf/step_time_ms", [])]
        ok = (rec["last_step"] == EXPORT_STEPS and rec["launches"] == want
              and len(rec["losses"]) == EXPORT_STEPS
              and np.isfinite(rec["losses"]).all())
        log(f"[export] (a) transformer 512x512 from the CLI"
            f"{' --remat' if remat else ''}, 10x10 grouped, published "
            f"dropout: {rec['last_step']} steps in {rec['wall']:.1f} s, "
            f"losses {rec['losses']}; train_model's step times "
            f"{[round(t, 1) for t in ms]} ms; launches {rec['launches']} "
            f"(want {attn * (2 if remat else 1)} forward and {attn} backward "
            f"a pass); peak {rec['peak']:.2f} GiB  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the transformer from the CLI"
                             f"{' with --remat' if remat else ''} failed a "
                             "check")
    runs = _remat_steps(torch, card)
    p, r, c = runs[False], runs[True], runs["control"]
    dl = abs(r["loss"] - p["loss"]) / abs(p["loss"])
    rel, rel_c = (((x["grad"] - p["grad"]).double().norm()
                   / p["grad"].double().norm()).item() for x in (r, c))
    bitwise = torch.equal(r["grad"], p["grad"])
    want = {False: {"flash_attention_fwd": attn, "flash_attention_bwd": attn},
            True: {"flash_attention_fwd": 2 * attn,
                   "flash_attention_bwd": attn}}
    launches_ok = all(
        runs[m]["launches"] == {**dict.fromkeys(KERNELS, 0), **want[m]}
        for m in (False, True))
    ok = (launches_ok and np.isfinite(r["loss"])
          and (r["loss"] == p["loss"] or dl <= TOL_STEP_LOSS["bfloat16"])
          and rel <= TOL_BWD_STEP_REL_L2 < rel_c)
    log(f"[export] (a) bare grouped 10x10 step from one seeded state and "
        f"generator: remat loss {r['loss']!r} vs plain {p['loss']!r} "
        f"({'bitwise' if r['loss'] == p['loss'] else f'rel {dl:.2e}'}); "
        f"gradient rel L2 {rel:.3e} over {p['grad'].numel()} values "
        f"({'bitwise' if bitwise else 'not bitwise'}; tol "
        f"{TOL_BWD_STEP_REL_L2:.0e}); control, a plain checkpoint that "
        f"redraws the masks: loss {c['loss']!r}, gradient rel L2 "
        f"{rel_c:.3e} (must exceed the tol); launches remat "
        f"{ {k: v for k, v in r['launches'].items() if v} }, plain "
        f"{ {k: v for k, v in p['launches'].items() if v} }  "
        f"{'ok' if ok else 'FAIL'}")
    for name, x in (("plain", p), ("--remat", r)):
        log(f"[time] transformer train step, 10x10 grouped, published "
            f"dropout, bf16, {name}: {x['ms']:.1f} ms (median of "
            f"{'/'.join(f'{t:.1f}' for t in x['runs'])}) = "
            f"{100 / x['ms'] * 1e3:.1f} images/s on a device-resident "
            f"superbatch; peak memory {x['peak']:.2f} GiB  [{card}]")
    if not ok:
        raise SystemExit("the remat step disagrees with the plain step")
    del runs, p, r
    gc.collect()
    torch.cuda.empty_cache()
    return {k: plain_cli["launches"][k] + remat_cli["launches"][k]
            for k in KERNELS}


def _export_norms(torch, card: str) -> None:
    """One grouped 10 x 10 step of the full-width CNN with each per-sample
    normalisation after a first step: finite loss, step time, peak
    memory, and no kernel launched (the coordinate attention's BatchNorms
    are the plain ones)."""
    from pose3d_tpu_torch.core.config import CNNModelConfig, GlobalConfig
    from pose3d_tpu_torch.models import build_model
    from pose3d_tpu_torch.ops.losses import LossWeights
    from pose3d_tpu_torch.train import loop, state as tstate, step as tstep

    g = GlobalConfig()
    A, B = g.gradient_accumulation_steps, g.batch_size
    weights = LossWeights(g.mse_loss_weight, g.l1_loss_weight,
                          g.inter_joint_loss_weight, g.abs_root_loss_weight)
    base = CNNModelConfig()
    sb = loop.to_device(next(loop._superbatches(
        _train_batches(41, A, B, tuple(base.image_size), base.num_joints),
        A)), "cuda")
    for norm in CNN_NORMS:
        cfg = dataclasses.replace(base, normalization=norm)
        model = build_model(cfg, device="cuda", dtype=torch.bfloat16,
                            train=True,
                            generator=torch.Generator("cuda").manual_seed(1))
        st = tstate.create_train_state(model, g.learning_rate,
                                       g.weight_decay)
        step = tstep.make_train_step(weights, accum_mode="grouped")
        gen = torch.Generator("cuda").manual_seed(2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        ts, losses = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = step(st, sb, gen)
            losses.append(m["total_loss"].item())
            ts.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_bn = sum(1 for n, _ in model.named_buffers()
                   if n.endswith("running_mean"))
        ok = (np.isfinite(losses).all() and not any(launch_counts().values())
              and st.step == 2)
        log(f"[export] (b) CNN 500x500 normalization={norm!r}, 10x10 "
            f"grouped, bf16: losses {losses}, {n_bn} BatchNorms left (the "
            f"coordinate attention's), launches "
            f"{ {k: v for k, v in launch_counts().items() if v} or 'none'}  "
            f"{'ok' if ok else 'FAIL'}")
        log(f"[time] CNN train step, 10x10 grouped, normalization={norm!r}: "
            f"{ts[1]:.1f} ms ({100 / ts[1] * 1e3:.1f} images/s; the first "
            f"step {ts[0]:.1f} ms); peak memory {peak:.2f} GiB  [{card}]")
        if not ok:
            raise SystemExit(f"the CNN with {norm} failed a check")
        del model, st, step, m
        gc.collect()
        torch.cuda.empty_cache()
    del sb


def _write_infer_folder(root: Path) -> None:
    """``INFER_IMAGES`` smooth seeded 1000x1000 JPEG frames with their
    cached stage-1 artifacts: ``<stem>_depth.png`` and ``<stem>.json``
    (one person's 17 keypoints, the depth range)."""
    import cv2

    rng = np.random.default_rng(61)
    root.mkdir(parents=True)
    h, w = INFER_HW
    for i in range(INFER_IMAGES):
        stem = f"frame_{i:03d}"
        img = _smooth_u8(rng, INFER_HW, 3)
        cv2.imwrite(str(root / f"{stem}.jpg"), img)
        cv2.imwrite(str(root / f"{stem}_depth.png"),
                    _smooth_u8(rng, INFER_HW, 1))
        person = [{"x": float(rng.uniform(0.2, 0.8) * w),
                   "y": float(rng.uniform(0.2, 0.8) * h),
                   "conf": float(rng.uniform(0.3, 1.0))} for _ in range(17)]
        (root / f"{stem}.json").write_text(json.dumps({
            "image_size": [w, h], "keypoints": [person],
            "depth_min": float(rng.uniform(1.0, 2.0)),
            "depth_max": float(rng.uniform(4.0, 6.0))}))


class _Child:
    """``code`` started now in a fresh interpreter with the repository on
    its path, its output to files, while the caller goes on; ``result()``
    waits for it (killed at ``timeout`` seconds from its start): (the JSON
    object on the last line of its standard output, its standard error).
    ``seconds`` is then its wall time, start-up included. ``stop()`` kills
    it if it still runs."""

    def __init__(self, code: str, cwd: Path, timeout: int = 600):
        self.out, self.err = (tempfile.TemporaryFile("w+") for _ in "oe")
        self.t0, self.timeout = time.perf_counter(), timeout
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code], cwd=cwd,
            env={**os.environ, "PYTHONPATH": str(ROOT)}, stdout=self.out,
            stderr=self.err, text=True)

    def result(self) -> tuple:
        try:
            rc = self.proc.wait(max(1.0, self.t0 + self.timeout
                                    - time.perf_counter()))
        except subprocess.TimeoutExpired:
            self.stop()
            raise SystemExit(f"subprocess not done after {self.timeout} s")
        self.seconds = time.perf_counter() - self.t0
        self.out.seek(0)
        self.err.seek(0)
        out, err = self.out.read(), self.err.read()
        if rc != 0:
            raise SystemExit(f"subprocess failed ({rc}):\n{err[-4000:]}")
        return json.loads(out.strip().splitlines()[-1]), err

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _subprocess_json(code: str, cwd: Path, timeout: int = 600) -> tuple:
    """Run ``code`` in a fresh interpreter with the repository on its path:
    (the JSON object on the last line of its standard output, its standard
    error)."""
    return _Child(code, cwd, timeout).result()


def _export_infer_start(tmp: Path, pths: dict) -> dict:
    """``cli.infer`` on ``INFER_IMAGES`` cached 1000x1000 frames, at batch
    ``INFER_BATCH``, in its own process for each lifter, both started now:
    (model type, its process)."""
    folder = tmp / "infer_frames"
    _write_infer_folder(folder)
    children = {}
    for model_type, pth in pths.items():
        out_dir = tmp / f"infer_{model_type}"
        code = textwrap.dedent(f"""
            import json, sys
            from pose3d_tpu_torch.cli import infer
            from pose3d_tpu_torch.ops.kernels.flash_attention import (
                flash_attention_fwd)
            argv = ["--checkpoint_path", {str(pth)!r},
                    "--input_folder", {str(folder)!r},
                    "--output_folder", {str(out_dir)!r},
                    "--batch-size", "{INFER_BATCH}"]
            n = infer.main(argv)
            fwd = flash_attention_fwd.launches
            infer.main(argv)   # again, warm: the steady rate
            print(json.dumps({{"n": n, "fwd": fwd}}))
        """)
        children[model_type] = _Child(code, tmp)
    return children


def _export_infer(torch, tmp: Path, pths: dict, children: dict,
                  card: str) -> dict:
    """The ``cli.infer`` processes of ``_export_infer_start`` waited for;
    the saved joints against a direct forward (plain attention) on the
    same decompacted inputs."""
    import cv2

    from pose3d_tpu_torch.checkpoint import load_pose_model
    from pose3d_tpu_torch.cli.infer import compact_inputs
    from pose3d_tpu_torch.stage1 import CachedStage1
    from pose3d_tpu_torch.train.step import decompact_batch

    folder = tmp / "infer_frames"
    files = sorted(folder.glob("frame_*.jpg"))
    s1s = CachedStage1().predict(files)
    raws = [cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB)
            for f in files]
    launches = dict.fromkeys(KERNELS, 0)
    for model_type, pth in pths.items():
        out_dir = tmp / f"infer_{model_type}"
        child = children[model_type]
        res, err = child.result()
        wall = child.seconds
        rate = [ln for ln in err.splitlines()
                if "Inference processing complete" in ln]
        model, cfg = load_pose_model(pth, "cuda",
                                     attention_impl="reference")
        want = []
        with torch.inference_mode():
            for i in range(0, len(files), INFER_BATCH):
                batch = {k: torch.from_numpy(v).cuda() for k, v in
                         compact_inputs(raws[i:i + INFER_BATCH],
                                        s1s[i:i + INFER_BATCH],
                                        tuple(cfg.image_size)).items()}
                b = decompact_batch(batch)
                want.append(model(b["image"], b["depth"], b["keypoints_2d"])
                            .float().cpu().numpy())
        want = np.concatenate(want)
        got = np.stack([np.load(out_dir / f"{f.stem}_pred_joints3d.npy")
                        for f in files])
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        n_pass = -(-len(files) // INFER_BATCH)
        attn = sum(PASS_LAUNCHES.values())
        want_fwd = attn * n_pass if model_type == "transformer" else 0
        ok = (res["n"] == len(files) and res["fwd"] == want_fwd
              and len(rate) == 2
              and got.shape == want.shape and np.isfinite(got).all()
              and rel <= TOL_SLICE_REL_L2)
        log(f"[export] (c) cli.infer, {model_type} .pth, {len(files)} cached "
            f"{INFER_HW[1]}x{INFER_HW[0]} JPEG frames at batch {INFER_BATCH},"
            f" own process ({wall:.1f} s with start-up and load, the two "
            f"lifters' processes beside (a) and (b)): "
            f"{res['n']} joint files, forward launches {res['fwd']} (want "
            f"{want_fwd}); against a direct forward (plain attention) on "
            f"the same decompacted inputs rel L2 {rel:.3e} (tol "
            f"{TOL_SLICE_REL_L2:.0e})  {'ok' if ok else 'FAIL'}")
        runs = [r.split("complete: ")[-1] for r in rate]
        log(f"[time] cli.infer {model_type}, {len(files)} frames at batch "
            f"{INFER_BATCH}: first run in the process (CUDA context, "
            f"library handles, the lifter's first calls) {runs[0]}; the "
            f"same command again {runs[-1]}  [{card}]")
        if not ok:
            raise SystemExit(f"cli.infer of the {model_type} failed a check")
        launches["flash_attention_fwd"] += res["fwd"]
        del model
        torch.cuda.empty_cache()
    return launches


def _live_outputs(torch, model, batches, seed: int, hw, J) -> dict:
    with torch.inference_mode():
        return {b: model(*[torch.from_numpy(x).cuda() for x in
                           _request_inputs(seed + b, b, hw, J)])
                .float().cpu().numpy() for b in batches}


def _artifact_outputs(torch, program, batches, seed: int, hw, J,
                      static=None) -> dict:
    """The program's answers at each batch; a static program gets each
    batch padded with zeros to its size, its answers sliced back."""
    out = {}
    with torch.inference_mode():
        for b in batches:
            x = _request_inputs(seed + b, b, hw, J)
            if static is not None:
                x = [np.concatenate([a, np.zeros((static - b, *a.shape[1:]),
                                                 a.dtype)]) for a in x]
            y = program(*[torch.from_numpy(a).cuda() for a in x])
            out[b] = y.float().cpu().numpy()[:b]
    return out


def _export_artifacts(torch, tmp: Path, pths: dict, card: str) -> dict:
    """``cli.export`` of both lifters: dynamic ``xla``, the transformer
    with ``--attention-backend pallas``, ``--batch-size 8`` and
    ``--quantize int8``; each artifact against the live model at batches
    1, 3 and 8; the ``pallas`` graph's operator and its launches; the
    ``xla`` artifact loaded where ``pose3d_tpu_torch`` cannot be
    imported."""
    variants = {"xla": [], "pallas": ["--attention-backend", "pallas"],
                "static": ["--batch-size", str(EXPORT_STATIC)],
                "int8": ["--quantize", "int8"]}
    arts = {}
    launches = dict.fromkeys(KERNELS, 0)
    alone = []
    try:
        for model_type, pth in pths.items():
            _export_one(torch, tmp, pths, model_type, pth, variants, arts,
                        launches, alone, card)
        res, _ = alone[0].result()
    finally:
        for child in alone:
            child.stop()
    ok = (not res["loaded"]
          and all(v <= TOL_SLICE_REL_L2 for v in res["rel"].values()))
    log(f"[export] (d) the xla artifacts loaded by torch.export.load in a "
        f"process where pose3d_tpu_torch, pose3d_tpu and JAX cannot be "
        f"imported (started when both were written, beside the exports "
        f"after them): batch-3 answers against the live model rel L2 "
        f"{res['rel']}; of those packages in sys.modules: "
        f"{res['loaded'] or 'none'}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the xla artifact does not stand alone")
    return {"arts": arts, "launches": launches}


def _export_alone(tmp: Path, pths: dict, arts: dict) -> _Child:
    """The ``xla`` artifacts of both lifters loaded by
    ``torch.export.load`` in a process where ``pose3d_tpu_torch``,
    ``pose3d_tpu`` and JAX cannot be imported, started now: each one's
    batch-3 answer against the live model's (``xla_<model>.npz``)."""
    code = textwrap.dedent(f"""
        import importlib.abc, json, sys
        import numpy as np, torch
        BLOCKED = ("pose3d_tpu_torch", "pose3d_tpu", "jax", "jaxlib", "flax")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(name + " is blocked")
                return None

        sys.meta_path.insert(0, Block())
        out = {{}}
        for mt, path in {[(m, str(arts[m, "xla"] / "model.pt2"))
                          for m in pths]!r}:
            d = np.load(f"xla_{{mt}}.npz")
            x = [torch.from_numpy(d[f"arr_{{i}}"]).cuda() for i in range(3)]
            with torch.inference_mode():
                got = torch.export.load(path).module()(*x).float().cpu()
            want = d["want"]
            out[mt] = float(np.linalg.norm(got.numpy() - want)
                            / np.linalg.norm(want))
        print(json.dumps({{"rel": out, "loaded": sorted(
            m for m in sys.modules if m.split(".")[0] in BLOCKED)}}))
    """)
    return _Child(code, tmp)


def _export_one(torch, tmp: Path, pths: dict, model_type: str, pth: Path,
                variants: dict, arts: dict, launches: dict, alone: list,
                card: str) -> None:
    """``_export_artifacts`` for one lifter: each variant exported and
    checked into ``arts``, the ``pallas`` launches added to ``launches``;
    once both ``xla`` artifacts are written, ``_export_alone`` is started
    and its process put in ``alone``."""
    from pose3d_tpu_torch import serve
    from pose3d_tpu_torch.cli import export as cli_export
    from pose3d_tpu_torch.checkpoint import load_pose_model

    live, cfg = load_pose_model(pth, "cuda",
                                attention_impl="reference")
    hw, J = tuple(cfg.image_size), cfg.num_joints
    want = _live_outputs(torch, live, EXPORT_BATCHES, 70, hw, J)
    np.savez(tmp / f"xla_{model_type}.npz",
             *_request_inputs(73, 3, hw, J), want=want[3])
    deq = dict(serve.dequantize_variables(serve.quantize_variables(live)))
    live.load_state_dict(deq)
    want8 = _live_outputs(torch, live, EXPORT_BATCHES, 70, hw, J)
    del live, deq
    for name, extra in variants.items():
        if name == "pallas" and model_type != "transformer":
            continue
        path = tmp / f"art_{model_type}_{name}"
        t0 = time.perf_counter()
        cli_export.main(["--checkpoint", str(pth), "--output", str(path),
                         *extra])
        secs = time.perf_counter() - t0
        meta = serve.load_exported_meta(path)
        program = serve.load_exported(path).module()
        static = EXPORT_STATIC if name == "static" else None
        got = _artifact_outputs(torch, program, EXPORT_BATCHES, 70, hw, J,
                                static)
        ref = want8 if name == "int8" else want
        rels = {b: float(np.linalg.norm(got[b] - ref[b])
                         / np.linalg.norm(ref[b])) for b in got}
        extra_ok, note = True, ""
        if name == "pallas":
            x = [torch.from_numpy(a).cuda()
                 for a in _request_inputs(79, 8, hw, J)]
            zero_launch_counts()
            with torch.inference_mode():
                program(*x)
            torch.cuda.synchronize()
            n = launch_counts()["flash_attention_fwd"]
            attn = sum(PASS_LAUNCHES.values())
            extra_ok = (meta["custom_ops"]
                        == ["pose3d_torch::flash_attention_fwd"]
                        and n == attn)
            launches["flash_attention_fwd"] += n
            note = (f"; graph ops {meta['custom_ops']}, one batch-8 call "
                    f"launched the forward kernel {n} times (want {attn})")
        elif meta["custom_ops"]:
            extra_ok, note = False, f"; custom ops {meta['custom_ops']}"
        mib = meta["payload_bytes"] / 2 ** 20
        ok = (extra_ok and all(np.isfinite(got[b]).all() for b in got)
              and all(v <= TOL_SLICE_REL_L2 for v in rels.values()))
        on = " on the dequantised weights" if name == "int8" else ""
        log(f"[export] (d) cli.export {model_type} {name}: {mib:.1f} MiB "
            f"in {secs:.1f} s, inputs {meta['inputs'][0]}; against the "
            f"live model{on} rel L2 "
            f"{ {b: float(f'{v:.3e}') for b, v in rels.items()} } (tol "
            f"{TOL_SLICE_REL_L2:.0e}){note}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the {model_type} {name} artifact failed a "
                             "check")
        arts[model_type, name] = path
        del program
        torch.cuda.empty_cache()
        if not alone and all((m, "xla") in arts for m in pths):
            alone.append(_export_alone(tmp, pths, arts))
    mib = {v: serve.load_exported_meta(arts[model_type, v])[
        "payload_bytes"] / 2 ** 20 for v in ("xla", "int8")}
    log(f"[time] {model_type} artifact sizes: fp32 {mib['xla']:.1f} MiB, "
        f"int8 {mib['int8']:.1f} MiB ({mib['int8'] / mib['xla']:.3f} of "
        f"it)  [{card}]")


def _export_serve(torch, tmp: Path, arts: dict, card: str) -> dict:
    """``serve_http --artifact`` of the transformer's ``pallas`` artifact
    and its static-batch one: ``/predict`` at batch 1 and 8 timed, the
    static one padding a batch of 3 to its size; answers against the live
    model."""
    from pose3d_tpu_torch.checkpoint import load_pose_model
    from pose3d_tpu_torch.serve_http import _bucket

    live, cfg = load_pose_model(arts["pth"], "cuda",
                                attention_impl="reference")
    hw, J = tuple(cfg.image_size), cfg.num_joints
    want = _live_outputs(torch, live, (1, 3, 8), 90, hw, J)
    del live
    torch.cuda.empty_cache()
    attn = sum(PASS_LAUNCHES.values())
    launches = dict.fromkeys(KERNELS, 0)
    for name in ("pallas", "static"):
        zero_launch_counts()
        with _serving(arts["transformer", name], artifact=True) as base:
            got = {b: _post(base + "/predict",
                            _request_inputs(90 + b, b, hw, J))
                   for b in (1, 3, 8)}
            _, meta = _get(base + "/meta")
            latency = {}
            for b in (1, 8):
                a = _request_inputs(7, b, hw, J)
                ts = []
                for _ in range(10):
                    t = time.perf_counter()
                    _post(base + "/predict", a)
                    ts.append((time.perf_counter() - t) * 1e3)
                latency[b] = statistics.median(ts)
            _, meta2 = _get(base + "/meta")
        counts = launch_counts()
        calls = meta2["batching"]["device_calls"]
        rels = {b: float(np.linalg.norm(got[b] - want[b])
                         / np.linalg.norm(want[b])) for b in got}
        pads = meta["batching"]["samples_padded"]
        # the warmup's 1, then 1, 3 and 8, each in calls of at most 8,
        # padded to the static size or (dynamic) to a power of two
        static = EXPORT_STATIC if name == "static" else None
        want_pads = sum((static or _bucket(c, 8)) - c
                        for b in (1, 1, 3, 8)
                        for c in [min(8 if static is None else static,
                                      b - lo)
                                  for lo in range(0, b, static or 8)])
        want_fwd = attn * calls if name == "pallas" else 0
        ok = (all(v <= TOL_SLICE_REL_L2 for v in rels.values())
              and pads == want_pads
              and meta["batching"]["static_batch"] == static
              and meta["artifact"]["format"] == "pose3d_tpu_torch/export/v1"
              and counts["flash_attention_fwd"] == want_fwd)
        log(f"[export] (e) serve_http --artifact (transformer {name}): "
            f"/predict batches 1, 3, 8 against the live model rel L2 "
            f"{ {b: float(f'{v:.3e}') for b, v in rels.items()} }; padded "
            f"samples {pads} (want {want_pads}); /meta static_batch "
            f"{meta['batching']['static_batch']}; forward launches "
            f"{counts['flash_attention_fwd']} over {calls} device calls  "
            f"{'ok' if ok else 'FAIL'}")
        log(f"[time] /predict from the {name} artifact, median of 10: "
            f"batch 1 {latency[1]:.1f} ms, batch 8 {latency[8]:.1f} ms  "
            f"[{card}]")
        if not ok:
            raise SystemExit(f"serving the {name} artifact failed a check")
        launches["flash_attention_fwd"] += counts["flash_attention_fwd"]
    return launches


def phase_export(torch, tmp: Path, card: str) -> dict:
    """The transformer's ``--remat`` from the CLI and its bare step against
    the plain one; the CNN's four per-sample normalisations; ``cli.infer``
    on cached 1000x1000 frames; ``cli.export`` of both lifters; ``serve_http
    --artifact``. Returns the kernels' launches on these paths."""
    from pose3d_tpu_torch.checkpoint import save_pose_model
    from pose3d_tpu_torch.cli import main as cli_main
    from pose3d_tpu_torch.core.config import CNNModelConfig, \
        TransformerModelConfig
    from pose3d_tpu_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    pths = {}
    for cfg in (TransformerModelConfig(), CNNModelConfig()):
        model = build_model(cfg, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(81))
        pths[cfg.model_type] = Path(save_pose_model(
            model, tmp / f"export_{cfg.model_type}.pth"))
        del model
    torch.cuda.empty_cache()
    # (c)'s two processes run beside (a) and (b): a few forwards of their
    # own on the card, the rest start-up, decode and files
    children = _export_infer_start(tmp, pths)
    try:
        launches = _export_remat(torch, cli_main, tmp, card)
        _export_norms(torch, card)
        runs = [_export_infer(torch, tmp, pths, children, card)]
    finally:
        for child in children.values():
            child.stop()
    ex = _export_artifacts(torch, tmp, pths, card)
    runs.append(ex["launches"])
    runs.append(_export_serve(torch, tmp, {**ex["arts"],
                                           "pth": pths["transformer"]}, card))
    return {k: launches[k] + sum(r[k] for r in runs) for k in KERNELS}


# --- stage 1 ------------------------------------------------------------------

S1_YOLO_SCALE, S1_YOLO_SIZE = "x", 640      # YOLO11x-pose at 640
S1_DEPTH_SIZE = 1536                        # apple/DepthPro-hf at 1536²
S1_FRAMES = {"cam_a": 4, "cam_b": 4}        # 1000x1000 JPEG frames a folder
S1_HW = (1000, 1000)
S1_BATCH = 8                                # preprocess and cli.infer batch
S1_SERVE_BATCHES = (1, 8)
S1_TIMED = 3                                # timed forwards a setting
# relative L2, kernel against plain: fp32 (the CLIs' dtype, the scalar
# kernel) differs by summation order only; bf16 (wmma for the PSA pair,
# wgmma for Dinov2) rounds P and o to bf16, so it is the lifter's slice
# bound. A deliberately wrong attention (its output zeroed) must land
# beyond the bf16 bound.
TOL_S1 = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_S1_SERVE = 2e-2     # /predict_image against a direct provider + lifter


def _s1_init_(torch, model, gen) -> None:
    """Seeded weights for a random-weight run, on the model's device:
    convolutions and transposed convolutions N(0, 1/fan_in) (LeCun: the
    activations shrink a little a layer and stay finite through both
    networks in bf16), linear layers the same (unit-variance q and k, so
    that attention is not uniform and its output matters), biases 0;
    BatchNorm weight 1 + N(0, 0.1²), bias, running mean N(0, 0.1²),
    running variance U(0.5, 1.5); LayerNorm (1, 0); Dinov2's LayerScale
    0.1 and its class token and positions N(0, 0.02²)."""
    from torch import nn

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device) * std)

    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d)
                          else w.shape[1]) * (w[0, 0].numel()
                                              if w.dim() > 2 else 1)
                normal(w, fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif hasattr(m, "running_var"):
                normal(m.weight, 0.1)
                m.weight.add_(1.0)
                normal(m.bias, 0.1)
                normal(m.running_mean, 0.1)
                m.running_var.copy_(torch.rand(
                    m.running_var.shape, generator=gen,
                    device=m.running_var.device) + 0.5)
            elif hasattr(m, "lambda1"):
                m.lambda1.fill_(0.1)
            elif hasattr(m, "cls_token"):
                normal(m.cls_token, 0.02)
                normal(m.position_embeddings, 0.02)


def _write_safetensors(path: Path, tensors: dict) -> None:
    """A minimal ``.safetensors`` writer (F32): the 8-byte little-endian
    header length, the JSON header padded to 8 bytes, the raw tensors."""
    header, offset = {}, 0
    for k, t in tensors.items():
        n = t.numel() * 4
        header[k] = {"dtype": "F32", "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for t in tensors.values():
            f.write(t.detach().float().contiguous().cpu().numpy().data)


def _s1_calibrate_depth_head(torch, model, pixels) -> float:
    """Set the depth head's last bias so that the canonical inverse depth
    is positive (before its ReLU) for 97% of one forward's pixels, as a
    trained model's is; returns the bias."""
    head = model.head.layers[4]
    seen = []
    hook = head.register_forward_hook(lambda m, i, o: seen.append(o))
    with torch.inference_mode():
        model(pixels)
    hook.remove()
    q = float(torch.quantile(seen[0].float().flatten()[::97], 0.03))
    with torch.no_grad():
        head.bias.sub_(q)
    return -q


def _s1_write_weights(torch, tmp: Path, dev: str) -> dict:
    """YOLO11x-pose as a plain upstream-named state_dict ``.pt`` (with the
    ``num_batches_tracked`` and fixed DFL keys upstream files carry) and
    DepthPro at apple/DepthPro-hf's architecture as ``.safetensors`` (with
    its never-read mask tokens, no config.json: the architecture comes
    from the shapes), both with :func:`_s1_init_` weights from seeded
    generators; a full-width transformer lifter ``.pth``."""
    from pose3d_tpu_torch.checkpoint import save_pose_model
    from pose3d_tpu_torch.core.config import TransformerModelConfig
    from pose3d_tpu_torch.models import build_model
    from pose3d_tpu_torch.stage1.depthpro import DepthProDepthEstimator
    from pose3d_tpu_torch.stage1.yolo11 import YOLO11Pose

    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(131)
    with torch.device(dev):
        yolo = YOLO11Pose(S1_YOLO_SCALE)
    _s1_init_(torch, yolo, gen)
    sd = {k: v.cpu() for k, v in yolo.state_dict().items()}
    for k in [k for k in sd if k.endswith(".running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = \
            torch.tensor(0)
    sd["model.23.dfl.conv.weight"] = torch.arange(
        16, dtype=torch.float32).view(1, 16, 1, 1)
    paths = {"yolo": tmp / "yolo11x-pose.pt"}
    torch.save(sd, paths["yolo"])
    n_yolo = sum(p.numel() for p in yolo.parameters())
    del yolo, sd
    with torch.device(dev):
        dp = DepthProDepthEstimator().eval()
    _s1_init_(torch, dp, gen)
    pix = torch.rand(1, 3, S1_DEPTH_SIZE, S1_DEPTH_SIZE, generator=gen,
                     device=dev) * 2 - 1
    bias = _s1_calibrate_depth_head(torch, dp, pix)
    with torch.no_grad():
        dp.fov_model.head.layers[-1].bias.fill_(60.0)   # degrees
    sd = dict(dp.state_dict())
    D = dp.arch.vit.hidden_size
    for enc in ("depth_pro.encoder.patch_encoder", "depth_pro.encoder."
                "image_encoder", "fov_model.fov_encoder"):
        sd[f"{enc}.model.embeddings.mask_token"] = torch.zeros(1, D)
    n_dp = sum(p.numel() for p in dp.parameters())
    paths["depth"] = tmp / "depthpro" / "model.safetensors"
    paths["depth"].parent.mkdir()
    _write_safetensors(paths["depth"], sd)
    del dp, sd, pix
    lifter = build_model(TransformerModelConfig(), device=dev,
                         generator=torch.Generator(dev).manual_seed(132))
    paths["lifter"] = Path(save_pose_model(lifter, tmp / "s1_lifter.pth"))
    del lifter
    torch.cuda.empty_cache()
    log(f"[stage1] weights: YOLO11{S1_YOLO_SCALE}-pose {n_yolo / 1e6:.1f} M "
        f"params -> {paths['yolo'].name} "
        f"({paths['yolo'].stat().st_size / 1e6:.0f} MB); DepthPro "
        f"{n_dp / 1e6:.1f} M params -> .safetensors "
        f"({paths['depth'].stat().st_size / 1e9:.2f} GB, depth head bias "
        f"{bias:.3g}); transformer lifter .pth; "
        f"{time.perf_counter() - t0:.1f} s")
    return paths


def _s1_frames(root: Path) -> list:
    """``S1_FRAMES`` smooth seeded 1000x1000 JPEG frames in two folders."""
    import cv2

    rng = np.random.default_rng(141)
    files = []
    for name, n in S1_FRAMES.items():
        (root / name).mkdir(parents=True)
        for i in range(n):
            f = root / name / f"frame_{i:03d}.jpg"
            cv2.imwrite(str(f), _smooth_u8(rng, S1_HW, 3))
            files.append(f)
    return files


def _rgb(f: Path) -> np.ndarray:
    import cv2

    return cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB)


def _rel(a, b) -> float:
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _s1_inputs(torch, rgbs) -> tuple:
    """The two networks' input batches of ``rgbs`` as their backends make
    them: YOLO's letterboxed [B, 3, 640, 640] in [0, 1], DepthPro's
    [B, 3, 1536, 1536] in [-1, 1]."""
    import cv2

    from pose3d_tpu_torch.stage1.yolo11 import letterbox_params

    s = S1_YOLO_SIZE
    yb = np.full((len(rgbs), s, s, 3), 114 / 255.0, np.float32)
    for i, im in enumerate(rgbs):
        _, nw, nh, left, top = letterbox_params(*im.shape[:2], s)
        yb[i, top:top + nh, left:left + nw] = cv2.resize(
            im, (nw, nh), interpolation=cv2.INTER_LINEAR) / 255.0
    db = np.stack([cv2.resize(im, (S1_DEPTH_SIZE, S1_DEPTH_SIZE),
                              interpolation=cv2.INTER_LINEAR)
                   for im in rgbs]).astype(np.float32) / 255.0
    db = (db - 0.5) / 0.5
    return tuple(torch.from_numpy(x).cuda().permute(0, 3, 1, 2)
                 .contiguous() for x in (yb, db))


def _s1_flat(torch, out) -> np.ndarray:
    """A network's outputs as one fp64 vector: YOLO's raw heads, or
    DepthPro's canonical inverse depth (its FOV apart)."""
    if isinstance(out, list):
        return torch.cat([t.flatten() for lvl in out for t in lvl]).double() \
            .cpu().numpy()
    return out[0].double().flatten().cpu().numpy()


@contextlib.contextmanager
def _tf32(torch, matmul: bool, cudnn: bool):
    """The process-wide TF32 flags set for a block, restored after. The
    CLIs run with PyTorch's defaults (cuBLAS without TF32, cuDNN with it);
    the comparisons and fp32 times without it anywhere (as the rest of
    this script): a TF32 convolution rounds its inputs to 10 bits, which
    turns an fp32 attention's last-bit difference into ~5e-4 downstream."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


@contextlib.contextmanager
def _zeroed_attention(torch):
    """A deliberately wrong attention: every attention's output zeroed."""
    from pose3d_tpu_torch.stage1 import depthpro, yolo11

    def wrong(q, k, v, *, impl="auto"):
        return torch.zeros(q.shape[:3] + v.shape[3:], dtype=v.dtype,
                           device=v.device)

    with mock.patch.object(yolo11, "dot_product_attention", wrong), \
            mock.patch.object(depthpro, "dot_product_attention", wrong):
        yield


def _s1_attention_paths(torch, dtype_name: str, depth_b: int, yolo_b: int):
    """The kernel path the two stage-1 attention shapes take, from
    ``launch_config`` and from the built library, asserted: bf16 D = Dv =
    64 (Dinov2) ``wgmma``, bf16 (32, 64) (YOLO's PSA) ``wmma``, fp32
    ``scalar``."""
    from pose3d_tpu_torch.ops.kernels import flash_attention as fa

    item = 2 if dtype_name == "bfloat16" else 4
    out = {}
    for name, (B, T, H, D, Dv), want in (
            ("depthpro", (depth_b, 577, 16, 64, 64),
             "wgmma" if item == 2 else "scalar"),
            ("yolo", (yolo_b, 400, 6, 32, 64),
             "wmma" if item == 2 else "scalar")):
        py = fa.launch_config(B, T, T, H, D, Dv, item)["path"]
        lib = fa.library_config(B, T, T, H, D, Dv, item)["path"]
        if not py == lib == want:
            raise SystemExit(f"stage-1 {name} attention {dtype_name} "
                             f"{(B, T, H, D, Dv)}: launch_config {py}, "
                             f"library {lib}, want {want}")
        out[name] = want
    return out


def _s1_forward_ms(torch, model, x, iters: int) -> tuple:
    """(host-synced ms a forward, peak device memory GB) over ``iters``
    forwards after one warm-up."""
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3 / iters,
            torch.cuda.max_memory_allocated() / 1e9)


def _s1_networks(torch, provider, rgbs, card: str) -> None:
    """(a), (b) and (e) on the provider's two networks, fp32 then bf16,
    TF32 off: "pallas" against "xla" on the same weights and inputs
    (relative L2), a zeroed attention against the bf16 bound (bf16), the
    launches of one call of each, and the forward times at batch 1 and 2
    with peak memory."""
    nets = {"yolo": provider.kp_model, "depthpro": provider.depth_model}
    n_layers = provider.depth_model.arch.vit.num_layers
    want_launches = {"yolo": len(provider.kp_model.model[10].m),
                     "depthpro": 3 * n_layers}
    yx, dx = _s1_inputs(torch, rgbs[:2])
    xs = {"yolo": yx, "depthpro": dx}
    failures = []
    with _tf32(torch, False, False):
        _s1_compare(torch, nets, xs, want_launches, failures, card)
    if failures:
        raise SystemExit(f"stage-1 kernel against plain failed: {failures}")


def _s1_compare(torch, nets, xs, want_launches, failures, card) -> None:
    from pose3d_tpu_torch.stage1.yolo11 import (
        cast_for_inference,
        set_attention_backend,
    )

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        for name, model in nets.items():
            cast_for_inference(model, dtype)
        paths = _s1_attention_paths(torch, dn, 2 * 35, 2)
        for name, model in nets.items():
            x = xs[name]
            outs, counts = {}, {}
            for backend in ("xla", "pallas"):
                set_attention_backend(model, backend)
                zero_launch_counts()
                with torch.inference_mode():
                    out = model(x)
                torch.cuda.synchronize()
                counts[backend] = launch_counts()
                outs[backend] = out
            set_attention_backend(model, "xla")
            rel = _rel(_s1_flat(torch, outs["pallas"]),
                       _s1_flat(torch, outs["xla"]))
            fov = ""
            if name == "depthpro":
                frel = _rel(outs["pallas"][1].cpu(), outs["xla"][1].cpu())
                fov = f", FOV rel L2 {frel:.3e}"
                rel = max(rel, frel)
            finite = all(np.isfinite(_s1_flat(torch, o)).all()
                         for o in outs.values())
            n_p = counts["pallas"]["flash_attention_fwd"]
            other = sum(v for k, v in counts["pallas"].items()
                        if k != "flash_attention_fwd") + sum(
                counts["xla"].values())
            ok = (finite and rel <= TOL_S1[dn]
                  and n_p == want_launches[name] and other == 0)
            line = (f"[stage1] (a,b) {name} {dn} batch 2, \"pallas\" "
                    f"({paths[name]}) against \"xla\": rel L2 {rel:.3e}"
                    f"{fov} (tol {TOL_S1[dn]:.0e}); launches pallas {n_p} "
                    f"(want {want_launches[name]}), xla and other kernels "
                    f"{other}")
            if dn == "bfloat16":
                with _zeroed_attention(torch), torch.inference_mode():
                    ctl = _rel(_s1_flat(torch, model(x)),
                               _s1_flat(torch, outs["xla"]))
                ok = ok and ctl > TOL_S1["bfloat16"]
                line += (f"; control (attention zeroed) {ctl:.3e} (must "
                         f"exceed {TOL_S1['bfloat16']:.0e})")
            log(line + f"  {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{name} {dn}")
            del outs
            for b in (1, 2):
                for backend in ("xla", "pallas"):
                    set_attention_backend(model, backend)
                    ms, gb = _s1_forward_ms(torch, model, x[:b], S1_TIMED)
                    log(f"[time] stage1 {name} forward {dn} {backend} batch "
                        f"{b}: {ms:.1f} ms ({b * 1e3 / ms:.2f} images/s), "
                        f"peak {gb:.1f} GB  [{card}]")
                set_attention_backend(model, "xla")
            torch.cuda.empty_cache()


def _s1_attention_times(torch, card: str) -> None:
    """The forward kernel's device ms at the two stage-1 shapes (DepthPro's
    patch encoder at batch 2: B 70, 577 tokens, 16 heads, D 64; YOLO11x's
    PSA at batch 2: 400 tokens, 6 heads, D 32, Dv 64), both dtypes, beside
    the plain version, ``scaled_dot_product_attention`` (a yardstick,
    timed only) and the bound: the two products' FLOPs over the dtype's
    peak (bf16 tensor cores; fp32 outside them) against q, k, v read and
    o, lse written over the memory rate."""
    import torch.nn.functional as F

    from pose3d_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    for name, (B, T, H, D, Dv) in (("depthpro", (70, 577, 16, 64, 64)),
                                   ("yolo", (2, 400, 6, 32, 64))):
        for dtype, peak in ((torch.bfloat16, PEAK_BF16),
                            (torch.float32, PEAK_FP32)):
            g = torch.Generator("cuda").manual_seed(151)
            q, k = (torch.randn(B, T, H, D, generator=g, device="cuda")
                    .to(dtype) for _ in range(2))
            v = torch.randn(B, T, H, Dv, generator=g, device="cuda").to(dtype)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            with torch.inference_mode():
                kern, plain = _interleaved(
                    torch, lambda: flash_attention_fwd_reference(q, k, v),
                    lambda: flash_attention_fwd(q, k, v), 10,
                    queue_behind=True)
                lib = _time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt), 10, queue_behind=True)
                backend = _sdpa_backend(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt))
            item = q.element_size()
            flop = 2 * B * H * T * T * (D + Dv)
            nbytes = B * T * H * (2 * D + 2 * Dv) * item + B * H * T * 4
            bound, by = _bound(nbytes, flop, peak)
            log(f"[time] stage1 attention {name} {str(dtype)[6:]} "
                f"{(B, T, H, D, Dv)}: kernel {kern:.4f} ms, plain "
                f"{plain:.4f} ms, scaled_dot_product_attention ({backend}) "
                f"{lib:.4f} ms, bound {bound:.4f} ms ({by}; "
                f"{bound / kern:.0%} of it)  [{card}]")
            del q, k, v, qt, kt, vt


def _s1_host_split(torch, provider, files, card: str) -> None:
    """One preprocess batch's time, in the provider's pieces: decode (cv2), the host resizes alone (letterbox to 640, to
    1536), YOLO (its backend: letterbox, forward, decode) and DepthPro
    (its backend: resize, forward in micro-batches of 2, resize back,
    invert)."""
    import cv2

    from pose3d_tpu_torch.stage1.yolo11 import letterbox_params

    t0 = time.perf_counter()
    rgbs = [_rgb(f) for f in files]
    t1 = time.perf_counter()
    for im in rgbs:
        _, nw, nh, _, _ = letterbox_params(*im.shape[:2], S1_YOLO_SIZE)
        cv2.resize(im, (nw, nh), interpolation=cv2.INTER_LINEAR)
        cv2.resize(im, (S1_DEPTH_SIZE, S1_DEPTH_SIZE),
                   interpolation=cv2.INTER_LINEAR)
    t2 = time.perf_counter()
    parts = {"decode": t1 - t0, "host resize": t2 - t1}
    for name, backend in (("yolo", provider._kp), ("depthpro",
                                                   provider._depth)):
        torch.cuda.synchronize()       # warm: the references ran them
        t = time.perf_counter()
        for i in range(0, len(rgbs), S1_BATCH):
            backend.predict(rgbs[i:i + S1_BATCH])
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t
    total = parts["decode"] + parts["yolo"] + parts["depthpro"]
    log(f"[time] stage1 preprocess pieces over {len(files)} "
        f"{S1_HW[1]}x{S1_HW[0]} frames, fp32 \"xla\" (the CLI's), batches "
        f"of {S1_BATCH}: " + ", ".join(f"{k} {v * 1e3:.0f} ms"
                                       for k, v in parts.items())
        + f" (yolo and depthpro include their host resizes); "
        f"{len(files) / total:.2f} images/s  [{card}]")


def _s1_artifacts_agree(out: Path, files, want) -> str:
    """The preprocess artifacts of ``files`` against the provider's
    Stage1Results ``want``: pixel keypoints within 1 px, confidences
    within 1e-4, the depth PNG within one 8-bit level; keypoints in the
    frame, depth finite and positive at its size."""
    import cv2

    worst_px = worst_c = worst_lvl = 0.0
    for f, w in zip(files, want):
        d = out / f.parent.name
        meta = json.loads((d / f"{f.stem}.json").read_text())
        png = cv2.imread(str(d / f"{f.stem}_depth.png"),
                         cv2.IMREAD_UNCHANGED)
        h, wd = S1_HW
        if (meta["image_size"] != [wd, h] or png.shape != S1_HW
                or not (np.isfinite([meta["depth_min"], meta["depth_max"]])
                        .all() and meta["depth_min"] > 0)):
            raise SystemExit(f"preprocess artifact of {f} malformed")
        kp = meta["keypoints"][0]
        px = np.array([[k["x"], k["y"]] for k in kp], np.float64)
        conf = np.array([k["conf"] for k in kp])
        if not ((px >= 0) & (px <= [wd, h])).all():
            raise SystemExit(f"keypoints of {f} outside the frame")
        ref = np.round(w.keypoints[:, :2] * [wd, h])
        lo, hi = float(w.depth.min()), float(w.depth.max())
        ref_png = ((w.depth - lo) / (hi - lo if hi > lo else 1.0)
                   * 255.0).astype(np.uint8)
        worst_px = max(worst_px, float(np.abs(px - ref).max()))
        worst_c = max(worst_c, float(np.abs(conf - w.keypoints[:, 2]).max()))
        worst_lvl = max(worst_lvl, float(np.abs(png.astype(int)
                                                - ref_png.astype(int)).max()))
    ok = worst_px <= 1 and worst_c <= 1e-4 and worst_lvl <= 1
    msg = (f"against the provider's predict_batch: keypoints within "
           f"{worst_px:.0f} px, confidences {worst_c:.2e}, depth PNG "
           f"{worst_lvl:.0f} levels")
    if not ok:
        raise SystemExit("preprocess artifacts disagree " + msg)
    return msg


def _s1_preprocess(torch, tmp: Path, paths: dict, files, want,
                   card: str, beside=None) -> None:
    """(c): ``python -m pose3d_tpu_torch.cli.preprocess`` on the frames,
    the artifacts against the provider; a second run skips every folder
    (``finished.txt``); ``cli.infer --stage1 cached`` over the artifacts
    and ``cli.infer --stage1 jax`` with the weights, finite joints; both
    stage-1 CLIs again with ``--data-parallel`` (one replica a card: here
    one), their outputs against the runs without it. ``beside()``, when
    given, is called when the first run is done: what it starts runs
    beside the second process."""
    src, out = files[0].parent.parent, tmp / "s1_artifacts"
    argv = [str(src), str(out), "--kp-weights", str(paths["yolo"]),
            "--depth-weights", str(paths["depth"]),
            "--batch-size", str(S1_BATCH)]
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m",
                          "pose3d_tpu_torch.cli.preprocess", *argv],
                         cwd=tmp, env=env, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        raise SystemExit(f"preprocess failed:\n{run.stderr[-4000:]}")
    done = [ln.split("complete: ")[-1] for ln in run.stderr.splitlines()
            if "Preprocessing complete" in ln]
    log(f"[stage1] (c) cli.preprocess, {len(files)} {S1_HW[1]}x{S1_HW[0]} "
        f"JPEG frames in {len(S1_FRAMES)} folders, own process "
        f"({wall:.1f} s with start-up and weight loading): {done}; "
        + _s1_artifacts_agree(out, files, want) + "  ok")
    log(f"[time] stage1 cli.preprocess: {done[0] if done else '?'}  [{card}]")
    for f in files:                       # the cached provider reads beside
        shutil.copy(f, out / f.parent.name / f.name)
    if beside is not None:
        beside()
    one = out / files[0].parent.name
    code = textwrap.dedent(f"""
        import json
        from pose3d_tpu_torch.cli import infer, preprocess
        rerun = preprocess.main({argv!r})
        cached = infer.main(["--checkpoint_path", {str(paths['lifter'])!r},
                             "--input_folder", {str(one)!r},
                             "--output_folder", {str(tmp / 's1_cached')!r},
                             "--batch-size", "{S1_BATCH}"])
        def jax_infer(out, *extra):
            return infer.main(["--checkpoint_path", {str(paths['lifter'])!r},
                               "--input_folder",
                               {str(src / files[0].parent.name)!r},
                               "--output_folder", out, "--stage1", "jax",
                               "--kp-weights", {str(paths['yolo'])!r},
                               "--depth-weights", {str(paths['depth'])!r},
                               "--batch-size", "{S1_BATCH}", *extra])

        jax = jax_infer({str(tmp / 's1_jax')!r})
        dp_pre = preprocess.main({argv!r}[:1] + [{str(tmp / 's1_artifacts_dp')!r}]
                                 + {argv!r}[2:] + ["--data-parallel"])
        dp_jax = jax_infer({str(tmp / 's1_jax_dp')!r}, "--data-parallel")
        print(json.dumps({{"rerun": rerun, "cached": cached, "jax": jax,
                          "dp_pre": dp_pre, "dp_jax": dp_jax}}))
    """)
    t0 = time.perf_counter()
    res, err = _subprocess_json(code, tmp)
    wall = time.perf_counter() - t0
    n_one = S1_FRAMES[files[0].parent.name]
    joints = [np.load(p) for d in ("s1_cached", "s1_jax")
              for p in sorted((tmp / d).glob("*_pred_joints3d.npy"))]
    ok = (res == {"rerun": 0, "cached": n_one, "jax": n_one,
                  "dp_pre": len(files), "dp_jax": n_one}
          and len(joints) == 2 * n_one
          and all(j.shape == (17, 3) and np.isfinite(j).all()
                  for j in joints))
    dp_agree = _s1_artifacts_agree(tmp / "s1_artifacts_dp", files, want)
    dp_joints = [np.load(p) for p in sorted(
        (tmp / "s1_jax_dp").glob("*_pred_joints3d.npy"))]
    dp_diff = max(float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
                  for a, b in zip(dp_joints, joints[n_one:]))
    dp_ok = len(dp_joints) == n_one and dp_diff <= 1e-3
    log(f"[stage1] (c) second process ({wall:.1f} s, beside (d)'s server "
        f"starting): preprocess again "
        f"into the same tree: {res['rerun']} images (finished.txt in each "
        f"folder); cli.infer --stage1 cached "
        f"{res['cached']} and --stage1 jax {res['jax']} joint files (want "
        f"{n_one} each), finite  {'ok' if ok else 'FAIL'}")
    log(f"[stage1] (c) --data-parallel (a replica on each of the "
        f"{torch.cuda.device_count()} card(s)): cli.preprocess "
        f"{res['dp_pre']} images, artifacts against the provider: {dp_agree}"
        f"; cli.infer --stage1 jax {len(dp_joints)} joint files, max |Δ| "
        f"{dp_diff:.2e} of the run without the flag (bound 1e-3)  "
        f"{'ok' if dp_ok else 'FAIL'}")
    if not (ok and dp_ok):
        raise SystemExit("the stage-1 CLIs failed a check")


def _post_image(url: str, body: bytes) -> tuple:
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        data = np.load(io.BytesIO(r.read()))
        return (data["joints_3d"], data["keypoints"],
                int(r.headers["X-Batch-Size"]))


def _s1_serve_start(tmp: Path, paths: dict) -> dict:
    """(d)'s ``serve_http --checkpoint <lifter .pth> --kp-weights
    --depth-weights`` started now in its own process: its process, URL,
    log and start time."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    log_path = tmp / "s1_serve.log"
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pose3d_tpu_torch.serve_http",
             "--checkpoint", str(paths["lifter"]), "--kp-weights",
             str(paths["yolo"]), "--depth-weights", str(paths["depth"]),
             "--host", "127.0.0.1", "--port", str(port),
             "--max-wait-ms", "500"], cwd=tmp, env=env, stdout=logf,
            stderr=subprocess.STDOUT)
    return {"proc": proc, "base": f"http://127.0.0.1:{port}",
            "log": log_path, "t0": time.monotonic()}


def _s1_serve_stop(server: dict) -> None:
    proc = server["proc"]
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _s1_serve(torch, server: dict, bodies, want, card: str) -> None:
    """(d): the server of ``_s1_serve_start`` once healthy;
    ``/predict_image`` at batch 1 (one request) and 8 (eight concurrent
    requests, coalesced), against a direct provider + lifter call on the
    same decoded frames; ``/predict`` answers 404; the process is
    stopped."""
    proc, base, log_path = server["proc"], server["base"], server["log"]
    try:
        t0 = server["t0"]
        while True:
            if proc.poll() is not None:
                raise SystemExit("serve_http exited:\n"
                                 + log_path.read_text()[-4000:])
            try:
                if _get(base + "/healthz")[0] == 200:
                    break
            except (urllib.error.URLError, ConnectionError):
                pass
            if time.monotonic() - t0 > 600:
                raise SystemExit("serve_http not healthy after 600 s")
            time.sleep(0.5)
        up = time.monotonic() - t0
        try:
            _post_image(base + "/predict", bodies[0])
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        lat, rels, sizes = {}, [], {}
        for b in S1_SERVE_BATCHES:
            ts = []
            for _ in range(3):
                t = time.perf_counter()
                with ThreadPoolExecutor(b) as ex:
                    got = list(ex.map(lambda x: _post_image(
                        base + "/predict_image", x), bodies[:b]))
                ts.append((time.perf_counter() - t) * 1e3)
            lat[b] = statistics.median(ts)
            sizes[b] = max(g[2] for g in got)
            rels += [_rel(g[0], w) for g, w in zip(got, want[:b])]
    finally:
        _s1_serve_stop(server)
    top = max(S1_SERVE_BATCHES)
    ok = code == 404 and max(rels) <= TOL_S1_SERVE and sizes[top] == top
    log(f"[stage1] (d) serve_http --checkpoint (pipeline) polled healthy "
        f"{up:.1f} s after its start (it started beside (c)'s second "
        f"process and was polled after it); "
        f"/predict_image at batch 1 and 8 concurrent: device "
        f"batches {sizes}; joints against a direct provider + lifter call "
        f"rel L2 max {max(rels):.3e} (tol {TOL_S1_SERVE:.0e}); /predict "
        f"{code}  {'ok' if ok else 'FAIL'}")
    log(f"[time] stage1 /predict_image (1000x1000 JPEG, stage 1 fp32 + the "
        f"transformer lifter), median of 3: batch 1 {lat[1]:.0f} ms, batch "
        f"8 (8 concurrent requests) {lat[8]:.0f} ms  [{card}]")
    if not ok:
        raise SystemExit("pipeline serving failed a check")


def _s1_main_path(torch, provider, rgbs) -> dict:
    """The main path: the provider with ``attention_backend="pallas"`` on
    two frames, every count set to 0 just before and read just after
    (2 PSA launches for YOLO11x, 3 x 24 for DepthPro); finite keypoints,
    depth finite and positive at the frame's size."""
    from pose3d_tpu_torch.stage1.yolo11 import set_attention_backend

    for model in (provider.kp_model, provider.depth_model):
        set_attention_backend(model, "pallas")
    zero_launch_counts()
    main = provider.predict_batch(rgbs[:2])
    launches = launch_counts()
    for model in (provider.kp_model, provider.depth_model):
        set_attention_backend(model, "xla")
    want = (len(provider.kp_model.model[10].m)
            + 3 * provider.depth_model.arch.vit.num_layers)
    ok = (launches["flash_attention_fwd"] == want
          and sum(launches.values()) == want
          and all(np.isfinite(r.keypoints).all() and r.depth.shape == S1_HW
                  and np.isfinite(r.depth).all() and (r.depth > 0).all()
                  for r in main))
    log(f"[stage1] main path: predict_batch of 2 frames with "
        f"attention_backend=\"pallas\": launches {launches} (want "
        f"flash_attention_fwd {want}: YOLO 2 + DepthPro 72); keypoints "
        f"finite, depth finite and positive at {S1_HW}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the stage-1 main path failed a check")
    return launches


def phase_stage1(torch, tmp: Path, card: str) -> dict:
    """Stage 1 at the published widths with seeded random weights:
    YOLO11x-pose at 640 and DepthPro (apple/DepthPro-hf) at 1536², from a
    plain upstream-named ``.pt`` and a ``.safetensors`` written here.
    (main path) the provider with ``attention_backend="pallas"`` on two
    frames; (a) each network's "pallas" against "xla" on the same weights
    and inputs, fp32 and bf16, the path of each attention shape asserted,
    and a zeroed attention as a control; (b) launches: 72 a DepthPro
    call, 2 a YOLO11x call, 0 with "xla"; (c) ``cli.preprocess`` on 8
    1000x1000 frames in two folders, its artifacts against the provider,
    a second run that skips, ``cli.infer`` with ``--stage1 cached`` and
    ``--stage1 jax``; (d) pipeline serving; (e) times. Returns the
    launches of the main path."""
    from pose3d_tpu_torch.checkpoint import load_pose_model
    from pose3d_tpu_torch.cli.infer import make_lifter
    from pose3d_tpu_torch.stage1.models import TorchStage1

    import cv2

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    paths = _s1_write_weights(torch, tmp, "cuda")
    files = _s1_frames(tmp / "s1_frames")
    t0 = time.perf_counter()
    provider = TorchStage1(kp_weights=str(paths["yolo"]),
                           depth_weights=str(paths["depth"]),
                           kp_input_size=S1_YOLO_SIZE,
                           depth_input_size=S1_DEPTH_SIZE)
    log(f"[stage1] provider (fp32, \"xla\": the CLIs') loaded in "
        f"{time.perf_counter() - t0:.1f} s; DepthPro "
        f"{provider.depth_model.arch.vit.num_layers} layers x 3 encoders, "
        f"architecture from the shapes")
    # the main path, the references for (c) and (d) and the host split
    # under the CLIs' TF32 flags (PyTorch's defaults)
    rgbs = [_rgb(f) for f in files]
    with _tf32(torch, False, True):
        launches = _s1_main_path(torch, provider, rgbs)
        want_s1 = provider.predict_batch(rgbs)
        bodies = [cv2.imencode(".jpg", cv2.imread(str(f)))[1].tobytes()
                  for f in files[:max(S1_SERVE_BATCHES)]]
        decoded = [cv2.cvtColor(cv2.imdecode(np.frombuffer(b, np.uint8),
                                             cv2.IMREAD_COLOR),
                                cv2.COLOR_BGR2RGB) for b in bodies]
        lifter, cfg = load_pose_model(paths["lifter"], "cuda")
        want_joints = make_lifter(lifter, cfg)(
            decoded, provider.predict_batch(decoded))
        del lifter
        _s1_host_split(torch, provider, files[:S1_BATCH], card)
    _s1_networks(torch, provider, rgbs, card)
    del provider
    gc.collect()
    torch.cuda.empty_cache()
    _s1_attention_times(torch, card)
    # (d)'s server starts as (c)'s second process does: its start-up, the
    # weights read and a batch-1 warmup, overlaps that process; it is timed
    # once that process is done
    server = []
    try:
        _s1_preprocess(torch, tmp, paths, files, want_s1, card,
                       lambda: server.append(_s1_serve_start(tmp, paths)))
        _s1_serve(torch, server[0], bodies, want_joints, card)
    finally:
        for srv in server:
            _s1_serve_stop(srv)
    log(f"[stage1] phase seconds: {time.perf_counter() - t_phase:.1f}")
    return launches


# --- phase 14: parallelism ----------------------------------------------------

# Two ranks share the one card over gloo (NCCL refuses two ranks on one
# device): every collective copies through host memory there
# (pose3d_tpu_torch/core/comm.py). Each job: one optimizer step from the
# same seeded weights and superbatch as a one-process step run first (the
# step compared), then a second, warm step (the step timed), the dropout
# rates 0 (ranks draw their own masks), TF32 off. The CNN computes in fp32
# here (the grouped step with remat, to hold the flat batch of 100 in fp32):
# in bf16 the convolutions round differently at batch 50 than at 100, and
# 62 BatchNorms in sequence carry that to 12% of the gradient (measured on
# the H100), which would hide a fault of the cross-rank statistics. The
# transformer computes in bf16. (name, model, normalization, accumulation,
# A, B, strategy, mesh shape, axes, augment)
PAR_JOBS = (
    ("dp_cnn", "cnn", "batch", "grouped", 10, 10, "dp", (2,), ("data",),
     True),
    # scan at 2 x 10: two microbatches show the per-microbatch launches and
    # all-reduces; ten would add 9 s of host round trips on the shared card
    ("dp_cnn_scan", "cnn", "batch_pallas", "scan", 2, 10, "dp", (2,),
     ("data",), False),
    ("fsdp_transformer", "transformer", None, "grouped", 10, 10, "fsdp",
     (2,), ("data",), False),
    # TP, TP+SP and PP: both ranks run the whole batch (one data rank), so
    # the batch is cut from 10 x 10 to 1 x 10 to hold two ranks on 80 GB
    ("tp", "transformer", None, "grouped", 1, 10, "tp", (1, 2),
     ("data", "model"), False),
    ("tp_sp", "transformer", None, "grouped", 1, 10, "sp", (1, 2),
     ("data", "model"), False),
    ("pp", "transformer", None, "grouped", 1, 10, "pp", (1, 2),
     ("data", "stage"), False),
)
# The job whose warm step is timed, with its collectives' host time, on
# each rank and in one process; the others' warm steps (1.2–6.8 s a rank
# on an H100 shared by the two ranks) are left out to keep the script
# within its time
PAR_TIMED = ("dp_cnn",)
PAR_MICROBATCHES = 2
PAR_TIMEOUT = 240
# A rank's step against the one-process step, relative: the loss, the
# averaged gradient (L2 of the difference over L2 of the reference) and the
# BatchNorm running statistics. The two run on partitions of the batch that
# differ (cuDNN and cuBLAS pick kernels by shape, the sums run in another
# order), so they agree to the dtype's rounding, not bitwise. fp32 (the
# CNN): the statistics' sums in another order, passed through 62
# BatchNorms; the card gave loss ≤ 6.0e-7, gradient ≤ 2.5e-5, statistics
# ≤ 6.6e-8. bf16 (the transformer): loss ≤ 5.8e-4 and gradient ≤ 2.3e-2
# (TP+SP, whose all-gathers and reduce-scatters change the most sums).
TOL_PAR = {"float32": {"loss": 1e-5, "grad": 1e-3, "stats": 1e-6},
           "bfloat16": {"loss": 2e-3, "grad": 5e-2, "stats": 1e-6}}
# ... and every parameter within 2.1·lr of the reference's: AdamW's first
# step moves an element by at most lr (plus decay), so a misplaced shard
# or a wrong gather shows far beyond it
LR_PAR = 1e-3
# cli.main at a world of one over NCCL against the same command line
# without the flags: the per-step losses, relative. One rank's FSDP gather
# is a copy, so only the attention backward's atomic dQ sums and cuDNN's
# move the second step's loss: the card gave ≤ 8.2e-6 in four runs.
TOL_PAR_CLI = 1e-4


def _par_config(model: str, norm):
    """The published configuration with dropout 0."""
    from pose3d_tpu_torch.core.config import make_model_config

    if model == "cnn":
        return make_model_config("cnn", normalization=norm,
                                 regression_dropout=0.0)
    return make_model_config("transformer", transformer_dropout_rate=0.0,
                             regression_dropout=0.0)


def _par_dtype(torch, job):
    return torch.float32 if job[1] == "cnn" else torch.bfloat16


def _par_superbatch(cfg, A: int, B: int, seed: int) -> dict:
    from pose3d_tpu_torch.train.loop import _superbatches

    return next(_superbatches(_train_batches(
        seed, A, B, tuple(cfg.image_size), cfg.num_joints), A))


def _par_state(torch, job, mesh=None):
    """The job's model and state, seeded alike in every process, with the
    strategy's hooks and sharding."""
    from pose3d_tpu_torch import parallel
    from pose3d_tpu_torch.models import build_model
    from pose3d_tpu_torch.parallel.sp import make_sp_constraint
    from pose3d_tpu_torch.train.state import create_train_state

    name, model, norm, mode, A, B, strategy, shape, axes, aug = job
    cfg = _par_config(model, norm)
    kw = dict(dtype=_par_dtype(torch, job), remat=mode == "grouped"
              and model == "cnn")
    if mesh is not None and strategy == "pp":
        kw.update(vit_stacked=True, vit_block_runner=parallel.
                  make_pipeline_runner(mesh, PAR_MICROBATCHES))
    if mesh is not None and strategy == "sp":
        kw.update(sp_constraint=make_sp_constraint(mesh))
    m = build_model(cfg, device="cuda", train=True,
                    generator=torch.Generator("cuda").manual_seed(11), **kw)
    state = create_train_state(m, ema=True)
    init = float(sum(p.detach().double().sum() for p in m.parameters()))
    if mesh is not None and strategy != "dp":
        {"fsdp": parallel.shard_state_for_fsdp,
         "tp": parallel.shard_state_for_tp,
         "sp": parallel.shard_state_for_tp,
         "pp": parallel.shard_state_for_pp}[strategy](state, mesh)
    return cfg, state, init


class _CommTimer:
    """Host seconds inside the port's collectives: each function of
    ``pose3d_tpu_torch.core.comm`` wrapped wherever a module of the port
    holds it, the outermost call counted (the staging copies through host
    memory, and the wait for the other rank, included). gloo works in
    threads of its own, so ``torch.profiler``'s rows show only the calls'
    launch; this counts the time the step's thread spends in them."""

    NAMES = ("all_reduce_", "all_gather", "all_gather_cat",
             "reduce_scatter_dim", "broadcast_", "exchange")

    def __init__(self):
        from pose3d_tpu_torch.core import comm

        self.seconds, self.calls, depth = 0.0, 0, [0]

        def wrap(f):
            def timed(*a, **k):
                depth[0] += 1
                t0 = time.perf_counter()
                try:
                    return f(*a, **k)
                finally:
                    depth[0] -= 1
                    if depth[0] == 0:
                        self.seconds += time.perf_counter() - t0
                        self.calls += 1
            return timed

        orig = {n: getattr(comm, n) for n in self.NAMES}
        new = {n: wrap(f) for n, f in orig.items()}
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("pose3d_tpu_torch"):
                for n in self.NAMES:
                    if getattr(mod, n, None) is orig[n]:
                        setattr(mod, n, new[n])


def _par_step(torch, job, state, cfg, mesh=None):
    """One step of the job (this rank's rows with a mesh); returns
    (metrics, host seconds, launches, peak GiB)."""
    from pose3d_tpu_torch.core.mesh import shard_batch
    from pose3d_tpu_torch.ops.augment_device import (
        DeviceAugmentConfig,
        make_device_augment,
    )
    from pose3d_tpu_torch.train.loop import to_device
    from pose3d_tpu_torch.train.step import make_train_step

    name, model, norm, mode, A, B, strategy, shape, axes, aug = job
    sb = _par_superbatch(cfg, A, B, seed=len(name))
    if mesh is not None:
        sb = shard_batch(mesh, sb, batch_axis=1)
    augment = make_device_augment(DeviceAugmentConfig()) if aug else None
    step = make_train_step(accum_mode=mode, ema_decay=0.999,
                           augment=augment, mesh=mesh,
                           state_sharding="replicated"
                           if mesh is None or strategy == "dp" else "auto")
    batch = to_device(sb, "cuda")
    gen = torch.Generator("cuda").manual_seed(3)
    agen = torch.Generator("cuda").manual_seed(4) if aug else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    metrics = step(state, batch, gen, agen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return ({k: float(v) for k, v in metrics.items()}, seconds,
            launch_counts(), torch.cuda.max_memory_allocated() / 2 ** 30)


def _par_vectors(torch, state) -> dict:
    """The whole gradient, parameters and running statistics as flat fp32
    vectors (sharded tensors gathered: a collective on a mesh)."""
    from pose3d_tpu_torch.parallel.shard import full_state
    from pose3d_tpu_torch.train.state import batch_stats

    plan = getattr(state.model, "shard_plan", None)
    names = [n for n, _ in state.model.named_parameters()]
    grads = []
    for n, p in state.model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        grads.append((plan.gather(n, g) if plan is not None else g)
                     .float().reshape(-1))
    sd = full_state(state)[0]
    stats = list(batch_stats(state.model).values())
    return {"grad": torch.cat(grads),
            "params": torch.cat([sd[n].float().reshape(-1) for n in names]),
            "stats": (torch.cat([s.float().reshape(-1) for s in stats])
                      if stats else torch.zeros(1, device="cuda"))}


def _par_reference(torch, job, tmp: Path, card: str) -> dict:
    """The one-process step of a job, its vectors saved for the ranks."""
    with _tf32(torch, False, False):
        cfg, state, init = _par_state(torch, job)
        metrics, first, launches, peak = _par_step(torch, job, state, cfg)
        vec = _par_vectors(torch, state)
        torch.save({k: v.cpu() for k, v in vec.items()}, tmp / f"{job[0]}.pt")
        del vec
        seconds = (_par_step(torch, job, state, cfg)[1]
                   if job[0] in PAR_TIMED else None)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(init=init, metrics=metrics, seconds=seconds, first=first,
                launches=launches, peak=peak)


def _par_expected(job, ref: dict) -> dict:
    """The launches of each kernel a rank's step implies: the transformer
    one of each attention kernel per attention and pass (a pipeline stage
    runs its half of the ViT's blocks at each of M + 1 ticks), the scan
    CNN one ``bn_stats`` per BatchNorm per microbatch (as many as the
    one-process step launched: a rank runs every microbatch on its
    rows), and with rotation four ``lane_resample`` a step (image and
    depth rows of the two-pass warp)."""
    name, model, norm, mode, A, B, strategy, shape, axes, aug = job
    want = dict.fromkeys(KERNELS, 0)
    cfg = _par_config(model, norm)
    if model == "transformer":
        rest = 2 * cfg.num_cross_modal_layers + cfg.final_encoder_depth
        vit = cfg.vit_depth
        if strategy == "pp":
            vit = vit // 2 * (PAR_MICROBATCHES + 1)
        want["flash_attention_fwd"] = want["flash_attention_bwd"] = vit + rest
    elif norm == "batch_pallas":
        want["bn_stats"] = ref["launches"]["bn_stats"]
    if aug:
        want["lane_resample"] = 4
    return want


def _parallel_rank(argv) -> int:
    """One rank of phase 14 (``chip_smoke.py --parallel-rank R PORT DIR``):
    every job of ``PAR_JOBS`` on the card over gloo, each against the
    one-process reference in DIR; writes ``rank<R>.json`` there."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from pose3d_tpu_torch.core.mesh import initialize_distributed, make_mesh

    rank, port, out = int(argv[0]), int(argv[1]), Path(argv[2])
    initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cuda",
                           backend="gloo")
    import pose3d_tpu_torch.parallel  # noqa: F401  (then wrap every holder)
    import pose3d_tpu_torch.train.loop  # noqa: F401
    timer = _CommTimer()
    results = {}
    for job in PAR_JOBS:
        name, *_, strategy, shape, axes, aug = job
        mesh = make_mesh(shape, axes)
        with _tf32(torch, False, False):
            cfg, state, init = _par_state(torch, job, mesh)
            local = [p for p in state.trainable()]
            metrics, first, launches, peak = _par_step(
                torch, job, state, cfg, mesh)
            vec = _par_vectors(torch, state)
            ref = torch.load(out / f"{name}.pt", map_location="cuda")
            moments = sum(t.numel() * t.element_size()
                          for p in local
                          for t in state.optimizer.state[p].values()
                          if torch.is_tensor(t) and t.dim() > 0)
            rel = {
                "grad": float((vec["grad"] - ref["grad"]).norm()
                              / ref["grad"].norm()),
                "stats": float((vec["stats"] - ref["stats"]).norm()
                               / ref["stats"].norm().clamp_min(1e-30)),
                "params_max": float((vec["params"] - ref["params"]).abs()
                                    .max()),
                "checksum": float(vec["params"].double().sum()),
            }
            del vec, ref
            # the warm step, timed, with the collectives' host time
            timer.seconds, timer.calls = 0.0, 0
            seconds = (_par_step(torch, job, state, cfg, mesh)[1]
                       if name in PAR_TIMED else None)
        results[name] = dict(
            init=init, metrics=metrics, seconds=seconds, first=first,
            launches=launches, peak=peak, rel=rel,
            collectives_ms=timer.seconds * 1e3, collectives=timer.calls,
            param_bytes=sum(p.numel() * p.element_size() for p in local),
            moment_bytes=moments)
        del state, local
        gc.collect()
        torch.cuda.empty_cache()
    (out / f"rank{rank}.json").write_text(json.dumps(results))
    dist.destroy_process_group()
    return 0


def _par_ranks(torch, tmp: Path, card: str) -> dict:
    """(b): the references, then the two ranks, each killed at
    ``PAR_TIMEOUT``; every check; returns each rank's launches."""
    import socket

    out = tmp / "parallel"
    out.mkdir()
    refs = {job[0]: _par_reference(torch, job, out, card) for job in PAR_JOBS}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "4"}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--parallel-rank",
         str(r), str(port), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=PAR_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for r, (p, lg) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise SystemExit(f"parallel rank {r} exited {p.returncode}:\n"
                             f"{lg[-6000:]}")
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    log(f"[parallel] (b) two ranks on one card over gloo (every collective "
        f"through host memory: NCCL refuses two ranks on one device), "
        f"{wall:.1f} s for both processes with start-up  [{card}]")
    ok = True
    per_rank = [dict.fromkeys(KERNELS, 0) for _ in range(2)]
    for job in PAR_JOBS:
        name = job[0]
        ref = refs[name]
        want = _par_expected(job, ref)
        tol = TOL_PAR[str(_par_dtype(torch, job)).split(".")[1]]
        loss = ref["metrics"]["total_loss"]
        for r, res in enumerate(ranks):
            got = res[name]
            rel = dict(got["rel"], loss=abs(got["metrics"]["total_loss"]
                                            - loss) / abs(loss))
            checks = {
                "same seeded weights": got["init"] == ref["init"],
                "launches": got["launches"] == want,
                **{f"{k} {rel[k]:.2e} <= {tol[k]:g}": rel[k] <= tol[k]
                   for k in tol},
                f"parameters max |Δ| {rel['params_max']:.2e} <= 2.1·lr":
                    rel["params_max"] <= 2.1 * LR_PAR,
            }
            for k, v in got["launches"].items():
                per_rank[r][k] += v
            warm = ("warm step not timed (PAR_TIMED)"
                    if got["seconds"] is None else
                    f"warm step {got['seconds'] * 1e3:.1f} ms (one process "
                    f"{ref['seconds'] * 1e3:.1f} ms), of it "
                    f"{got['collectives_ms']:.1f} ms in {got['collectives']} "
                    f"collectives (host time, staging included)")
            log(f"[parallel] (b) {name} rank {r} "
                f"({str(_par_dtype(torch, job)).split('.')[1]}): loss "
                f"{got['metrics']['total_loss']:.6f} (one process {loss:.6f}); "
                f"{warm}; first steps {got['first'] * 1e3:.1f} and "
                f"{ref['first'] * 1e3:.1f} (the card shared by two ranks); "
                f"peak "
                f"{got['peak']:.2f} GiB (one process {ref['peak']:.2f}); "
                f"parameters {got['param_bytes'] / 2**20:.1f} MiB + AdamW "
                f"moments {got['moment_bytes'] / 2**20:.1f} MiB on this rank; "
                f"launches {_nonzero(got['launches'])} (want "
                f"{_nonzero(want)})")
            for what, good in checks.items():
                log(f"[parallel] (b) {name} rank {r} {what}: "
                    f"{'ok' if good else 'FAIL'}")
                ok &= good
        same = ranks[0][name]["rel"]["checksum"] == \
            ranks[1][name]["rel"]["checksum"]
        log(f"[parallel] (b) {name}: both ranks hold the same parameters "
            f"after the step: {'ok' if same else 'FAIL'}")
        ok &= same
    if not ok:
        raise SystemExit("a parallel step failed a check")
    return {"per_rank": per_rank}


def _nonzero(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


def _par_cli(torch, tmp: Path, card: str) -> dict:
    """(a): ``cli.main`` at a world of one over NCCL (``--coordinator``,
    ``--num-processes 1``, ``--process-id 0``) with ``--param-sharding
    fsdp``, against the same command line without those flags: the CNN
    (grouped, rotation on) stopped by SIGTERM after step 1 and resumed to
    step 2 under the flags, the transformer for 2 steps."""
    import socket

    import torch.distributed as dist

    from pose3d_tpu_torch.cli import main as cli_main

    def flags():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        return ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
                "1", "--process-id", "0", "--param-sharding", "fsdp"]

    def run(argv, cwd, stop_after=None):
        try:
            return _run_cli(torch, cli_main, argv, cwd, stop_after)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()

    base = ["--chunks-dir", str(FIXTURE), "--device", "cuda",
            "--pixel-dtype", "uint8", "--no-tensorboard", "--num-steps", "2",
            "--log-interval", "1", "--checkpoint", "auto", "--eval-interval",
            "1", "--keep-checkpoints", "1", "--cache-dir",
            str(tmp / "par_cache")]
    cnn = base + ["--model-type", "cnn", "--augment-device",
                  "--augment-device-rotation"]
    # the transformer at batch 2 x 2 (its published dropout on), one
    # validation and checkpoint at step 2
    tf = base + ["--model-type", "transformer", "--batch-size", "2",
                 "--grad-accum", "2", "--eval-interval", "2"]
    plain = run(cnn, tmp / "par_cli_cnn")
    first = run(cnn + flags(), tmp / "par_cli_cnn_fsdp", stop_after=1)
    second = run(cnn + flags(), tmp / "par_cli_cnn_fsdp")
    tplain = run(tf, tmp / "par_cli_tf")
    tflag = run(tf + flags(), tmp / "par_cli_tf_fsdp")
    sharded = first["losses"] + second["losses"]

    def close(a, b):
        return len(a) == len(b) == 2 and all(
            abs(x - y) <= TOL_PAR_CLI * abs(y) for x, y in zip(a, b))

    checks = {
        "CNN stopped at step 1 under the flags": first["last_step"] == 1,
        "CNN resumed at step 1 to step 2": (second["start_step"] == 1
                                             and second["last_step"] == 2),
        f"CNN losses within {TOL_PAR_CLI:g} of the run without flags":
            close(sharded, plain["losses"]),
        f"transformer losses within {TOL_PAR_CLI:g} of the run without "
        "flags": close(tflag["losses"], tplain["losses"]),
        "the same launches with and without the flags": (
            tflag["launches"] == tplain["launches"]),
    }
    log(f"[parallel] (a) cli.main, a world of one over NCCL with "
        f"--param-sharding fsdp: CNN losses {sharded} (stopped at "
        f"{first['last_step']}, resumed at {second['start_step']}) against "
        f"{plain['losses']} without the flags; transformer {tflag['losses']} "
        f"against {tplain['losses']}; launches {_nonzero(tflag['launches'])}"
        f"; steps {first['wall'] + second['wall']:.1f} s + "
        f"{tflag['wall']:.1f} s with the flags, {plain['wall']:.1f} s + "
        f"{tplain['wall']:.1f} s without  [{card}]")
    for what, good in checks.items():
        log(f"[parallel] (a) {what}: {'ok' if good else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit("the world-of-one CLI runs failed a check")
    return {k: first["launches"][k] + second["launches"][k]
            + tflag["launches"][k] for k in KERNELS}


def _par_stage1(torch, card: str) -> None:
    """(c'): the untrained stage-1 provider with two replicas on the one
    card (``mesh=["cuda:0", "cuda:0"]``: the batch padded to a multiple of
    two, split and gathered in order) against one device."""
    from pose3d_tpu_torch.stage1.models import TorchStage1

    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in ((480, 640), (512, 512), (720, 400))]
    kw = dict(input_size=512, generator=None)
    one = TorchStage1(**kw, device="cuda").predict_batch(imgs)
    two = TorchStage1(**kw, mesh=["cuda:0", "cuda:0"]).predict_batch(imgs)
    kp = max(float(np.abs(a.keypoints - b.keypoints).max())
             for a, b in zip(one, two))
    dep = max(float(np.abs(1 / a.depth - 1 / b.depth).max()
                    / np.abs(1 / b.depth).max()) for a, b in zip(one, two))
    ok = kp <= 1e-2 and dep <= 1e-2
    log(f"[parallel] (c) stage 1, untrained nets (bf16) at 512, three "
        f"frames over two replicas on the card against one: keypoints max "
        f"|Δ| {kp:.2e}, inverse depth {dep:.2e} of its max (bound 1e-2 "
        f"each: bf16, batch 2 and 4 pick other kernels)  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("data-parallel stage 1 failed a check")


def phase_parallel(torch, tmp: Path, card: str) -> dict:
    """Phase 14: (a) the CLI at a world of one over NCCL, (b) two ranks
    sharing the card over gloo for every strategy, (c') data-parallel stage
    1 with two replicas. Returns the launches of (b) per rank."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cli = _par_cli(torch, tmp, card)
    gc.collect()
    torch.cuda.empty_cache()
    ranks = _par_ranks(torch, tmp, card)
    _par_stage1(torch, card)
    log(f"[parallel] phase seconds: {time.perf_counter() - t0:.1f}")
    return {"cli": cli, **ranks}


# --- phase 15: the tooling and the on-card acceptance scripts ---------------

# the three chains of the phase run side by side on the card, beside phase
# 14, each within this many seconds (the doctor runs alone before them: its
# probes time the card)
TOOLS_TIMEOUT = 240
# the transformer overfit (scripts/torch_overfit_demo.py): steps and how
# far it must learn in them, the last loss below a quarter of step 1's and
# the train batch's MPJPE below half the untrained value. It trains on one
# superbatch of 8 samples and memorises them: on the JAX script's four, one
# of six seeded runs met both thresholds by step 3,000, while on one all
# four met them by step 400 (PERF.md).
OVERFIT_STEPS = 600
OVERFIT_SUPERBATCHES = 1
OVERFIT_EVAL_EVERY = 100
OVERFIT_LOSS_FALL = 4.0
OVERFIT_MPJPE_FALL = 2.0
# the kernels the phase's runs must launch: the attention pair (the
# lifecycle's transformer at head depth 16, the overfit's at 48, the pallas
# program of the int8 check) and lane_resample (the lifecycle's rotation)
TOOLS_PATH = ("flash_attention_fwd", "flash_attention_bwd", "lane_resample")


def _tool(argv, cwd: Path, timeout: int) -> tuple:
    """``python argv`` (a script of ``scripts/`` or ``-m`` a module) in a
    process of its own with this checkout on its path: (seconds, standard
    output); a non-zero exit fails the phase."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *argv], cwd=cwd,
                         env={**os.environ, "PYTHONPATH": str(ROOT)},
                         capture_output=True, text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    if out.returncode:
        log(out.stdout[-3000:] + out.stderr[-3000:])
        raise SystemExit(f"{' '.join(argv[:3])} exited {out.returncode}")
    return dt, out.stdout


def _last_json(stdout: str, prefix: str = "") -> dict:
    """The last line of ``stdout`` that is ``prefix`` and a JSON object."""
    for line in reversed(stdout.splitlines()):
        if line.startswith(prefix + "{"):
            return json.loads(line[len(prefix):])
    raise SystemExit(f"no {prefix or 'JSON'} line in the output")


def _tools_doctor(torch, tmp: Path, card: str) -> None:
    """(a) ``cli.doctor --probe --json`` in its own process: the card the
    environment phase found, all eight kernel libraries loaded."""
    report = tmp / "doctor.json"
    dt, _ = _tool(["-m", "pose3d_tpu_torch.cli.doctor", "--probe", "--json",
                   str(report)], tmp, 120)
    rep = json.loads(report.read_text())
    name = torch.cuda.get_device_name(0)
    probe = rep.get("probe", {})
    smi = rep["devices"].get("nvidia_smi", [])
    ok = (rep["devices"].get("cuda:0", "").startswith(name)
          and card in smi and probe.get("probed_device") == name
          and probe.get("kernels_loaded") == f"{len(KERNELS)} of "
          f"{len(KERNELS)}"
          and all(str(probe.get(f"kernel_{k}", "")).startswith("loaded")
                  for k in KERNELS))
    log(f"[tools] doctor --probe ({dt:.1f} s): {rep['devices'].get('cuda:0')}"
        f"; nvidia-smi {smi}; kernels {probe.get('kernels_loaded')}; "
        f"toolchain {rep['toolchain'].get('nvcc_version')}, decode route "
        f"{rep['toolchain'].get('decode_route')}; warnings "
        f"{rep.get('warnings')}  {'ok' if ok else 'FAIL'}")
    log(f"[time] doctor probe: bf16 matmul {probe.get('matmul_tflops_bf16', 0):.1f}"
        f" TFLOP/s at n {probe.get('matmul_n')}; host to device "
        f"{probe.get('host_to_device_MBps_pinned', 0):.0f} MB/s pinned, "
        f"{probe.get('host_to_device_MBps_pageable', 0):.0f} pageable; host "
        f"decode {probe.get('host_decode_imgs_per_sec', 0):.1f} images/s "
        f"({probe.get('host_decode_route')})  [{card}]")
    if not ok:
        raise SystemExit(f"the doctor's report does not hold: {rep}")


def _tools_lifecycle(tmp: Path, model_type: str) -> dict:
    """(b) ``scripts/torch_lifecycle_e2e.py`` on the card: its own checks
    (the resume bitwise, the artifact within the export bound,
    ``/predict`` answered)
    end in a non-zero exit when they fail."""
    dt, out = _tool([str(ROOT / "scripts" / "torch_lifecycle_e2e.py"),
                     "--model-type", model_type, "--workdir",
                     str(tmp / f"lifecycle_{model_type}")], tmp,
                    TOOLS_TIMEOUT)
    return {"seconds": dt, **_last_json(out, "LIFECYCLE ")}


def _tools_overfit(tmp: Path) -> dict:
    """(c) the reduced ViT of ``scripts/torch_overfit_demo.py`` for
    ``OVERFIT_STEPS`` steps, saved; then (d)
    ``scripts/torch_quantize_accuracy.py`` on its checkpoint."""
    ckpt = tmp / "overfit_transformer"
    dt, out = _tool([str(ROOT / "scripts" / "torch_overfit_demo.py"),
                     "--model-type", "transformer", "--steps",
                     str(OVERFIT_STEPS), "--superbatches",
                     str(OVERFIT_SUPERBATCHES), "--eval-every",
                     str(OVERFIT_EVAL_EVERY), "--save-checkpoint", str(ckpt)],
                    tmp, TOOLS_TIMEOUT)
    overfit = {"seconds": dt, **_last_json(out)}
    dt, out = _tool([str(ROOT / "scripts" / "torch_quantize_accuracy.py"),
                     str(ckpt), "--out", str(tmp / "quantized")], tmp,
                    TOOLS_TIMEOUT)
    return {"overfit": overfit, "quantize": {"seconds": dt,
                                             **_last_json(out)}}


def tools_start(torch, tmp: Path, card: str) -> dict:
    """Phase 15, begun before phase 14: (a) the doctor alone, then (b) the
    lifecycle of both families and (c) the transformer overfit followed by
    (d) its int8 accuracy started side by side, each chain in processes of
    its own, to run beside phase 14 (whose two ranks share the card too
    and time nothing that is compared). ``phase_tools`` waits for them."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    _tools_doctor(torch, tmp, card)
    ex = ThreadPoolExecutor(3)
    jobs = {"cnn": ex.submit(_tools_lifecycle, tmp, "cnn"),
            "transformer": ex.submit(_tools_lifecycle, tmp, "transformer"),
            "overfit": ex.submit(_tools_overfit, tmp)}
    return {"t0": t0, "ex": ex, "jobs": jobs}


def phase_tools(torch, tmp: Path, card: str, started: dict) -> dict:
    """Phase 15 finished: the chains of ``tools_start`` waited for and
    checked. Returns the launches the scripts' processes report, summed."""
    t0 = started["t0"]
    with started["ex"]:
        res = {k: f.result() for k, f in started["jobs"].items()}
    for mt in ("cnn", "transformer"):
        lc = res[mt]
        log(f"[tools] lifecycle {mt} ({lc['seconds']:.1f} s): SIGTERM "
            f"checkpoint at step {lc['sigterm_checkpoint_step']}; resume "
            f"bitwise {lc['resume_bit_exact']} over {lc['compared_arrays']} "
            f"arrays; "
            f"update after the stop {lc['update_l2_after_sigterm']:.3e}; eval "
            f"MPJPE {lc['eval_mpjpe_mm']:.2f} mm; export rel L2 "
            f"{lc['export_rel_l2']:.3e} (tol {TOL_SLICE_REL_L2:.0e}); /predict "
            f"{'bitwise' if lc['serve_bit_identical'] else 'within 1e-6'} the "
            f"artifact's; launches {_nonzero(lc['launches'])}")
        if not lc["resume_bit_exact"]:
            raise SystemExit(f"lifecycle {mt}: the resumed run is not "
                             f"bitwise")
        if lc["export_rel_l2"] > TOL_SLICE_REL_L2:
            raise SystemExit(f"lifecycle {mt}: artifact beyond the bound")
    ov, q = res["overfit"]["overfit"], res["overfit"]["quantize"]
    curve = ov["curve"]
    loss_fall = curve[0]["loss"] / max(curve[-1]["loss"], 1e-12)
    mpjpe_fall = ov["untrained_mpjpe_mm"] / max(ov["final_train_mpjpe_mm"],
                                                 1e-12)
    learned = (loss_fall > OVERFIT_LOSS_FALL
               and mpjpe_fall > OVERFIT_MPJPE_FALL)
    log(f"[tools] overfit transformer ({ov['seconds']:.1f} s, "
        f"{ov['steps']} steps at 1 x 8 on {OVERFIT_SUPERBATCHES} superbatch, "
        f"256 px): loss {curve[0]['loss']:.1f} "
        f"-> {curve[-1]['loss']:.1f} ({loss_fall:.1f}x, must exceed "
        f"{OVERFIT_LOSS_FALL:.0f}x); MPJPE untrained "
        f"{ov['untrained_mpjpe_mm']:.1f} mm, train batch "
        f"{ov['final_train_mpjpe_mm']:.1f} ({mpjpe_fall:.1f}x, must exceed "
        f"{OVERFIT_MPJPE_FALL:.0f}x), held-out "
        f"{ov['final_held_out_mpjpe_mm']:.1f}; curve "
        + ", ".join(f"{c['step']}: {c['loss']:.0f}/{c['train_mpjpe_mm']:.0f}"
                    for c in curve)
        + f"; launches {_nonzero(ov['launches'])}  "
        f"{'ok' if learned else 'FAIL'}")
    log(f"[time] overfit transformer: {ov['steady_state_images_per_sec']:.1f}"
        f" images/s over the second half (the phase's chains and phase 14 "
        f"share the card)  [{card}]")
    log(f"[tools] int8 PTQ on the overfit's weights ({q['seconds']:.1f} s, "
        f"attention {q['attention_backend']} inside the programs): MPJPE fp32 "
        f"{q['mpjpe_mm_f32']:.3f} mm, int8 {q['mpjpe_mm_int8']:.3f}, int8 - "
        f"fp32 {q['delta_mm_int8']:+.3f}; artifacts "
        f"{q['artifact_mb_f32']:.1f} / {q['artifact_mb_int8']:.1f} MB; "
        f"launches {_nonzero(q['launches'])}")
    if not learned:
        raise SystemExit("the transformer overfit did not learn to the "
                         "thresholds")
    launches = {k: sum(r["launches"].get(k, 0) for r in (
        res["cnn"], res["transformer"], ov, q)) for k in KERNELS}
    idle = [k for k in TOOLS_PATH if not launches[k]]
    if idle:
        raise SystemExit(f"tools phase: {idle} never launched")
    log(f"[tools] phase seconds: {time.perf_counter() - t0:.1f} (phase 14 "
        f"beside its chains); launches {_nonzero(launches)}")
    return launches


def phase_imports() -> None:
    """The port, every module of it imported (the stage-1 modules, the
    preprocess CLI and the doctor among them), has loaded nothing of JAX,
    flax or the JAX
    package, nor transformers, safetensors, timm or ultralytics."""
    import importlib
    import pkgutil

    import pose3d_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(
        pose3d_tpu_torch.__path__, "pose3d_tpu_torch.")]
    stage1 = {f"pose3d_tpu_torch.stage1.{m}" for m in (
        "api", "port", "yolo11", "yolo_port", "depthpro", "depthpro_port",
        "models")} | {"pose3d_tpu_torch.cli.preprocess"}
    if not stage1 <= set(names):
        raise SystemExit(f"stage-1 modules missing: {stage1 - set(names)}")
    par = {f"pose3d_tpu_torch.{m}" for m in (
        "core.mesh", "core.comm", "parallel.shard", "parallel.fsdp",
        "parallel.tp", "parallel.sp", "parallel.pp", "parallel.dryrun")}
    if not par <= set(names):
        raise SystemExit(f"parallel modules missing: {par - set(names)}")
    if "pose3d_tpu_torch.cli.doctor" not in names:
        raise SystemExit("pose3d_tpu_torch.cli.doctor is missing")
    for name in names:
        importlib.import_module(name)
    banned = ("jax", "jaxlib", "flax", "pose3d_tpu", "transformers",
              "safetensors", "timm", "ultralytics")
    bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
    log(f"[imports] {len(names)} modules of pose3d_tpu_torch imported "
        f"(the {len(stage1)} stage-1 ones among them); of "
        f"{', '.join(banned)} in sys.modules: {bad or 'none'}")
    if bad:
        raise SystemExit(f"the port imported {bad}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--parallel-rank"]:
        return _parallel_rank(sys.argv[2:])
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

    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s "
            f"(script {time.perf_counter() - t_start:.1f} s)")
        return out

    card = timed("environment", phase_environment, torch)
    timed("build", phase_build)
    worst = timed("kernels", phase_kernels, torch)
    contracts = timed("contracts", phase_contracts, torch, card)
    with tempfile.TemporaryDirectory(prefix="pose3d_chip_smoke_") as tmp:
        sl = timed("slice", phase_slice, torch, Path(tmp))
        times = timed("times", phase_times, torch, card, sl)
        del sl
        timed("augment", phase_augment, torch, card)
        rows = timed("rowops", phase_rowops, torch, card)
        tr = timed("train", phase_train, torch, Path(tmp), card)
        cnn = timed("cnn", phase_cnn, torch, Path(tmp), card)
        cli = timed("cli", phase_cli, torch, Path(tmp), card)
        data = timed("data", phase_data, torch, Path(tmp), card)
        export = timed("export", phase_export, torch, Path(tmp), card)
        stage1 = timed("stage1", phase_stage1, torch, Path(tmp), card)
        bg = timed("tools (the doctor; the chains started)", tools_start,
                   torch, Path(tmp), card)
        try:
            par = timed("parallel (beside the tools chains)",
                        phase_parallel, torch, Path(tmp), card)
        except BaseException:
            bg["ex"].shutdown(wait=True)
            raise
        tools = timed("tools (the chains waited for)", phase_tools, torch,
                      Path(tmp), card, bg)
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
        "cli_launches": cli["launches"][name],
        "data_launches": data[name],
        "export_launches": export[name],
        "stage1_launches": stage1[name],
        "parallel_launches": [r[name] for r in par["per_rank"]],
        "tools_launches": tools[name],
        **worst[name],
        **times[key],
        # the shapes beyond the built ones (phase 3b): head depths padded to
        # a built pair, ViT-L's and ViT-H's MLP widths, bf16 lane_resample
        "contract_times": [
            {"shape": list(k[1:]), **v}
            for k, v in contracts["times"].items()
            if CONTRACT_KERNEL[k[0]] == name],
        "contract_launches": contracts["heads8_launches"].get(name, 0),
    } for name, (replaces, launches, key) in kernels.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

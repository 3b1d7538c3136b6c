"""Per-category profile of one train step of the PyTorch/CUDA port on the
card (counterpart of ``scripts/profile_step.py``).

Configurations (full width, seeded random weights and inputs, the
superbatch resident on the device):
  cnn     CNNModelConfig() at 500×500, batch 100, accumulation 1;
  cnn10   the same at the reference's batch 10 × accumulation 10, grouped
          (``--normalization batch_pallas``: scan, the ``bn_stats``
          kernel's path);
  vit     TransformerModelConfig() at 512×512, batch 8, the attention
          kernels.

After ``--warmup`` steps, ``torch.profiler`` traces ``--steps`` steps and
the device time is summed by category: each hand-written kernel by name;
convolutions (cuDNN, forward and backward); matrix products (cuBLAS and
CUTLASS); BatchNorm's elementwise and reduction passes (forward, and the
backward ops autograd links to them); other elementwise and reductions;
the optimizer (AdamW and the EMA); copies (memcpy, memset). A kernel is
placed by its name, else by the operators that launched it. Prints a table
and one JSON line, with the host's step time and the card's name and power
limit.

Runs on the card unless ``--device cpu`` is given (there the CPU
operators' own time stands in for kernels; with ``--model-args`` for a
tiny model):
  python scripts/torch_profile_step.py cnn|cnn10|vit [--normalization ...]
      [--batch B] [--accum A] [--device cuda]
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# symbol prefixes of the hand-written kernels (csrc/*.cu) → their wrapper
KERNEL_PREFIXES = (
    ("attn_fwd", "flash_attention_fwd"),
    ("attn_bwd", "flash_attention_bwd"), ("bwd_prologue", "flash_attention_bwd"),
    ("bwd_rows", "flash_attention_bwd"), ("cast_to_bf16", "flash_attention_bwd"),
    ("bn_stats", "bn_stats"), ("lane_resample", "lane_resample"),
    ("layer_norm_fwd", "layer_norm_fwd"), ("layer_norm_bwd", "layer_norm_bwd"),
    ("mlp_fwd", "mlp_block_fwd"), ("mlp_bwd", "mlp_block_bwd"),
)
CONV_OPS = ("aten::convolution", "aten::_convolution",
            "aten::convolution_backward", "aten::cudnn_convolution")
CONV_WORDS = ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm", "cudnn",
              "winograd")
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
MATMUL_WORDS = ("gemm", "nvjet", "cutlass", "xmma")
BN_MARK = "pose3d.batchnorm"


def _kernel_of(name: str):
    for prefix, module in KERNEL_PREFIXES:
        if name.startswith(prefix) or f" {prefix}" in name \
                or f"::{prefix}" in name:
            return module
    return None


def _ancestors(e):
    while e is not None:
        yield e
        e = e.cpu_parent


def mark_batchnorms(model, names=("BatchNorm", "DotStatsBatchNorm")):
    """Put each BatchNorm module's forward inside a profiler range, so that
    its kernels, and the backward operators autograd links to its forward
    operators, can be told apart from the other elementwise work."""
    import torch

    open_ranges = []

    def pre(module, args):
        rf = torch.autograd.profiler.record_function(BN_MARK)
        rf.__enter__()
        open_ranges.append(rf)

    def post(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    for m in model.modules():
        if type(m).__name__ in names:
            m.register_forward_pre_hook(pre)
            m.register_forward_hook(post)


def summarize(events, device_type: str) -> dict:
    """ms by category over the profiled events: device kernels on a card
    (each with the operator that launched it), the leaf operators' own CPU
    time on the CPU."""
    events = list(events)
    bn_seq = set()
    for e in events:
        if any(a.name == BN_MARK for a in _ancestors(e)) \
                and e.sequence_nr >= 0:
            bn_seq.add(e.sequence_nr)
    items = []
    for e in events:
        if device_type == "cuda":
            items += [(k.name, k.duration, e) for k in e.kernels]
        elif str(e.device_type).endswith("CPU") and not e.cpu_children \
                and e.name.startswith("aten::"):
            items.append((e.name, e.self_cpu_time_total, e))
    by = collections.Counter()
    calls = collections.Counter()
    for name, us, op in items:
        chain = list(_ancestors(op))
        names = [a.name for a in chain]
        kernel = _kernel_of(name)
        if kernel:
            cat = f"kernel {kernel}"
        elif name.startswith(("Memcpy", "Memset")):
            cat = "copies"
        elif any(n in CONV_OPS for n in names) or (
                device_type == "cuda"
                and any(w in name.lower() for w in CONV_WORDS)):
            cat = "convolution"
        elif any(n in MATMUL_OPS for n in names) or (
                device_type == "cuda"
                and any(w in name.lower() for w in MATMUL_WORDS)):
            cat = "matmul (cuBLAS)"
        elif any(n.startswith("Optimizer.") for n in names):
            cat = "optimizer"
        elif any(n == BN_MARK or "BatchNorm" in n or "BnStats" in n
                 for n in names) or any(a.sequence_nr in bn_seq
                                        and "Backward" in a.name
                                        for a in chain):
            cat = "batchnorm elementwise"
        else:
            cat = "other elementwise"
        by[cat] += us
        calls[cat] += 1
    return {k: {"ms": v / 1e3, "calls": calls[k]} for k, v in by.most_common()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kind", choices=("cnn", "cnn10", "vit"))
    ap.add_argument("--batch", type=int, default=None,
                    help="default: cnn 100, cnn10 10, vit 8")
    ap.add_argument("--accum", type=int, default=None,
                    help="default: cnn10 10, else 1")
    ap.add_argument("--normalization", type=str, default=None,
                    help="the CNN's normalization (batch_pallas runs the "
                         "scan accumulation, the mode that takes it)")
    ap.add_argument("--model-args", type=str, default=None,
                    help="JSON model-config overrides")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pose3d_tpu_torch.cli.main import resolve_device
    from pose3d_tpu_torch.core.config import GlobalConfig, make_model_config
    from pose3d_tpu_torch.models import build_model
    from pose3d_tpu_torch.train.state import create_train_state
    from pose3d_tpu_torch.train.step import make_train_step
    from pose3d_tpu_torch.utils.profiling import card_label

    device = resolve_device(args.device)
    card = card_label(device)
    model_type = "transformer" if args.kind == "vit" else "cnn"
    margs = json.loads(args.model_args or "{}")
    if args.normalization:
        margs["normalization"] = args.normalization
    cfg = make_model_config(model_type, **margs)
    B = args.batch or {"cnn": 100, "cnn10": 10, "vit": 8}[args.kind]
    A = args.accum or (10 if args.kind == "cnn10" else 1)
    mode = "scan" if cfg.model_type == "cnn" and \
        cfg.normalization.startswith(("batch_pallas", "batch_dot")) \
        else "grouped"
    model = build_model(cfg, device=device, train=True,
                        dtype=getattr(torch, GlobalConfig().compute_dtype),
                        generator=torch.Generator(device=device).manual_seed(0))
    mark_batchnorms(model)
    state = create_train_state(model, ema=True)
    step = make_train_step(accum_mode=mode, ema_decay=0.999)
    rng = np.random.default_rng(0)
    (h, w), J = cfg.image_size, cfg.num_joints
    batch = {k: torch.from_numpy(v).to(device) for k, v in {
        "image": rng.uniform(size=(A, B, h, w, 3)).astype(np.float32),
        "depth": rng.uniform(1, 8, size=(A, B, h, w, 1)).astype(np.float32),
        "keypoints_2d": rng.uniform(0.1, 0.9, size=(A, B, J, 2)).astype(
            np.float32),
        "joints_3d": (rng.normal(size=(A, B, J, 3)) * 100).astype(
            np.float32)}.items()}
    gen = torch.Generator(device=device).manual_seed(0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(k):
        m = None
        for _ in range(k):
            m = step(state, batch, gen)
        loss = float(m["total_loss"])
        sync()
        return loss

    run(args.warmup)
    t0 = time.perf_counter()
    loss = run(args.steps)
    host_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        run(args.steps)
    cats = summarize(prof.events(), device.type)
    per_step = {k: {"ms": v["ms"] / args.steps, "calls": v["calls"]
                    // args.steps} for k, v in cats.items()}
    total = sum(v["ms"] for v in per_step.values())
    label = (f"{args.kind} {cfg.normalization if model_type == 'cnn' else ''}"
             f" B={B} accum={A} {mode}").replace("  ", " ")
    print(f"== {label} on {card}: host {host_ms:.1f} ms/step, "
          f"{'device kernels' if device.type == 'cuda' else 'CPU operators'}"
          f" {total:.1f} ms/step (loss {loss:.1f})")
    for k, v in per_step.items():
        print(f"  {v['ms']:9.2f} ms/step {100 * v['ms'] / max(total, 1e-9):5.1f}%"
              f" {v['calls']:6d} calls  {k}")
    out = {"config": args.kind, "model_type": model_type,
           "normalization": getattr(cfg, "normalization", None),
           "accum_mode": mode, "batch": B, "accum": A, "card": card,
           "host_step_ms": host_ms, "device_ms": total,
           "images_per_sec": A * B / host_ms * 1e3,
           "timing": ("torch.profiler device kernels"
                      if device.type == "cuda" else "CPU operators"),
           "categories": per_step}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

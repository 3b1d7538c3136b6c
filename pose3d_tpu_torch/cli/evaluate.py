"""Eval-only CLI (counterpart of ``pose3d_tpu/cli/evaluate.py``): load a
checkpoint, run the exact validation pass over a chunk set, print the
MPJPE, PA-MPJPE and loss components as one JSON line.

``--checkpoint`` takes a training checkpoint directory of the port
(``pose3d_tpu_torch.train.checkpoint``; ``--ema`` evaluates its EMA
weights) or a reference-schema ``.pth`` (``pose3d_tpu_torch.checkpoint``,
what ``pose3d-convert --to-torch`` and ``train_model`` write).

Usage:
  python -m pose3d_tpu_torch.cli.evaluate --checkpoint ck --chunks-dir \\
      chunks --val-chunks 0 1 [--per-action] [--json out] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import torch

from pose3d_tpu_torch.cli.main import ATTENTION_IMPL, resolve_device
from pose3d_tpu_torch.core.config import GlobalConfig

logger = logging.getLogger("Evaluate")


def build_parser():
    p = argparse.ArgumentParser(
        description="Evaluate a checkpoint over validation chunks "
                    "(PyTorch/CUDA)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="A training checkpoint directory or a "
                        "reference-schema .pth")
    p.add_argument("--chunks-dir", type=str, required=True)
    p.add_argument("--val-chunks", type=int, nargs="+", default=None)
    p.add_argument("--prefix", type=str, default="test",
                   help="Chunk filename prefix subdirectory (train|test)")
    p.add_argument("--cache-dir", type=str, default=None)
    p.add_argument("--chunk-io", choices=["auto", "stream", "extract"],
                   default="auto",
                   help="Chunk archive access mode (see cli.main)")
    p.add_argument("--pixel-dtype", choices=["uint8", "float32"],
                   default="uint8",
                   help="Host-pipeline pixel representation (see cli.main)")
    p.add_argument("--model-type", choices=["cnn", "transformer"],
                   default=None,
                   help="Architecture hint for converting a BARE torch "
                        "state_dict .pth (self-describing checkpoints "
                        "ignore it)")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device (default: cuda; raises without a card)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--absolute-pose", action="store_true",
                   help="Evaluate absolute camera-space joints (DEP-P) "
                        "instead of root-relative (IND-P)")
    p.add_argument("--compat-pa-metric", action="store_true",
                   help="Report PA-MPJPE with the reference's transposed-"
                        "rotation convention instead of true Procrustes")
    p.add_argument("--attention-backend", type=str, default="pallas",
                   choices=sorted(ATTENTION_IMPL))
    p.add_argument("--ema", action="store_true",
                   help="Evaluate the checkpoint's EMA weights (saved by "
                        "training with --ema-decay)")
    p.add_argument("--per-action", action="store_true",
                   help="Also report MPJPE/PA-MPJPE per Human3.6M action")
    p.add_argument("--json", type=str, default=None,
                   help="Also write the metrics to this JSON file")
    return p


def _load_state(args, device, dtype):
    """(TrainState, step, model_type, image_size) from either checkpoint
    form (``checkpoint.load_pose_model``: ``--ema`` puts a directory's EMA
    weights and statistics into the model)."""
    from pose3d_tpu_torch.checkpoint import checkpoint_step, load_pose_model
    from pose3d_tpu_torch.train.state import create_train_state

    model, cfg = load_pose_model(
        args.checkpoint, device, dtype=dtype, model_type=args.model_type,
        ema=args.ema, attention_impl=ATTENTION_IMPL[args.attention_backend])
    return (create_train_state(model), checkpoint_step(args.checkpoint),
            cfg.model_type, cfg.image_size)


def run(args) -> dict:
    from pose3d_tpu_torch.data.pipeline import (
        BatchLoader,
        StreamingChunkedDataset,
    )
    from pose3d_tpu_torch.train.loop import evaluate
    from pose3d_tpu_torch.train.step import make_eval_step

    device = resolve_device(args.device)
    cfg = GlobalConfig()
    batch_size = args.batch_size or cfg.batch_size
    state, step, model_type, image_size = _load_state(
        args, device, getattr(torch, cfg.compute_dtype))
    logger.info("Evaluating %s checkpoint %s (step %d)%s", model_type,
                args.checkpoint, step, " (EMA weights)" if args.ema else "")

    cache_dir = Path(args.cache_dir) if args.cache_dir else None
    val_ds = StreamingChunkedDataset(
        args.prefix, args.chunks_dir, chunk_indices=args.val_chunks,
        image_size=tuple(image_size), cache_dir=cache_dir,
        shuffle=False, shuffle_chunks=False,
        root_relative=not args.absolute_pose, chunk_io=args.chunk_io,
        pixel_dtype=args.pixel_dtype)
    val_loader = BatchLoader(val_ds, batch_size, drop_last=False)
    eval_step = make_eval_step(compat_pa=args.compat_pa_metric)
    metrics = evaluate(eval_step, state, val_loader,
                       per_action=args.per_action)
    per_action = metrics.pop("per_action", None)
    metrics = {k: float(v) for k, v in metrics.items()}
    metrics["checkpoint_step"] = step

    logger.info("MPJPE      : %.2f mm", metrics["mpjpe"])
    logger.info("PA-MPJPE   : %.2f mm", metrics["pa_mpjpe"])
    for k, v in sorted(metrics.items()):
        if k not in ("mpjpe", "pa_mpjpe", "checkpoint_step"):
            logger.info("%-11s: %.4f", k, v)
    if per_action is not None:
        logger.info("Per-action breakdown (%d actions):", len(per_action))
        for a, m in per_action.items():
            logger.info("  %-18s MPJPE %7.2f  PA-MPJPE %7.2f  (n=%d)",
                        a, m["mpjpe"], m["pa_mpjpe"], m["count"])
        metrics["per_action"] = per_action
    print(json.dumps(metrics))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    return run(build_parser().parse_args(argv))


def cli(argv=None) -> int:
    """Console-script entry: returns 0 (``main`` returns the metrics)."""
    main(argv)
    return 0


if __name__ == "__main__":
    main()

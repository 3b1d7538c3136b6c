"""Export a checkpoint to a self-contained serving artifact (counterpart of
``pose3d_tpu/cli/export.py``).

``--checkpoint`` is a training checkpoint directory of the port (``--ema``:
its EMA weights) or a reference-schema ``.pth``, read by
``checkpoint.load_pose_model`` as in the other CLIs. The lifter's eval forward is traced by
``torch.export`` with the weights inside (:mod:`pose3d_tpu_torch.serve`)
and written as ``<output>/model.pt2`` with a ``meta.json`` sidecar:

    import torch
    program = torch.export.load("exported/model.pt2")   # xla artifacts
    joints = program.module()(image, depth, keypoints_2d)

``--attention-backend xla`` (the default, as in JAX) holds the plain
attention: the program loads with ``torch`` alone. ``pallas`` holds the
custom operator of the hand-written attention forward kernel: load it
where ``pose3d_tpu_torch.serve`` is imported (``serve.load_exported``). The weights stay on the device
they were exported on (``--device``, or the one ``--platforms`` names).

Usage:
  python -m pose3d_tpu_torch.cli.export --checkpoint model.pth \\
      --output exported/ [--batch-size 8] [--quantize int8] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

import torch

from pose3d_tpu_torch.cli.main import ATTENTION_IMPL, resolve_device
from pose3d_tpu_torch.core.config import GlobalConfig

logger = logging.getLogger("pose3d_tpu_torch.export")

# --platforms names this package takes, and the device each places the
# weights on
PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export a checkpoint to a self-contained torch.export "
                    "serving artifact (PyTorch/CUDA)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="A training checkpoint directory or a "
                        "reference-schema .pth")
    p.add_argument("--output", type=str, required=True,
                   help="Output artifact directory")
    p.add_argument("--batch-size", type=str, default="dynamic",
                   help="Static batch size, or 'dynamic' (default) for a "
                        "symbolic batch dimension: one artifact serves any "
                        "request size")
    p.add_argument("--device", type=str, default=None,
                   help="Device the artifact's weights live on (default: "
                        "cuda; raises without a card)")
    p.add_argument("--platforms", type=str, nargs="+", default=None,
                   help="One device for the artifact's weights: cuda (or "
                        "gpu) or cpu. A program of torch.export holds its "
                        "weights on one device, so several are refused")
    p.add_argument("--attention-backend", type=str, default="xla",
                   choices=sorted(ATTENTION_IMPL),
                   help="xla (default) keeps the artifact to plain torch "
                        "operators; pallas holds the hand-written attention "
                        "kernel's custom operator (loads with "
                        "pose3d_tpu_torch imported)")
    p.add_argument("--ema", action="store_true",
                   help="Export the checkpoint's EMA weights (recorded by "
                        "training with --ema-decay)")
    p.add_argument("--model-type", choices=["cnn", "transformer"],
                   default=None,
                   help="Architecture hint for a bare state_dict .pth")
    p.add_argument("--quantize", type=str, default=None, choices=["int8"],
                   help="weight-only per-channel int8 of the large kernels: "
                        "~4x smaller artifact, dequantised inside the "
                        "program")
    return p


def _device(parser, args) -> torch.device:
    """``--device`` (default cuda), or the one device ``--platforms``
    names."""
    if args.platforms is None:
        return resolve_device(args.device or "cuda")
    names = [p.lower() for p in args.platforms]
    unknown = [p for p in names if p not in PLATFORMS]
    if unknown:
        parser.error(f"--platforms {' '.join(args.platforms)}: {unknown} is "
                     "not a device of this package (cuda, gpu or cpu; "
                     "TPU artifacts come from pose3d_tpu.cli.export)")
    devices = {PLATFORMS[p] for p in names}
    if len(devices) > 1:
        parser.error(f"--platforms {' '.join(args.platforms)}: a "
                     "torch.export program holds its weights on one device; "
                     "export once per device")
    (device,) = devices
    if args.device is not None and torch.device(args.device).type != device:
        parser.error(f"--platforms {device} and --device {args.device} "
                     "disagree")
    return resolve_device(args.device or device)


def main(argv: Optional[List[str]] = None) -> str:
    logging.basicConfig(level=logging.INFO)
    parser = build_parser()
    args = parser.parse_args(argv)

    from pose3d_tpu_torch.checkpoint import checkpoint_step, load_pose_model
    from pose3d_tpu_torch.serve import export_lifter, save_exported

    device = _device(parser, args)
    batch = None if args.batch_size == "dynamic" else int(args.batch_size)
    model, cfg = load_pose_model(
        args.checkpoint, device,
        dtype=getattr(torch, GlobalConfig().compute_dtype),
        model_type=args.model_type, ema=args.ema,
        attention_impl=ATTENTION_IMPL[args.attention_backend])
    exported = export_lifter(model, batch_size=batch,
                             quantize=args.quantize)
    path = save_exported(exported, args.output, extra_meta={
        "model_type": cfg.model_type,
        "checkpoint_step": checkpoint_step(args.checkpoint),
        "image_size": list(cfg.image_size),
        "batch": args.batch_size,
        "quantize": args.quantize,
        "ema": bool(args.ema),
        "attention_backend": args.attention_backend,
        "dtype": str(model.dtype).removeprefix("torch."),
    })
    logger.info("Wrote serving artifact to %s", path)
    return str(path)


def cli(argv=None) -> int:
    """Console-script entry: returns 0 (``main`` returns the artifact's
    path)."""
    main(argv)
    return 0

if __name__ == "__main__":
    sys.exit(0 if main() else 1)

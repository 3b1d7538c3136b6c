"""Checkpoint converter between the reference's torch ``.pth`` and the
port's training checkpoint directories (counterpart of
``pose3d_tpu/cli/convert.py``).

Default direction: a reference ``.pth`` (self-describing, a bare
state_dict, or ``module.``-prefixed keys) becomes a training checkpoint
directory that ``cli.main --checkpoint`` resumes and ``cli.evaluate``,
``cli.infer`` and ``cli.export`` read. The optimizer state is not carried
over: the AdamW moments start at zero, as the JAX converter's fresh optax
state does. ``--to-torch`` writes a checkpoint directory as a
reference-schema ``.pth`` (:func:`pose3d_tpu_torch.compat_export.
export_torch_checkpoint`). The JAX package's orbax directories are read by
``pose3d_tpu.cli.convert`` only.

Usage:
  python -m pose3d_tpu_torch.cli.convert ref_model.pth out_checkpoint_dir
  python -m pose3d_tpu_torch.cli.convert ckpt_dir model.pth --to-torch
"""

from __future__ import annotations

import argparse
import logging

import torch

logger = logging.getLogger("Convert")


def _zero_moments(state) -> None:
    """AdamW's state as its first step would make it, for every trainable
    parameter: step 0, zero moments (optax's ``adamw`` init)."""
    for p in state.trainable():
        state.optimizer.state[p] = {
            "step": torch.tensor(0.0, dtype=torch.float32),
            "exp_avg": torch.zeros_like(p,
                                        memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(
                p, memory_format=torch.preserve_format),
        }


def convert(pth_path: str, out_dir: str, model_type: str = None) -> str:
    """Write the ``.pth`` at ``pth_path`` as a training checkpoint
    directory ``out_dir`` (the file's ``step``, zero AdamW moments);
    ``model_type`` is the hint for a file that does not name its
    architecture (default "cnn", as the reference's). Returns the
    directory."""
    from pose3d_tpu_torch.checkpoint import checkpoint_step, load_pose_model
    from pose3d_tpu_torch.train.checkpoint import save_checkpoint
    from pose3d_tpu_torch.train.state import create_train_state

    model, cfg = load_pose_model(pth_path, "cpu", dtype=torch.float32,
                                 model_type=model_type, train=True)
    state = create_train_state(model)
    _zero_moments(state)
    state.step = checkpoint_step(pth_path)
    path = save_checkpoint(out_dir, state, cfg.model_type, cfg.to_dict())
    logger.info("Converted %s (step %d) -> %s", pth_path, state.step, path)
    return str(path)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Convert checkpoints between the reference's torch "
                    ".pth format and pose3d_tpu_torch checkpoint "
                    "directories (default: .pth -> directory; --to-torch "
                    "reverses)")
    p.add_argument("src", metavar="pth", type=str,
                   help="source: a reference .pth (default direction) or a "
                        "checkpoint directory (--to-torch)")
    p.add_argument("out", type=str,
                   help="destination: checkpoint directory (default) or "
                        ".pth path (--to-torch)")
    p.add_argument("--model-type", type=str, default=None,
                   choices=["cnn", "transformer"],
                   help="Architecture for bare state_dicts that carry no "
                        "model_type (self-describing checkpoints ignore it)")
    p.add_argument("--to-torch", action="store_true",
                   help="Reverse direction: a checkpoint directory to a "
                        "reference-format .pth, AdamW moments included")
    p.add_argument("--ema", action="store_true",
                   help="--to-torch: export the EMA weights recorded by "
                        "--ema-decay training (omits optimizer state)")
    p.add_argument("--no-optimizer", action="store_true",
                   help="--to-torch: write momentum-free optimizer state")
    p.add_argument("--lr", type=float, default=None,
                   help="--to-torch: AdamW lr recorded in param_groups "
                        "(default 1e-3)")
    p.add_argument("--weight-decay", type=float, default=None,
                   help="--to-torch: AdamW weight decay in param_groups "
                        "(default 0.01)")
    return p


def main(argv=None) -> int:
    """Returns 0, so that the console script's ``sys.exit(main())``
    reports success."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if args.to_torch:
        from pose3d_tpu_torch.compat_export import export_torch_checkpoint

        export_torch_checkpoint(
            args.src, args.out, ema=args.ema,
            lr=args.lr if args.lr is not None else 1e-3,
            weight_decay=(args.weight_decay
                          if args.weight_decay is not None else 0.01),
            include_optimizer=not args.no_optimizer)
        return 0
    if args.ema or args.no_optimizer or args.lr is not None \
            or args.weight_decay is not None:
        raise SystemExit("--ema/--no-optimizer/--lr/--weight-decay apply to "
                         "--to-torch only")
    convert(args.src, args.out, model_type=args.model_type)
    return 0


if __name__ == "__main__":
    main()

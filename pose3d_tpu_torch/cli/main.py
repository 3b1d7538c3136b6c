"""Training CLI (counterpart of ``pose3d_tpu/cli/main.py``).

seed → TensorBoard run directory → (resume: the architecture rebuilt from
the checkpoint's ``model_args``, the data stream fast-forwarded to the
recorded position) → streaming chunked datasets → ``train_model`` with
accumulation, validation and checkpoints. SIGTERM asks for a graceful
stop: the step in flight finishes, a checkpoint with the data position is
written, and the process exits 0; the same command line with
``--checkpoint auto`` resumes it.

Runs on the card (``--device cuda``, the default; without CUDA it
raises) unless ``--device cpu`` is given.

Usage:
  python -m pose3d_tpu_torch.cli.main --chunks-dir /data/chunks \\
      --train-chunks 0 1 2 --val-chunks 3 --model-type cnn \\
      --checkpoint auto

``--vit-weights`` initialises the transformer's ViT backbone from a timm
ViT state_dict (``stage1/port.py``'s ``port_vit_backbone``: the patch
embedding inflated to the input's channels, the position grid resized).
Flags of features not ported yet (the mesh and multi-process flags) are
refused with an error that names ROADMAP.md.
"""

from __future__ import annotations

import argparse
import json
import logging
import random
import signal
import threading
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from pose3d_tpu_torch.core.config import GlobalConfig, make_model_config
from pose3d_tpu_torch.data.pipeline import BatchLoader, StreamingChunkedDataset
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.ops.losses import LossWeights
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train.loop import train_model
from pose3d_tpu_torch.train.state import create_train_state, make_lr_schedule

logger = logging.getLogger("Training")

# flag → what it would need; each is refused, never accepted and ignored
NOT_PORTED = {
    "param_sharding": "parameter sharding (parallel/fsdp.py)",
    "multislice": "hybrid meshes (core/mesh.py)",
    "coordinator": "multi-process training (core/mesh.py)",
    "num_processes": "multi-process training (core/mesh.py)",
    "process_id": "multi-process training (core/mesh.py)",
}
# --attention-backend → the transformer's attention_impl
ATTENTION_IMPL = {"pallas": "auto", "xla": "reference"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train on the streaming Human3.6M chunks (PyTorch/CUDA)")
    p.add_argument("--chunks-dir", type=str, required=True,
                   help="Directory containing the chunked dataset")
    p.add_argument("--train-chunks", type=int, nargs="+",
                   help="Chunk indices to use for training")
    p.add_argument("--val-chunks", type=int, nargs="+",
                   help="Chunk indices to use for validation")
    p.add_argument("--cache-dir", type=str, default=None,
                   help="Directory to cache extracted chunks")
    p.add_argument("--chunk-io", choices=["auto", "stream", "extract"],
                   default="auto",
                   help="Chunk archive access: 'stream' inflates each "
                        "archive into memory, 'extract' uses the cache-dir "
                        "extraction, 'auto' streams but reuses an existing "
                        "extracted copy")
    p.add_argument("--pixel-dtype", choices=["uint8", "float32"],
                   default="uint8",
                   help="Host-pipeline pixel representation: 'uint8' "
                        "(default) keeps decoded pixels in byte form up to "
                        "the card, which decodes them; 'float32' is the "
                        "reference-shaped float decode")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to train on (default: cuda; raises without "
                        "a card). --device cpu trains on the CPU")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Checkpoint directory to resume from, or 'auto' for "
                        "the newest checkpoint of this prefix and model "
                        "type (a fresh start when there is none)")
    p.add_argument("--start-step", type=int,
                   help="Global step index to resume from")
    p.add_argument("--no-resume-data", action="store_true",
                   help="When resuming, do NOT fast-forward the training "
                        "data stream to the checkpoint's data_state; start "
                        "it from epoch 0")
    p.add_argument("--keep-checkpoints", type=int, default=None,
                   help="Keep only the N newest checkpoints (the best by "
                        "validation MPJPE is always kept). Default: all")
    p.add_argument("--profile-steps", type=int, default=None,
                   help="Write a torch.profiler trace of this many "
                        "optimizer steps (Chrome / TensorBoard format)")
    p.add_argument("--profile-at", type=int, default=None,
                   help="Step AFTER which the profiler window opens "
                        "(default: start step + 5)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="Trace directory (default: the run's TensorBoard "
                        "directory, or {checkpoint_prefix}_profile without "
                        "TensorBoard)")
    p.add_argument("--memory-report", action="store_true",
                   help="Log the card's allocator peak after the first "
                        "optimizer step")
    p.add_argument("--model-type", type=str, choices=["cnn", "transformer"],
                   help="Model type: 'cnn' or 'transformer'")
    p.add_argument("--num-steps", type=int, default=None,
                   help="Stop after this many optimizer steps")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--grad-accum", type=int, default=None)
    p.add_argument("--eval-interval", type=int, default=None)
    p.add_argument("--log-interval", type=int, default=10,
                   help="Read back and log the train metrics every N "
                        "optimizer steps")
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--lr-schedule", type=str, default="constant",
                   choices=["constant", "cosine", "linear"],
                   help="Learning-rate schedule (default: constant). "
                        "cosine/linear decay over --schedule-steps "
                        "(default --num-steps)")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="Linear LR warmup steps")
    p.add_argument("--schedule-steps", type=int, default=None,
                   help="Decay horizon of cosine/linear schedules")
    p.add_argument("--min-lr-factor", type=float, default=0.0,
                   help="Final LR as a fraction of the peak for "
                        "cosine/linear schedules")
    p.add_argument("--clip-grad-norm", type=float, default=None,
                   help="Clip gradients to this global norm before AdamW")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="Keep an exponential moving average of the weights "
                        "(e.g. 0.999); validation, previews and best "
                        "tracking use it, and checkpoints carry it "
                        "(cli.evaluate --ema)")
    p.add_argument("--no-tensorboard", action="store_true",
                   help="Disable TensorBoard logging")
    p.add_argument("--augment", action="store_true",
                   help="Enable data augmentation on the train set "
                        "(host-side, reference-parity path)")
    p.add_argument("--augment-device", action="store_true",
                   help="Augment on the device inside the train step "
                        "(ops/augment_device): flip, scale, translate and "
                        "colour; rotation with --augment-device-rotation")
    p.add_argument("--augment-device-rotation", action="store_true",
                   help="Include rotation in --augment-device (the "
                        "two-pass warp over the lane_resample kernel)")
    p.add_argument("--absolute-pose", action="store_true",
                   help="Train on absolute camera-space joints (DEP-P) "
                        "instead of root-relative (IND-P)")
    p.add_argument("--freeze-backbone", action="store_true",
                   help="Freeze the ViT backbone except the adapted "
                        "patch-embed (transformer only)")
    p.add_argument("--attention-backend", type=str, default="pallas",
                   choices=sorted(ATTENTION_IMPL),
                   help="Transformer attention: 'pallas' (the hand-written "
                        "kernels on the card) or 'xla' (the plain PyTorch "
                        "pair)")
    p.add_argument("--remat", action="store_true",
                   help="Recompute the model's blocks in the backward "
                        "pass (the CNN's backbone blocks and WASP, the "
                        "transformer's encoder and fusion blocks): lower "
                        "peak memory at a throughput cost")
    p.add_argument("--accum-mode", type=str, default="grouped",
                   choices=["grouped", "scan"],
                   help="Gradient accumulation: 'grouped' (default) one "
                        "flat batch with per-microbatch BatchNorm "
                        "statistics; 'scan' the microbatches in sequence "
                        "(lowest peak memory; the mode of "
                        "normalization=batch_pallas)")
    p.add_argument("--model-args", type=str, default=None,
                   help="JSON dict of model-config overrides (same keys as "
                        "checkpoint model_args)")
    p.add_argument("--compat-pa-metric", action="store_true",
                   help="Report PA-MPJPE with the reference's transposed-"
                        "rotation convention instead of true Procrustes")
    p.add_argument("--vit-weights", type=str, default=None,
                   help="Pretrained timm-format ViT weights "
                        "(.pth/.safetensors, vit_base_patch16_384 family) "
                        "to initialize the transformer backbone")
    # not ported yet: refused in main()
    p.add_argument("--param-sharding", type=str, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--multislice", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--coordinator", type=str, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--num-processes", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--process-id", type=int, default=None,
                   help=argparse.SUPPRESS)
    return p


def resolve_device(name: str) -> torch.device:
    """``--device``; a card that is asked for and absent raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available (pass --device cpu to "
            "run on the CPU)")
    return device


def _load_vit_weights(model, model_cfg, path, resuming: bool,
                      checkpoint) -> None:
    """``--vit-weights``: the transformer's ``vit_backbone`` from a timm ViT
    state_dict, as the JAX CLI does (a CNN refuses it; a resumed checkpoint
    already carries the backbone, so the file is ignored with a
    warning)."""
    if model_cfg.model_type != "transformer":
        raise SystemExit("--vit-weights only applies to the transformer "
                         "model")
    if resuming:
        logger.warning("--vit-weights ignored: checkpoint %s carries the "
                       "full backbone state", checkpoint)
        return
    from pose3d_tpu_torch.stage1.port import (
        load_torch_state_dict,
        port_vit_backbone,
    )

    n_patches = ((model_cfg.image_size[0] // model_cfg.vit_patch_size)
                 * (model_cfg.image_size[1] // model_cfg.vit_patch_size))
    ported = port_vit_backbone(
        load_torch_state_dict(path), depth=model_cfg.vit_depth,
        in_channels=model_cfg.image_in_channels, num_patches=n_patches)
    with torch.no_grad():
        model.vit_backbone.load_state_dict(ported, strict=True)
    logger.info("Initialized ViT backbone from %s", path)


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag, what in NOT_PORTED.items():
        if getattr(args, flag) is not None and getattr(args, flag) is not False:
            parser.error(f"--{flag.replace('_', '-')}: {what} is not ported "
                         "to pose3d_tpu_torch yet (ROADMAP.md Queue 1)")
    if args.augment_device_rotation and not args.augment_device:
        parser.error("--augment-device-rotation requires --augment-device")
    if args.augment and args.augment_device:
        parser.error("--augment (host) and --augment-device are mutually "
                     "exclusive — pick one augmentation path")
    device = resolve_device(args.device)
    cfg = GlobalConfig()
    np.random.seed(cfg.random_seed)
    random.seed(cfg.random_seed)

    def _or(v, default):
        return v if v is not None else default

    batch_size = _or(args.batch_size, cfg.batch_size)
    accum = _or(args.grad_accum, cfg.gradient_accumulation_steps)
    eval_interval = _or(args.eval_interval, cfg.eval_interval)
    lr = _or(args.learning_rate, cfg.learning_rate)

    cache_dir = Path(args.cache_dir) if args.cache_dir else None
    if cache_dir:
        cache_dir.mkdir(parents=True, exist_ok=True)

    model_type = (args.model_type or cfg.model_type).lower()
    start_step = 0
    if args.checkpoint == "auto":
        found = ckpt.latest_checkpoint(cfg.checkpoint_prefix, model_type)
        args.checkpoint = str(found) if found is not None else None
        logger.info("Auto-resume: %s", found or "no checkpoint — fresh start")

    model_args = json.loads(args.model_args) if args.model_args else {}
    data_state = None
    resuming = bool(args.checkpoint) and Path(args.checkpoint).exists()
    if resuming:
        # the checkpoint's model_args take precedence
        meta = ckpt.load_checkpoint_meta(args.checkpoint)
        model_type = meta.get("model_type", model_type)
        model_args = {**model_args, **meta.get("model_args", {})}
        start_step = meta.get("step", 0)
        if not args.no_resume_data:
            data_state = meta.get("data_state")
        logger.info("Resuming %s from %s at step %d", model_type,
                    args.checkpoint, start_step)
        if data_state:
            logger.info("Resuming the data stream: epoch %d, %d samples "
                        "consumed (--no-resume-data disables)",
                        data_state["epoch"], data_state["samples_consumed"])
    elif args.checkpoint:
        logger.warning("Checkpoint not found: %s, training from scratch.",
                       args.checkpoint)

    model_cfg = make_model_config(model_type, **model_args)
    model = build_model(
        model_cfg, device=device, dtype=getattr(torch, cfg.compute_dtype),
        attention_impl=ATTENTION_IMPL[args.attention_backend],
        remat=args.remat, train=True)
    if args.vit_weights:
        _load_vit_weights(model, model_cfg, args.vit_weights, resuming,
                          args.checkpoint)
    freeze_kw = {}
    if args.freeze_backbone and model_type == "transformer":
        freeze_kw = dict(frozen_prefixes=("vit_backbone",),
                         trainable_exceptions=("vit_backbone/patch_embed",))
    schedule = make_lr_schedule(
        args.lr_schedule, warmup_steps=args.warmup_steps,
        decay_steps=args.schedule_steps or args.num_steps,
        end_lr_factor=args.min_lr_factor)
    state = create_train_state(
        model, learning_rate=lr, weight_decay=cfg.weight_decay,
        lr_schedule=schedule, clip_grad_norm=args.clip_grad_norm,
        ema=args.ema_decay is not None, **freeze_kw)
    if resuming:
        state, _ = ckpt.restore_train_state(state, args.checkpoint)
        if args.ema_decay is not None and not ckpt.checkpoint_has_ema(
                args.checkpoint):
            # the mirror was seeded from the random init: seed it from the
            # restored weights instead
            logger.info("Checkpoint has no EMA weights — seeding the EMA "
                        "mirror from the restored parameters.")
            state.ema_params = {n: p.detach().clone()
                                for n, p in model.named_parameters()}
            if state.ema_batch_stats is not None:
                from pose3d_tpu_torch.train.state import batch_stats

                state.ema_batch_stats = {
                    n: b.detach().clone()
                    for n, b in batch_stats(model).items()}
    if args.start_step is not None:
        start_step = args.start_step

    log_dir = None
    if args.no_tensorboard:
        from pose3d_tpu_torch.train.tb import NullWriter

        writer = NullWriter()
    else:
        from pose3d_tpu_torch.train.tb import SummaryWriter

        log_dir = Path(cfg.log_dir) / datetime.now().strftime("%Y%m%d-%H%M%S")
        writer = SummaryWriter(log_dir)
        logger.info("TensorBoard logs: %s", log_dir)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("Device: %s%s", device, f" ({torch.cuda.get_device_name(device)})"
                if device.type == "cuda" else "")
    logger.info("Model type: %s (%.1fM params)", model_type, n_params / 1e6)
    writer.add_text("Model/summary", f"```\n{model}\n```")
    logger.info("Effective batch size: %d", batch_size * accum)
    logger.info("Resume from step: %d", start_step)

    image_size = tuple(model_cfg.image_size)
    root_relative = not args.absolute_pose
    train_ds = StreamingChunkedDataset(
        "train", args.chunks_dir, chunk_indices=args.train_chunks,
        image_size=image_size, cache_dir=cache_dir,
        use_augmentation=args.augment,
        shuffle=True, shuffle_chunks=True, root_relative=root_relative,
        chunk_io=args.chunk_io, pixel_dtype=args.pixel_dtype)
    train_ds.training = True
    if data_state:
        train_ds.set_epoch(int(data_state["epoch"]))
        train_ds.skip_next_samples(int(data_state["samples_consumed"]))
    val_ds = StreamingChunkedDataset(
        "test", args.chunks_dir, chunk_indices=args.val_chunks,
        image_size=image_size, cache_dir=cache_dir, shuffle=True,
        shuffle_chunks=True, root_relative=root_relative,
        chunk_io=args.chunk_io, pixel_dtype=args.pixel_dtype)
    train_loader = BatchLoader(train_ds, batch_size, loop=True)
    val_loader = BatchLoader(val_ds, batch_size, drop_last=False)

    weights = LossWeights(
        mse=cfg.mse_loss_weight, l1=cfg.l1_loss_weight,
        inter_joint=cfg.inter_joint_loss_weight,
        abs_root=cfg.abs_root_loss_weight)

    # SIGTERM (a preemption) asks for a graceful stop: finish the step in
    # flight, checkpoint with the data position, return. SIGINT keeps its
    # KeyboardInterrupt path (the same save inside train_model).
    stop_event = threading.Event()

    def _on_sigterm(signum, frame):
        logger.warning("SIGTERM received — will checkpoint and exit after "
                       "the current optimizer step.")
        stop_event.set()

    previous = None
    try:
        previous = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # not the main thread (embedded use): no handler

    augment = None
    if args.augment_device:
        from pose3d_tpu_torch.ops.augment_device import (
            DeviceAugmentConfig,
            make_device_augment,
        )

        augment = make_device_augment(DeviceAugmentConfig(
            enable_rotation=args.augment_device_rotation))
    profile = None
    if args.profile_steps:
        profile = (
            args.profile_at if args.profile_at is not None
            else start_step + 5,
            args.profile_steps,
            args.profile_dir or (str(log_dir) if log_dir is not None
                                 else f"{cfg.checkpoint_prefix}_profile"))
    try:
        state, last_step = train_model(
            state, train_loader, val_loader,
            writer=writer, loss_weights=weights,
            gradient_accumulation_steps=accum, start_step=start_step,
            num_steps=args.num_steps, eval_interval_steps=eval_interval,
            log_interval_steps=args.log_interval,
            preview_interval_steps=cfg.preview_interval,
            generator=torch.Generator(device=device).manual_seed(
                cfg.random_seed),
            accum_mode=args.accum_mode, ema_decay=args.ema_decay,
            augment=augment, compat_pa_metric=args.compat_pa_metric,
            checkpoint_prefix=cfg.checkpoint_prefix, model_type=model_type,
            model_args=model_cfg.to_dict(), data_state=data_state,
            stop_event=stop_event, keep_checkpoints=args.keep_checkpoints,
            profile=profile, memory_report=args.memory_report)
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
        writer.close()
    logger.info("Training complete at step %d", last_step)
    return last_step


def cli(argv=None) -> int:
    """Console-script entry: returns 0 (``main`` returns the last step)."""
    main(argv)
    return 0


if __name__ == "__main__":
    main()

"""Training orchestration (counterpart of ``pose3d_tpu/train/loop.py``).

``train_model`` groups the loader's batches into [A, B, ...] superbatches
(uint8-compact on the host, decoded on the device), makes one optimizer
step per superbatch, reads the metrics back once every
``log_interval_steps`` steps, runs the exact validation every
``eval_interval_steps`` steps, and on any exit writes the live weights as
a reference-schema ``.pth`` (``pose3d_tpu_torch.checkpoint``), the file
``serve_http`` loads.

Not ported yet (ROADMAP.md): TensorBoard, previews, SIGTERM stop,
checkpoint retention and best tracking, optimizer-state checkpoints and
data-state resume, profiling windows, meshes.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from pose3d_tpu_torch.checkpoint import save_pose_model
from pose3d_tpu_torch.data.collate import compact_batch
from pose3d_tpu_torch.ops.losses import LossWeights
from pose3d_tpu_torch.train.state import TrainState, with_ema_params
from pose3d_tpu_torch.train.step import make_eval_step, make_train_step

logger = logging.getLogger("pose3d_tpu_torch.train")

BATCH_KEYS = ("image", "depth", "keypoints_2d", "joints_3d", "depth_scale")


class NullWriter:
    """Scalar sink with the TensorBoard writer's interface; records
    nothing."""

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def flush(self) -> None:
        pass


def _superbatches(loader: Iterable[Dict], accum: int):
    """Group raw numpy batches into [A, B, ...] superbatches, dropping a
    ragged tail, with pixels re-encoded as uint8 + depth scale for the
    host→device copy. The last microbatch's ``_pos`` (data-stream
    position) rides along."""
    it = iter(loader)
    while True:
        group = list(itertools.islice(it, accum))
        if len(group) < accum:
            return
        group = [compact_batch(g) for g in group]
        out = {k: np.stack([g[k] for g in group])
               for k in BATCH_KEYS if k in group[0]}
        if "_pos" in group[-1]:
            out["_pos"] = group[-1]["_pos"]
        yield out


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy arrays → tensors on ``device`` (uint8 stays uint8); keys
    starting with "_" are host metadata and are dropped."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                device, non_blocking=True)
            for k, v in batch.items() if not k.startswith("_")}


def evaluate(eval_step, state: TrainState,
             val_loader: Iterable[Dict]) -> Dict[str, float]:
    """Sample-weighted averages of the loss components, MPJPE and PA-MPJPE
    over the whole loader, with ``eval_step`` from ``make_eval_step``
    (per-sample metrics). Eager PyTorch runs a ragged last batch at its
    own size, so the averages are exact without the JAX package's
    padding and mask."""
    device = next(state.model.parameters()).device
    totals: Dict[str, torch.Tensor] = {}
    count = 0
    for batch in val_loader:
        bs = batch["image"].shape[0]
        db = {k: batch[k] for k in BATCH_KEYS if k in batch}
        metrics, _ = eval_step(state, to_device(db, device))
        for k, v in metrics.items():
            s = v.double().sum()
            totals[k] = totals[k] + s if k in totals else s
        count += bs
    if count == 0:
        raise RuntimeError("Validation loader yielded no batches "
                           "(an empty validation would otherwise be silent)")
    return {k: float(v) / count for k, v in totals.items()}


def train_model(
    state: TrainState,
    train_loader: Iterable[Dict],
    val_loader: Optional[Iterable[Dict]] = None,
    *,
    writer=None,
    loss_weights: LossWeights = LossWeights(),
    gradient_accumulation_steps: int = 1,
    num_steps: Optional[int] = None,
    eval_interval_steps: int = 5000,
    log_interval_steps: int = 10,
    max_epochs: int = 10_000,
    generator: Optional[torch.Generator] = None,
    accum_mode: str = "grouped",
    ema_decay: Optional[float] = None,
    checkpoint_path=None,
    augment=None,
    augment_generator: Optional[torch.Generator] = None,
    compat_pa_metric: bool = False,
):
    """Train ``state`` in place over ``train_loader`` (numpy batches of
    ``image``, ``depth``, ``keypoints_2d``, ``joints_3d``); returns
    ``(state, global_step)``.

    ``generator`` draws the dropout masks (default: a generator on the
    model's device seeded 42, the config's ``random_seed``). Validation
    runs on the EMA weights when ``ema_decay`` is set. ``writer`` receives
    ``Loss/train_step`` and ``Loss_Components/*`` per step,
    ``Perf/step_time_ms`` and ``Perf/images_per_sec`` per log window after
    the first, ``Train/learning_rate`` per log window when the state has a
    schedule, and at a validation ``Loss/validation_epoch_avg``,
    ``Metrics/MPJPE_validation_epoch_avg``,
    ``Metrics/PA_MPJPE_validation_epoch_avg`` (``compat_pa_metric`` selects
    the reference's transposed Procrustes rotation) and
    ``Loss_Components_Val/*`` for every loss component.
    ``checkpoint_path``: where the ``.pth`` is written when training ends,
    if any step ran: also after Ctrl-C, which ends training and returns
    like any other end.

    ``max_epochs`` bounds the passes over ``train_loader``; a loader that
    loops by itself and stamps its batches with ``_pos`` (epoch, index) is
    stopped once that epoch counter reaches ``max_epochs``.

    ``augment`` (``ops.augment_device.make_device_augment(cfg)``) augments
    every training batch on the device inside the step; it draws from
    ``augment_generator`` (default: a generator on the model's device,
    seeded apart from the dropout's), never from ``generator``."""
    writer = writer or NullWriter()
    model = state.model
    device = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(42)
    if augment is not None and augment_generator is None:
        # 0x617567 = "aug": a stream apart from the dropout's
        augment_generator = torch.Generator(device=device).manual_seed(
            42 + 0x617567)
    train_step = make_train_step(loss_weights, accum_mode=accum_mode,
                                 ema_decay=ema_decay, augment=augment)
    eval_step = make_eval_step(loss_weights, compat_pa=compat_pa_metric)
    target = num_steps if num_steps is not None else float("inf")
    start_step = global_step = state.step

    pending_steps: list = []
    pending_metrics: list = []
    pending_images = 0
    flushes = 0
    stopped = False
    window_t0 = time.perf_counter()

    def flush_metrics():
        nonlocal pending_images, window_t0, flushes
        if not pending_metrics:
            return
        keys = sorted(pending_metrics[0])
        vals = torch.stack([torch.stack([m[k].float() for k in keys])
                            for m in pending_metrics]).cpu().numpy()
        dt = time.perf_counter() - window_t0
        for i, step_i in enumerate(pending_steps):
            writer.add_scalar("Loss/train_step",
                              float(vals[i, keys.index("total_loss")]),
                              step_i)
            for j, k in enumerate(keys):
                writer.add_scalar(f"Loss_Components/{k}", float(vals[i, j]),
                                  step_i)
        if state.scheduler is not None:
            # the rate the next update will use, as optax's schedule gives it
            # at this count
            writer.add_scalar("Train/learning_rate",
                              float(state.optimizer.param_groups[0]["lr"]),
                              pending_steps[-1])
        flushes += 1
        rate = ""
        if flushes > 1:  # the first window holds the kernels' builds
            writer.add_scalar("Perf/step_time_ms",
                              dt / len(pending_steps) * 1e3,
                              pending_steps[-1])
            writer.add_scalar("Perf/images_per_sec", pending_images / dt,
                              pending_steps[-1])
            rate = f", {pending_images / dt:.1f} img/s"
        logger.info("Step %d: loss %.4f%s", pending_steps[-1],
                    float(vals[-1, keys.index("total_loss")]), rate)
        pending_steps.clear()
        pending_metrics.clear()
        pending_images = 0
        window_t0 = time.perf_counter()

    try:
        for _epoch in range(max_epochs):
            if global_step >= target or stopped:
                break
            for superbatch in _superbatches(train_loader,
                                            gradient_accumulation_steps):
                if global_step >= target or stopped:
                    break
                pos = superbatch.get("_pos")
                batch = to_device(superbatch, device)
                metrics = train_step(state, batch, generator,
                                     augment_generator)
                global_step = state.step
                if pos is not None and int(pos[0]) >= max_epochs:
                    # a looping loader never ends a pass: the cap comes from
                    # the stream's own epoch counter; the stop waits for the
                    # loop head so that this step is still logged
                    logger.warning("max_epochs=%d reached at step %d: "
                                   "stopping.", max_epochs, global_step)
                    stopped = True
                pending_steps.append(global_step)
                pending_metrics.append(metrics)
                pending_images += (batch["image"].shape[0]
                                   * batch["image"].shape[1])
                if (len(pending_steps) >= log_interval_steps
                        or global_step % eval_interval_steps == 0):
                    flush_metrics()
                if (global_step % eval_interval_steps == 0
                        and val_loader is not None):
                    view = (with_ema_params(state) if ema_decay is not None
                            else contextlib.nullcontext(state))
                    with view:
                        val = evaluate(eval_step, state, val_loader)
                    writer.add_scalar("Loss/validation_epoch_avg",
                                      val["total_loss"], global_step)
                    writer.add_scalar("Metrics/MPJPE_validation_epoch_avg",
                                      val["mpjpe"], global_step)
                    writer.add_scalar(
                        "Metrics/PA_MPJPE_validation_epoch_avg",
                        val["pa_mpjpe"], global_step)
                    for k, v in val.items():
                        if k not in ("mpjpe", "pa_mpjpe"):
                            writer.add_scalar(f"Loss_Components_Val/{k}", v,
                                              global_step)
                    logger.info("Step %d: Val Loss: %.4f, MPJPE: %.2f mm, "
                                "PA-MPJPE: %.2f mm", global_step,
                                val["total_loss"], val["mpjpe"],
                                val["pa_mpjpe"])
                    window_t0 = time.perf_counter()
    except KeyboardInterrupt:
        logger.warning("Interrupted at step %d: saving the weights reached.",
                       global_step)
    finally:
        # every exit flushes the metrics and keeps the weights reached
        flush_metrics()
        if checkpoint_path is not None and global_step > start_step:
            save_pose_model(model, checkpoint_path, step=global_step)
        writer.flush()
    return state, global_step

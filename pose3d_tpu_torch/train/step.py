"""Train and eval steps (counterpart of ``pose3d_tpu/train/step.py``).

One call of the train step consumes a superbatch of A microbatches
(``[A, B, ...]`` tensors on the model's device) and makes one optimizer
step, updating the state in place. Accumulation modes:

* ``"grouped"`` (default): one forward and backward over the flat A·B
  batch with the mean loss, which equals the mean of the A microbatch
  means. Every plain BatchNorm works per group of B samples for the
  duration of the step (:mod:`pose3d_tpu_torch.train.ghost_bn`), so
  statistics, running averages and gradients equal the scan path's; the
  ``DotStatsBatchNorm`` (``normalization`` "batch_pallas[:N]" and
  "batch_dot") is refused, as in the JAX package.
* ``"scan"``: A sequential forward/backward passes, gradients summed and
  then divided by A (the reference's accumulation loop); activations of
  one microbatch at a time, and the BatchNorm running statistics move from
  one microbatch to the next in the modules' buffers.

(The JAX package's ``"ghost"`` vmap mode is not ported.)

``augment`` (``ops.augment_device.make_device_augment``) runs on the
decompacted batch just before the model, without gradient: once over the
flat A·B batch in ``grouped``, once per microbatch in ``scan``. It draws
from a generator of its own, so the dropout masks of a run do not depend
on whether augmentation is on.

The update clips by global norm when the state asks for it, steps AdamW
and the LR schedule, and moves the EMA of the parameters and of the
BatchNorm running statistics with the ramp d_t = min(d, (1 + t)/(10 + t)).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pose3d_tpu_torch.geometry.metrics import procrustes_align
from pose3d_tpu_torch.ops.losses import (
    LossWeights,
    composite_pose_loss,
    composite_pose_loss_per_sample,
)
from pose3d_tpu_torch.train.ghost_bn import grouped_batchnorm
from pose3d_tpu_torch.train.state import TrainState, batch_stats

ACCUM_MODES = ("grouped", "scan")


def decompact_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of the host's ``compact_batch``: uint8 image → [0, 1]
    float, uint8 depth + per-sample (min, max) → metric float. Float
    batches pass through; ``depth_scale`` is dropped."""
    out = dict(batch)
    img = batch["image"]
    if img.dtype == torch.uint8:
        out["image"] = img.float() / 255.0
    depth = batch["depth"]
    if depth.dtype == torch.uint8 and "depth_scale" in batch:
        s = batch["depth_scale"].float()                       # [B, 2]
        dmin = s[:, 0][:, None, None, None]
        dmax = s[:, 1][:, None, None, None]
        out["depth"] = depth.float() / 255.0 * (dmax - dmin) + dmin
    out.pop("depth_scale", None)
    return out


def _forward_loss(model, micro, weights, generator, augment=None,
                  augment_generator=None):
    micro = decompact_batch(micro)
    if augment is not None:
        with torch.no_grad():
            micro = augment(micro, augment_generator)
    out = model(micro["image"], micro["depth"], micro["keypoints_2d"],
                generator=generator)
    return composite_pose_loss(out, micro["joints_3d"], weights)


def _clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g ← g·max_norm/‖g‖ when the
    global norm ‖g‖ >= max_norm; on the device, without a host sync."""
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor)


def _apply_update(state: TrainState, ema_decay: Optional[float]) -> None:
    """Optimizer step on the gradients in ``.grad``: clip (opt-in), AdamW,
    LR schedule, step count, EMA."""
    params = state.trainable()
    for p in params:
        # optax updates every trainable leaf, a zero gradient included
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if state.clip_grad_norm is not None:
        _clip_by_global_norm_([p.grad for p in params],
                              float(state.clip_grad_norm))
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()
    state.step += 1
    if ema_decay is not None:
        if state.ema_params is None:
            raise ValueError(
                "ema_decay given but the state carries no ema_params — "
                "build it with create_train_state(..., ema=True)")
        t = float(state.step)
        d = min(ema_decay, (1.0 + t) / (10.0 + t))
        names, live = zip(*state.model.named_parameters())
        ema = [state.ema_params[n] for n in names]
        if state.ema_batch_stats is not None:
            # the updated running statistics, averaged with the same decay
            stats = batch_stats(state.model)
            live += tuple(stats.values())
            ema += [state.ema_batch_stats[n] for n in stats]
        with torch.no_grad():
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, [p.detach() for p in live],
                                alpha=1.0 - d)


def make_train_step(weights: LossWeights = LossWeights(), *,
                    accum_mode: str = "grouped",
                    ema_decay: Optional[float] = None,
                    augment=None):
    """Return ``step(state, superbatch, generator, augment_generator) ->
    metrics``: the batch-mean loss components as 0-dim tensors on the
    device (no host sync). ``generator`` (on the model's device) draws the
    dropout masks; ``augment_generator`` (there too) the parameters of
    ``augment``, which needs it."""
    if accum_mode not in ACCUM_MODES:
        raise ValueError(f"unknown accum_mode {accum_mode!r} "
                         f"(ported: {ACCUM_MODES})")

    def grouped(state, batch, generator, augment_generator):
        accum = batch["image"].shape[0]
        flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in batch.items()}
        # the backward too: a rematerialised block runs its forward again
        with grouped_batchnorm(state.model, accum):
            loss, comps = _forward_loss(state.model, flat, weights,
                                        generator, augment,
                                        augment_generator)
            loss.backward()
        return comps

    def scan(state, batch, generator, augment_generator):
        accum = batch["image"].shape[0]
        seq = []
        for i in range(accum):
            micro = {k: v[i] for k, v in batch.items()}
            loss, comps = _forward_loss(state.model, micro, weights,
                                        generator, augment,
                                        augment_generator)
            loss.backward()
            seq.append(comps)
        grads = [p.grad for p in state.trainable() if p.grad is not None]
        torch._foreach_div_(grads, accum)
        return {k: torch.stack([c[k] for c in seq]).mean() for k in seq[0]}

    run = {"grouped": grouped, "scan": scan}[accum_mode]

    def step(state: TrainState, superbatch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             augment_generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        if augment is not None and augment_generator is None:
            raise ValueError(
                "the step was built with augment= and needs an "
                "augment_generator (on the model's device) to draw from")
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        comps = run(state, superbatch, generator, augment_generator)
        _apply_update(state, ema_decay)
        return {k: v.detach() for k, v in comps.items()}

    return step


def make_eval_step(weights: LossWeights = LossWeights(), *,
                   compat_pa: bool = False):
    """Return ``step(state, batch) -> (metrics, joints)``: eval-mode
    forward, then the loss components, MPJPE and PA-MPJPE of each sample
    as [B] vectors (the JAX ``make_eval_step(per_sample=True)``), so
    padded samples can be masked out. ``compat_pa`` selects the
    reference's transposed Procrustes rotation."""

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        was_training = model.training
        model.eval()
        try:
            batch = decompact_batch(batch)
            out = model(batch["image"], batch["depth"],
                        batch["keypoints_2d"])
        finally:
            model.train(was_training)
        gt = batch["joints_3d"].float()
        _, comps = composite_pose_loss_per_sample(out, gt, weights)
        metrics = dict(comps)
        metrics["mpjpe"] = torch.linalg.vector_norm(
            out.float() - gt, dim=-1).mean(-1)
        aligned = procrustes_align(out.float(), gt, compat_pa)
        metrics["pa_mpjpe"] = torch.linalg.vector_norm(
            aligned - gt, dim=-1).mean(-1)
        return metrics, out

    return step

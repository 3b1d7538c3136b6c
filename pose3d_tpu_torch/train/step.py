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

With a ``mesh`` (:mod:`pose3d_tpu_torch.core.mesh`) each rank feeds its own
``[A, B/n, ...]`` rows of the superbatch (n: the size of the mesh's batch
axes). Every BatchNorm takes its groups' statistics over all n ranks' rows
(:func:`pose3d_tpu_torch.train.ghost_bn.cross_rank_batchnorm`), so each
group is still one whole microbatch, and after the backward the gradients
are averaged over the batch axes with one bucketed all-reduce: the step
equals the one-process step on the global superbatch, up to the order of
the sums. A state sharded by ``parallel.shard_state_for_fsdp`` has its
parameters gathered for the forward and backward and its gradients
reduce-scattered into the shards; ``shard_state_for_tp`` and
``shard_state_for_pp`` states compute on their shards inside the model.
Dropout masks come from the generator reseeded per batch rank (ranks never
share a mask; ranks of one batch shard, the tensor- and pipeline-parallel
peers, draw alike), and ``augment`` draws the parameters of the global
flat batch and applies this rank's rows of them.

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

import contextlib
from typing import Dict, Optional

import torch

from pose3d_tpu_torch.core.comm import (
    all_gather_cat,
    all_reduce_,
    chunk_sizes,
)
from pose3d_tpu_torch.core.mesh import batch_axes, batch_rows
from pose3d_tpu_torch.geometry.metrics import procrustes_align
from pose3d_tpu_torch.ops.losses import (
    LossWeights,
    composite_pose_loss,
    composite_pose_loss_per_sample,
)
from pose3d_tpu_torch.train.ghost_bn import (
    cross_rank_batchnorm,
    grouped_batchnorm,
)
from pose3d_tpu_torch.train.state import TrainState, batch_stats

ACCUM_MODES = ("grouped", "scan")
STATE_SHARDINGS = ("replicated", "auto")
_MASK64 = (1 << 64) - 1
# 0x72616e6b = "rank": a batch rank's dropout stream
RANK_STREAM = 0x72616E6B


def step_seed(seed: int, step: int) -> int:
    """A generator seed for optimizer step ``step`` of a run seeded
    ``seed`` (splitmix64 of the pair; the counterpart of JAX's
    ``fold_in(rng, step)``): each step draws from a stream of its own, and
    a run resumed at step t draws what an uninterrupted run draws there."""
    x = (seed * 0x9E3779B97F4A7C15 + step + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


class _Batch:
    """The mesh's batch axes as a step sees them: the group, its size n
    and this rank's index (None, 1, 0 without a mesh)."""

    def __init__(self, mesh):
        axes = batch_axes(mesh) if mesh is not None else ()
        self.mesh = mesh
        self.n = mesh.axis_size(axes) if axes else 1
        self.group = mesh.group(axes) if self.n > 1 else None
        self.index = mesh.axis_index(axes) if self.n > 1 else 0
        self.replica = (mesh.group("replica")
                        if mesh is not None and "replica" in mesh.axis_names
                        and mesh.shape["replica"] > 1 else None)


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
                  augment_generator=None, augment_rows=None):
    micro = decompact_batch(micro)
    if augment is not None:
        kw = {}
        if augment_rows is not None:
            kw = dict(draw_size=augment_rows[0], rows=augment_rows[1])
        with torch.no_grad():
            micro = augment(micro, augment_generator, **kw)
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


def _clip_sharded_(state: TrainState, plan, max_norm: float) -> None:
    """:func:`_clip_by_global_norm_` of a sharded state: the squared norms
    of the shards summed over the plan's ranks, the whole tensors' counted
    once."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    sq = {True: [], False: []}
    for p in state.trainable():
        sq[names[id(p)] in plan.specs].append(p.grad.float().square().sum())
    norm2 = torch.zeros((), device=state.trainable()[0].device)
    if sq[True]:
        norm2 = all_reduce_(torch.stack(sq[True]).sum(), plan.group)
    if sq[False]:
        norm2 = norm2 + torch.stack(sq[False]).sum()
    norm = norm2.sqrt()
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_([p.grad for p in state.trainable()], factor)


def _reduce_grads(state: TrainState, batch: _Batch) -> None:
    """Average the gradients over the mesh, each set in one flat
    all-reduce: whole parameters over the batch axes, and under tensor or
    pipeline parallelism over the model or stage axis too (those ranks
    compute them alike but for the attention backward's atomic dQ sums,
    so the replicas stay bitwise equal); TP and PP shards over the batch
    axes; FSDP shards, summed over the data axis by their reduce-scatter,
    across a hybrid mesh's replicas."""
    plan = getattr(state.model, "shard_plan", None)
    names = {id(p): n for n, p in state.model.named_parameters()}
    whole, shards = [], []
    for p in state.trainable():
        sharded = plan is not None and names[id(p)] in plan.specs
        (shards if sharded else whole).append(p.grad)
    fsdp = plan is not None and plan.kind == "fsdp"
    mesh = batch.mesh
    axes = batch_axes(mesh) + ((plan.axis,) if plan and not fsdp else ())
    rules = ((whole, mesh.group(axes), mesh.axis_size(axes)),
             (shards, batch.replica if fsdp else batch.group, batch.n))
    for grads, group, n in rules:
        if not grads or n == 1:
            continue
        if group is not None:
            flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]),
                               group)
            torch._foreach_copy_(grads, [
                c.view_as(g) for c, g in zip(
                    flat.split([g.numel() for g in grads]), grads)])
        torch._foreach_div_(grads, n)


def _apply_update(state: TrainState, ema_decay: Optional[float],
                  batch: Optional[_Batch] = None) -> None:
    """Optimizer step on the gradients in ``.grad``: reduce over the mesh,
    clip (opt-in), AdamW, LR schedule, step count, EMA."""
    params = state.trainable()
    for p in params:
        # optax updates every trainable leaf, a zero gradient included
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if batch is not None and batch.mesh is not None:
        _reduce_grads(state, batch)
    if state.clip_grad_norm is not None:
        plan = getattr(state.model, "shard_plan", None)
        if plan is None:
            _clip_by_global_norm_([p.grad for p in params],
                                  float(state.clip_grad_norm))
        else:
            _clip_sharded_(state, plan, float(state.clip_grad_norm))
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


def _sharding(state: TrainState, state_sharding: str, grad: bool):
    """The context a step runs its forward (and backward) in: the full
    parameters gathered for an FSDP state."""
    plan = getattr(state.model, "shard_plan", None)
    if plan is not None and state_sharding != "auto":
        raise ValueError(
            f"the state is sharded ({plan.kind}): build the step with "
            "state_sharding='auto'")
    if plan is not None and plan.kind == "fsdp":
        return plan.unsharded(state.model, grad=grad)
    return contextlib.nullcontext()


def make_train_step(weights: LossWeights = LossWeights(), *,
                    accum_mode: str = "grouped",
                    ema_decay: Optional[float] = None,
                    augment=None, mesh=None,
                    state_sharding: str = "replicated"):
    """Return ``step(state, superbatch, generator, augment_generator) ->
    metrics``: the batch-mean loss components as 0-dim tensors on the
    device (no host sync). ``generator`` (on the model's device) draws the
    dropout masks; ``augment_generator`` (there too) the parameters of
    ``augment``, which needs it.

    ``mesh``: data-parallel over its batch axes (module docstring); the
    superbatch is this rank's rows and the metrics are the global batch's.
    ``state_sharding``: "replicated" (the whole state on every rank) or
    "auto" (a state sharded by ``parallel.shard_state_for_*``, which the
    step reads from the model's ``shard_plan``)."""
    if accum_mode not in ACCUM_MODES:
        raise ValueError(f"unknown accum_mode {accum_mode!r} "
                         f"(ported: {ACCUM_MODES})")
    if state_sharding not in STATE_SHARDINGS:
        raise ValueError(f"unknown state_sharding {state_sharding!r} "
                         f"(expected {STATE_SHARDINGS})")
    bt = _Batch(mesh)

    def aug_rows(accum, local, device):
        """(draw size, rows) of ``augment``'s draw for this rank's flat
        ``[accum·local]`` rows: sample (a, j) is a·B + offset + j of the
        global flat batch."""
        if augment is None or bt.n == 1:
            return None
        B = local * bt.n
        j = torch.arange(local, device=device) + bt.index * local
        a = torch.arange(accum, device=device)[:, None] * B
        return accum * B, (a + j).reshape(-1)

    def grouped(state, batch, generator, augment_generator):
        accum, local = batch["image"].shape[:2]
        flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in batch.items()}
        # the backward too: a rematerialised block runs its forward again
        with grouped_batchnorm(state.model, accum), \
                cross_rank_batchnorm(state.model, bt.group), \
                _sharding(state, state_sharding, True):
            loss, comps = _forward_loss(
                state.model, flat, weights, generator, augment,
                augment_generator,
                aug_rows(accum, local, batch["image"].device))
            loss.backward()
        return comps

    def scan(state, batch, generator, augment_generator):
        accum, local = batch["image"].shape[:2]
        rows = aug_rows(1, local, batch["image"].device)
        seq = []
        for i in range(accum):
            micro = {k: v[i] for k, v in batch.items()}
            with cross_rank_batchnorm(state.model, bt.group), \
                    _sharding(state, state_sharding, True):
                loss, comps = _forward_loss(state.model, micro, weights,
                                            generator, augment,
                                            augment_generator, rows)
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
        if bt.n > 1 and generator is not None:
            generator.manual_seed(step_seed(generator.initial_seed(),
                                            RANK_STREAM + bt.index))
        comps = run(state, superbatch, generator, augment_generator)
        _apply_update(state, ema_decay, bt)
        comps = {k: v.detach() for k, v in comps.items()}
        if bt.n > 1:
            keys = sorted(comps)
            mean = all_reduce_(torch.stack([comps[k].float() for k in keys]),
                               bt.group) / bt.n
            comps = dict(zip(keys, mean.unbind()))
        return comps

    return step


def make_eval_step(weights: LossWeights = LossWeights(), *,
                   compat_pa: bool = False, mesh=None,
                   state_sharding: str = "replicated"):
    """Return ``step(state, batch) -> (metrics, joints)``: eval-mode
    forward, then the loss components, MPJPE and PA-MPJPE of each sample
    as [B] vectors (the JAX ``make_eval_step(per_sample=True)``), so
    padded samples can be masked out. ``compat_pa`` selects the
    reference's transposed Procrustes rotation.

    ``mesh``: every rank passes the whole batch; each computes its rows
    (``tensor_split`` shards over the batch axes: a ragged batch splits
    unevenly, nothing is padded) and the per-sample results are gathered
    in order, so every rank returns the whole batch's and sample-weighted
    sums over them are exact. ``state_sharding`` as in
    :func:`make_train_step`."""
    if state_sharding not in STATE_SHARDINGS:
        raise ValueError(f"unknown state_sharding {state_sharding!r} "
                         f"(expected {STATE_SHARDINGS})")
    bt = _Batch(mesh)

    def forward(model, batch):
        if bt.n > 1:
            rows = batch_rows(batch["image"].shape[0], mesh)
            batch = {k: v[rows] for k, v in batch.items()}
        batch = decompact_batch(batch)
        if batch["image"].shape[0] == 0:   # a ragged batch left none here
            out = batch["keypoints_2d"].new_zeros(
                0, batch["joints_3d"].shape[1], 3)
        else:
            out = model(batch["image"], batch["depth"],
                        batch["keypoints_2d"])
        gt = batch["joints_3d"].float()
        _, comps = composite_pose_loss_per_sample(out, gt, weights)
        metrics = dict(comps)
        metrics["mpjpe"] = torch.linalg.vector_norm(
            out.float() - gt, dim=-1).mean(-1)
        aligned = procrustes_align(out.float(), gt, compat_pa)
        metrics["pa_mpjpe"] = torch.linalg.vector_norm(
            aligned - gt, dim=-1).mean(-1)
        return metrics, out

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with _sharding(state, state_sharding, False):
                metrics, out = forward(model, batch)
        finally:
            model.train(was_training)
        if bt.n > 1:
            sizes = chunk_sizes(batch["image"].shape[0], bt.n)
            metrics = {k: all_gather_cat(v, bt.group, 0, sizes)
                       for k, v in metrics.items()}
            out = all_gather_cat(out, bt.group, 0, sizes)
        return metrics, out

    return step


def make_predict_fn(model, mesh=None, device=None):
    """Return ``predict(image, depth, keypoints_2d) -> joints``: the
    model's eval-mode forward without gradient (the JAX
    ``make_predict_fn``; the port's model holds its own parameters, so no
    variables are passed). Inputs, numpy arrays or tensors, go to
    ``device`` (default: the device of the model's parameters); float
    images and metric depths as the model takes them.

    ``mesh``: every rank passes the whole batch, computes its rows (as
    :func:`make_eval_step`) and returns the whole batch's joints, gathered
    in order."""
    bt = _Batch(mesh)
    dev = (torch.device(device) if device is not None
           else next(model.parameters()).device)

    @torch.no_grad()
    def predict(image, depth, keypoints_2d):
        args = [torch.as_tensor(x).to(dev)
                for x in (image, depth, keypoints_2d)]
        n = args[0].shape[0]
        if bt.n > 1:
            rows = batch_rows(n, mesh)
            args = [x[rows] for x in args]
        was_training = model.training
        model.eval()
        try:
            if args[0].shape[0] == 0:   # a ragged batch left none here
                out = args[2].new_zeros(0, args[2].shape[1], 3)
            else:
                out = model(*args)
        finally:
            model.train(was_training)
        if bt.n > 1:
            out = all_gather_cat(out, bt.group, 0, chunk_sizes(n, bt.n))
        return out

    return predict

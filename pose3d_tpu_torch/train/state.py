"""Training state: the model (fp32 master parameters and, for the CNN,
BatchNorm running statistics), AdamW, the LR schedule, the optional EMA of
the parameters and of those statistics, and the step count
(counterpart of ``pose3d_tpu/train/state.py``).

Optimizer semantics follow the JAX package's ``optax.adamw`` (b1 0.9,
b2 0.999, eps 1e-8 added to √v̂, weight decay decoupled and applied to
every trainable parameter, LayerNorms and biases included), which
``torch.optim.AdamW`` with one parameter group computes. Frozen
parameters (``frozen_prefixes`` minus ``trainable_exceptions``) are left
out of the optimizer and stop requiring grad, so they take no update and
no decay, as optax's ``set_to_zero`` branch. Optional clip-by-global-norm
runs before AdamW, over the trainable gradients only.

``ema_batch_stats`` mirrors the JAX state's: the running means and
variances averaged with the parameters' decay, so that averaged weights
are never paired with the live model's statistics.
"""

from __future__ import annotations

import contextlib
import math
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn


@dataclass
class TrainState:
    """What one optimizer step reads and updates in place."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR] = None
    clip_grad_norm: Optional[float] = None
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    ema_batch_stats: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0

    def trainable(self) -> List[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]


def batch_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's BatchNorm running means and variances by state_dict
    name (the JAX package's ``batch_stats`` collection); empty for a model
    without BatchNorm."""
    return {n: b for n, b in model.named_buffers()
            if n.endswith((".running_mean", ".running_var"))}


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init → end over ``steps``, then end; constant
    init when steps <= 0."""
    if steps <= 0:
        return lambda count: init

    def f(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _cosine(init: float, decay_steps: int, alpha: float
            ) -> Callable[[int], float]:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def f(count):
        c = min(count, decay_steps)
        cos = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init * ((1.0 - alpha) * cos + alpha)
    return f


def _join(schedules, boundaries) -> Callable[[int], float]:
    """optax.join_schedules: each schedule counts from its boundary."""
    def f(count):
        out = schedules[0](count)
        for b, s in zip(boundaries, schedules[1:]):
            if count >= b:
                out = s(count - b)
        return out
    return f


def make_lr_schedule(schedule: str = "constant", warmup_steps: int = 0,
                     decay_steps: Optional[int] = None,
                     end_lr_factor: float = 0.0
                     ) -> Optional[Callable[[int], float]]:
    """LR multiplier per optimizer step, for ``LambdaLR``: step t of the
    run uses ``learning_rate · f(t)``, the value optax's schedule gives
    at count t. ``None`` for constant without warmup (the reference's
    fixed LR, the default). Schedules: "constant" (with linear warmup),
    "cosine" (optax.warmup_cosine_decay_schedule) and "linear" (warmup,
    then linear decay to ``end_lr_factor``)."""
    schedule = (schedule or "constant").lower()
    if schedule == "constant" and not warmup_steps:
        return None
    if schedule != "constant" and not decay_steps:
        raise ValueError(
            f"lr schedule '{schedule}' needs decay_steps (the step budget "
            "over which to decay)")
    warmup = _linear(0.0, 1.0, warmup_steps)
    if schedule == "constant":
        return _join([warmup, lambda count: 1.0], [warmup_steps])
    if schedule == "cosine":
        return _join([warmup, _cosine(1.0, decay_steps - warmup_steps,
                                      end_lr_factor)], [warmup_steps])
    if schedule == "linear":
        return _join([warmup, _linear(1.0, end_lr_factor,
                                      max(decay_steps - warmup_steps, 1))],
                     [warmup_steps])
    raise ValueError(f"Unknown lr schedule: {schedule!r} "
                     "(expected constant|cosine|linear)")


def trainable_mask(model: nn.Module, frozen_prefixes: Sequence[str] = (),
                   trainable_exceptions: Sequence[str] = ()
                   ) -> Dict[str, bool]:
    """Parameter name → trainable. Prefixes are matched against the
    reference names (``vit_backbone.patch_embed``); the JAX package's
    "/"-separated form (``vit_backbone/patch_embed``) is accepted too.
    ``--freeze-backbone``: frozen ``vit_backbone``, exception
    ``vit_backbone/patch_embed``."""
    frozen = [p.replace("/", ".") for p in frozen_prefixes]
    keep = [p.replace("/", ".") for p in trainable_exceptions]
    return {
        name: any(name.startswith(e) for e in keep)
        or not any(name.startswith(f) for f in frozen)
        for name, _ in model.named_parameters()
    }


def make_optimizer(model: nn.Module, learning_rate: float = 1e-3,
                   weight_decay: float = 0.01, *,
                   lr_schedule: Optional[Callable[[int], float]] = None,
                   frozen_prefixes: Sequence[str] = (),
                   trainable_exceptions: Sequence[str] = ()):
    """(AdamW over the trainable parameters, LambdaLR or None). Sets
    ``requires_grad`` on every parameter from the freeze mask."""
    mask = trainable_mask(model, frozen_prefixes, trainable_exceptions)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    opt = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    sched = (torch.optim.lr_scheduler.LambdaLR(opt, lr_schedule)
             if lr_schedule is not None else None)
    return opt, sched


def create_train_state(model: nn.Module, learning_rate: float = 1e-3,
                       weight_decay: float = 0.01, *,
                       lr_schedule: Optional[Callable[[int], float]] = None,
                       frozen_prefixes: Sequence[str] = (),
                       trainable_exceptions: Sequence[str] = (),
                       clip_grad_norm: Optional[float] = None,
                       ema: bool = False) -> TrainState:
    """A state at step 0 for ``model`` (built with ``train=True``). With
    ``ema`` the average starts as a copy of every parameter and, when the
    model has BatchNorm, of every running mean and variance."""
    opt, sched = make_optimizer(
        model, learning_rate, weight_decay, lr_schedule=lr_schedule,
        frozen_prefixes=frozen_prefixes,
        trainable_exceptions=trainable_exceptions)
    ema_params = ({n: p.detach().clone()
                   for n, p in model.named_parameters()} if ema else None)
    stats = batch_stats(model)
    ema_stats = ({n: b.detach().clone() for n, b in stats.items()}
                 if ema and stats else None)
    return TrainState(model, opt, sched, clip_grad_norm, ema_params,
                      ema_stats)


def ema_slots(model: nn.Module, ema_params: Dict[str, torch.Tensor],
              ema_batch_stats: Optional[Dict[str, torch.Tensor]],
              stacklevel: int = 2) -> Dict[str, tuple]:
    """state_dict name → (the model's tensor, its EMA value): every
    parameter and, where the EMA averaged them, the BatchNorm running
    statistics. EMA of the parameters of a BatchNorm model without its
    statistics (an older checkpoint) warns: the averaged weights then run
    with the live running statistics."""
    slots = dict(model.named_parameters())
    ema = dict(ema_params)
    stats = batch_stats(model)
    if ema_batch_stats is not None:
        slots.update(stats)
        ema.update(ema_batch_stats)
    elif stats:
        warnings.warn(
            "the state carries ema_params but no ema_batch_stats for a "
            "model with BatchNorm: the averaged weights run with the live "
            "running statistics (build the state with "
            "create_train_state(..., ema=True))", stacklevel=stacklevel + 1)
    return {n: (t, ema[n]) for n, t in slots.items()}


@contextlib.contextmanager
def with_ema_params(state: TrainState):
    """Inside the block the model holds the EMA parameters and the EMA
    BatchNorm statistics (for eval or export); the live ones come back
    after it. No-op without EMA; see :func:`ema_slots` for a state without
    EMA statistics."""
    if state.ema_params is None:
        yield state
        return
    slots = ema_slots(state.model, state.ema_params, state.ema_batch_stats,
                      stacklevel=3)
    live = {n: t.detach().clone() for n, (t, _) in slots.items()}
    try:
        with torch.no_grad():
            for t, e in slots.values():
                t.copy_(e)
        yield state
    finally:
        with torch.no_grad():
            for n, (t, _) in slots.items():
                t.copy_(live[n])

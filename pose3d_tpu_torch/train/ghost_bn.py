"""Grouped (ghost) BatchNorm statistics for the grouped train step
(counterpart of ``pose3d_tpu/train/ghost_bn.py``).

The grouped step runs the model once on the flat ``[A·B]`` batch and keeps
the BatchNorm semantics of A sequential microbatches of B samples inside
every BatchNorm call: statistics per group of B consecutive samples,
normalisation per group, and the A-fold sequential running-stat update in
closed form. The sequential path folds group statistics s_0..s_{A-1} into
the running value as r_{i+1} = m·r_i + (1−m)·s_i, which telescopes to

    r_A = m^A·r_0 + Σ_i m^(A−1−i)·(1−m)·s_i.

Where the JAX package intercepts flax's ``nn.BatchNorm.__call__``, the port
sets ``groups`` on every :class:`pose3d_tpu_torch.models.cnn.BatchNorm` of
the model (CoordAttention's included) for the duration of the step; the
module does the per-group arithmetic as reductions over a ``[G, B·H·W, C]``
view, without a copy of the activation. The local order is group-major
(sample ``g·B + b`` belongs to group ``g``).

Across ranks (:func:`cross_rank_batchnorm`): each rank holds its ``[A,
B/n]`` rows of the superbatch, so its group ``g`` is its part of
microbatch ``g``. Every BatchNorm all-reduces the groups' fp32 Σx and Σx²
(``[2, G, C]``) and the count before mean and variance, and in the
backward Σdy and Σdy·x, so that each group's statistics cover the whole
microbatch, as the JAX mesh step's group-minor flattening gives them: a
data-parallel step equals the one-process step on the global batch, up to
the order of the sums. The running statistics come from those global sums
and stay equal on every rank. The ``DotStatsBatchNorm`` (scan with
``batch_pallas``) all-reduces the ``[2, C]`` sums of its ``bn_stats``
launch the same way.

Dropout is left alone: one mask over the flat batch instead of one per
group, the same in distribution.
"""

from __future__ import annotations

import contextlib

from torch import nn

# ema_chain lives with the BatchNorm that applies it; it is named here too,
# where the JAX package keeps it
from pose3d_tpu_torch.models.cnn import (  # noqa: F401
    BatchNorm,
    DotStatsBatchNorm,
    _BatchNormBase,
    ema_chain,
)


@contextlib.contextmanager
def grouped_batchnorm(model: nn.Module, groups: int):
    """Inside the block every plain BatchNorm of ``model`` works per group
    of ``batch / groups`` consecutive samples. ``DotStatsBatchNorm`` (the
    ``bn_stats``-kernel and ``batch_dot`` flavours) is refused rather than
    mis-grouped, as the JAX grouped step refuses it: its statistics would
    cover the whole flat batch and change the training semantics."""
    norms = []
    for mod in model.modules():
        if isinstance(mod, DotStatsBatchNorm):
            raise NotImplementedError(
                "accum_mode='grouped' supports normalization='batch' only; "
                f"use accum_mode='scan' with {type(mod).__name__} "
                "(normalization='batch_pallas[:N]' or 'batch_dot')")
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            raise NotImplementedError(
                f"grouped accumulation cannot group {type(mod).__name__}; "
                "build the model with pose3d_tpu_torch.models.cnn.BatchNorm")
        if isinstance(mod, BatchNorm):
            norms.append(mod)
    for mod in norms:
        mod.groups = groups
    try:
        yield
    finally:
        for mod in norms:
            mod.groups = 1


@contextlib.contextmanager
def cross_rank_batchnorm(model: nn.Module, group):
    """Inside the block every BatchNorm of ``model`` (both flavours) takes
    its batch statistics over the rows of every rank of ``group``, a
    process group of the mesh's batch axes; no-op for ``group=None``."""
    if group is None:
        yield
        return
    norms = [m for m in model.modules() if isinstance(m, _BatchNormBase)]
    for mod in norms:
        mod.sync_group = group
    try:
        yield
    finally:
        for mod in norms:
            mod.sync_group = None

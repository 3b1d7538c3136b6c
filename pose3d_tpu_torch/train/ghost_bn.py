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
view, without a copy of the activation. Group-major order only (sample
``g·B + b`` belongs to group ``g``): one device.

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

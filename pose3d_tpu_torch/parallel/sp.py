"""Sequence parallelism (Megatron-SP) over the mesh ``model`` axis
(counterpart of ``pose3d_tpu/parallel/sp.py``).

Between the tensor-parallel regions (LayerNorm, dropout, residual adds)
the residual token streams ``[B, T, D]`` of the ViT and of the final
encoder stay sharded on T over the model axis. Before a block's attention
and MLP the normalised tokens are all-gathered on T (backward: a
reduce-scatter of the ranks' partial gradients), and their outputs are
reduce-scattered onto each rank's tokens (backward: an all-gather) in
place of tensor parallelism's all-reduce: the same bytes, with the
stream's activations and the LayerNorm work divided by the axis size.
Without tensor parallelism the blocks compute whole on every rank and the
output is cut instead.

The streams hold 1,025 and 1,041 tokens in the flagship, which two ranks
do not divide: the shards are uneven (``torch.tensor_split``: 513 and
512), where GSPMD pads. The fusion blocks run on whole streams, as the JAX
model constrains their outputs but shards none of their parameters.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pose3d_tpu_torch.core.comm import GatherDim, ScatterDim, chunk_sizes


@dataclass(frozen=True)
class SequenceParallel:
    """The sequence-parallel hook (``build_model(sp_constraint=...)``):
    the group of the model axis, its size and this rank's index."""

    group: object
    size: int
    index: int

    def sizes(self, length: int):
        return chunk_sizes(length, self.size)

    def start(self, length: int) -> int:
        return sum(self.sizes(length)[:self.index])

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Whole stream → this rank's tokens (backward: all-gather)."""
        return ScatterDim.apply(x, self.group, 1, self.sizes(x.shape[1]),
                                False)

    def gather(self, x: torch.Tensor, length: int) -> torch.Tensor:
        """This rank's tokens → the whole stream (backward: this rank's
        part of the gradient)."""
        return GatherDim.apply(x, self.group, 1, self.sizes(length), False)

    def enter(self, x: torch.Tensor, length: int, partial: bool):
        """Before a block's attention or MLP: all-gather the tokens;
        ``partial``: the region is tensor-parallel, so the backward sums
        the ranks' gradients (reduce-scatter)."""
        return GatherDim.apply(x, self.group, 1, self.sizes(length), partial)

    def leave(self, y: torch.Tensor, partial: bool):
        """After it: this rank's tokens of the ranks' sum (``partial``) or
        of the whole output."""
        return ScatterDim.apply(y, self.group, 1, self.sizes(y.shape[1]),
                                partial)


def make_sp_constraint(mesh, axis: str = "model", batch_axis: str = "data"):
    """The hook that shards the residual streams on T over ``mesh``'s
    ``axis`` (the batch stays sharded over ``batch_axis`` as the step
    feeds it). Pass it as ``build_model(sp_constraint=...)``."""
    if batch_axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh} has no batch axis {batch_axis!r}")
    return SequenceParallel(mesh.group(axis), mesh.shape[axis],
                            mesh.axis_index(axis) if mesh.shape[axis] > 1
                            else 0)

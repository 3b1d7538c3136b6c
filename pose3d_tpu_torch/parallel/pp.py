"""Pipeline parallelism (GPipe) over a mesh ``stage`` axis (counterpart of
``pose3d_tpu/parallel/pp.py``).

Only the ViT's encoder blocks are pipelined: stage s holds the L/S
contiguous blocks ``[s·L/S, (s+1)·L/S)`` and the rest of the model runs
whole on every stage. :func:`gpipe` is the JAX schedule: M + S − 1 ticks;
at tick t stage 0 takes microbatch min(t, M − 1), every later stage the
activations its predecessor sent at the tick before, each applies its
blocks, and the last stage keeps microbatch t − (S − 1) from tick S − 1 on.
The last stage's outputs are then broadcast to every stage. The backward
is autograd's through the same graph: each exchange is one autograd
Function (:class:`_Shift`, a send to the next stage with a receive from
the previous, whose backward sends the gradient the other way), the entry
sums the input's gradient over the stages, and the broadcast hands the
gradient back to the last stage. Dropout must be 0 (the ViT's is).

Why not ``torch.distributed.pipelining``: its schedules run the backward
themselves from a loss on the last stage (``ScheduleGPipe.step(...,
target=, losses=)``), so they cannot sit inside the model's autograd graph
with the rest of the model around them, as the JAX ``block_runner`` does.

Every stage runs every tick's blocks and every exchange in both
directions, the values of the fill and drain ticks included (their
gradients are zeros), so that the ranks post the same point-to-point
operations in the same order; a tick's leftover outputs join the result
times 0 for that reason. The JAX program computes the same ticks.

Layout: the port keeps the blocks as a ``ModuleList`` (the ``.pth``
names); a stage holds its blocks' parameters, AdamW moments and EMA copies
and the others are empty tensors there (:func:`shard_state_for_pp`).
``vit_stacked`` is the JAX *parameter* layout: :func:`stack_vit_blocks` and
:func:`unstack_vit_blocks` convert JAX trees (numpy leaves) for the weight
bridge.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from pose3d_tpu_torch.core.comm import all_reduce_, broadcast_, exchange
from pose3d_tpu_torch.parallel.shard import (
    REPLICATED,
    ParamSpec,
    ShardPlan,
    apply_plan,
    full_shapes,
)

STAGE_AXIS = "stage"
_BLOCK = re.compile(r"^vit_backbone\.blocks\.(\d+)\.")


class _Enter(torch.autograd.Function):
    """Identity; the input's gradient is summed over the stages (only
    stage 0 reads the microbatches)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return all_reduce_(dx.clone(), ctx.group), None


class _Shift(torch.autograd.Function):
    """Send ``y`` to the next stage and return what the previous stage
    sent (zeros on stage 0); backward: the other way round."""

    @staticmethod
    def forward(ctx, y, group, prev, nxt):
        ctx.args = (group, prev, nxt)
        y = y.contiguous()
        recv = torch.zeros_like(y)
        exchange(y if nxt is not None else None, nxt,
                 recv if prev is not None else None, prev, group)
        return recv

    @staticmethod
    def backward(ctx, drecv):
        group, prev, nxt = ctx.args
        dy = torch.zeros_like(drecv)
        exchange(drecv.contiguous() if prev is not None else None, prev,
                 dy if nxt is not None else None, nxt, group)
        return dy, None, None, None


class _Broadcast(torch.autograd.Function):
    """Every stage gets global rank ``src``'s value; the gradient goes to
    ``src`` alone (the stages' losses are one loss computed on each)."""

    @staticmethod
    def forward(ctx, x, src, group, is_src):
        ctx.is_src = is_src
        return broadcast_(x.clone(), src, group)

    @staticmethod
    def backward(ctx, dy):
        return (dy if ctx.is_src else torch.zeros_like(dy)), None, None, None


def _stage_rank(mesh, stage_axis: str, stage: int) -> int:
    c = mesh.coords()
    c[stage_axis] = stage
    return int(mesh.devices[tuple(c[a] for a in mesh.axis_names)])


def gpipe(block_apply: Callable, depth: int, x: torch.Tensor, *, mesh,
          num_microbatches: int, stage_axis: str = STAGE_AXIS
          ) -> torch.Tensor:
    """Run ``x`` through blocks 0..depth−1 pipelined over ``stage_axis``;
    ``block_apply(i, y)`` applies block i (this stage's blocks only are
    called). ``x``: ``[B, ...]``, the same on every stage, B divisible by
    ``num_microbatches``; returns the same on every stage."""
    S = mesh.shape[stage_axis]
    M = num_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    if depth % S:
        raise ValueError(f"{depth} layers not divisible by {S} stages")
    group = mesh.group(stage_axis)
    s = mesh.axis_index(stage_axis) if S > 1 else 0
    prev = _stage_rank(mesh, stage_axis, s - 1) if s > 0 else None
    nxt = _stage_rank(mesh, stage_axis, s + 1) if s < S - 1 else None
    per = depth // S
    mine = range(s * per, (s + 1) * per)

    x_mb = _Enter.apply(x, group).chunk(M)
    buf = torch.zeros_like(x_mb[0])
    outs, anchor = [], None
    for t in range(M + S - 1):
        first_in = x_mb[min(t, M - 1)]
        # both inputs stay in the graph on every stage (see the docstring)
        y = first_in + buf * 0 if s == 0 else buf + first_in * 0
        for i in mine:
            y = block_apply(i, y)
        if s == S - 1 and t >= S - 1:
            outs.append(y)
        else:
            z = y.sum() * 0
            anchor = z if anchor is None else anchor + z
        if t < M + S - 2:
            buf = _Shift.apply(y, group, prev, nxt)
    out = torch.cat(outs) if s == S - 1 else torch.zeros_like(x)
    if anchor is not None:
        out = out + anchor
    return _Broadcast.apply(out, _stage_rank(mesh, stage_axis, S - 1), group,
                            s == S - 1)


def make_pipeline_runner(mesh, num_microbatches: int,
                         stage_axis: str = STAGE_AXIS) -> Callable:
    """The block runner for ``build_model(vit_stacked=True,
    vit_block_runner=...)``: pipelines the ViT's blocks over ``mesh``'s
    stage axis."""

    def runner(block_apply, depth, x):
        return gpipe(block_apply, depth, x, mesh=mesh,
                     num_microbatches=num_microbatches,
                     stage_axis=stage_axis)

    return runner


def pp_param_spec(model: nn.Module, num_stages: int,
                  stage_axis: str = STAGE_AXIS,
                  base_specs: Optional[Dict[str, ParamSpec]] = None
                  ) -> Dict[str, ParamSpec]:
    """Parameter name → :class:`ParamSpec`: block i of the ViT on stage
    i // (L / S), keeping a base spec's dimensions (the pp × tp layout);
    every other parameter its base spec (default whole)."""
    del stage_axis  # the plan names the axis
    base_specs = base_specs or {}
    shapes = full_shapes(model)
    depth = len(model.vit_backbone.blocks)
    if depth % num_stages:
        raise ValueError(f"{depth} layers not divisible by {num_stages} "
                         "stages")
    per = depth // num_stages
    out = {}
    for name in shapes:
        base = base_specs.get(name, REPLICATED)
        m = _BLOCK.match(name)
        out[name] = (ParamSpec(base.dims, base.view, int(m.group(1)) // per)
                     if m else base)
    return out


def shard_state_for_pp(state, mesh, stage_axis: str = STAGE_AXIS):
    """Keep on each stage its ViT blocks' parameters, AdamW moments and
    EMA copies (empty tensors elsewhere); everything else whole. Returns
    ``state``."""
    specs = pp_param_spec(state.model, mesh.shape[stage_axis], stage_axis)
    plan = ShardPlan(mesh, specs, stage_axis, "pp",
                     full_shapes(state.model))
    return apply_plan(state, plan)


# --- layout converters of JAX trees: looped (block_0..block_{L-1}) <->
# stacked ("blocks" with a leading layer dimension) ---------------------------

def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_vit_blocks(backbone_params: Dict) -> Dict:
    """A looped JAX ViTBackbone parameter tree → the stacked layout."""
    out = {k: v for k, v in backbone_params.items()
           if not k.startswith("block_")}
    depth = sum(1 for k in backbone_params if k.startswith("block_"))
    if not depth:
        raise ValueError("no block_<i> subtrees to stack")
    blocks = [backbone_params[f"block_{i}"] for i in range(depth)]
    out["blocks"] = _map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                         *blocks)
    return out


def unstack_vit_blocks(backbone_params: Dict) -> Dict:
    """Inverse of :func:`stack_vit_blocks`."""
    out = {k: v for k, v in backbone_params.items() if k != "blocks"}
    stacked = backbone_params["blocks"]
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    for i in range(np.asarray(leaf).shape[0]):
        out[f"block_{i}"] = _map(lambda x, i=i: np.asarray(x)[i], stacked)
    return out

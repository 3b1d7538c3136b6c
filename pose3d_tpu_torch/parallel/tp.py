"""Tensor parallelism over the mesh ``model`` axis (counterpart of
``pose3d_tpu/parallel/tp.py``): the Megatron layout.

* MLP up-projection: column-parallel, with its bias;
* MLP down-projection: row-parallel (its bias added once, after the sum);
* attention q/k/v: by heads, with their biases; the output projection by
  heads on its input side (its bias after the sum);
* everything else whole.

The JAX spec shards only leaves whose path holds ``Mlp_`` or
``MultiHeadAttention_``: the ViT's blocks and the final encoder's. The
fusion blocks name theirs ``img_to_hm``, ``hm_to_img``, ``mlp_img`` and
``mlp_hm``, so they stay whole, here too. The port packs q, k and v into
one ``[3D, D]`` weight, rows ``[q; k; v] × (h·hd + j)``: it is sharded as
the view ``[3, H, hd, D]`` on H, never as a plain split of its rows, which
would hand one rank all of q and part of k.

``shard_state_for_tp`` keeps each rank's shards (AdamW moments and EMA
copies follow) and hands each sharded attention and MLP the group
(``module.tp``). Those modules then compute on their shards: the attention
kernels run on the local heads (H/2 on two ranks) as plain tensors, and
the two Megatron operators, f (identity forward, all-reduce backward)
before and g (all-reduce forward, identity backward) after each region,
are :class:`pose3d_tpu_torch.core.comm.CopyToGroup` and
:class:`~pose3d_tpu_torch.core.comm.ReduceFromGroup`. The dropout masks of
a sharded tensor are drawn at full size and cut, so they are the
one-process masks and the ranks' generators stay in step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from torch import nn

from pose3d_tpu_torch.parallel.shard import (
    REPLICATED,
    ParamSpec,
    ShardPlan,
    apply_plan,
    full_shapes,
    jax_layouts,
)


@dataclass(frozen=True)
class TensorParallel:
    """What a sharded module needs: the group, its size and this rank's
    index along the axis."""

    group: object
    size: int
    index: int


def _tp_modules(model: nn.Module):
    """(name, module, {param name: JAX spec}) of each module the JAX spec
    shards: the attention and MLP of every encoder block (ViT and final
    encoder)."""
    from pose3d_tpu_torch.models.transformer import TransformerEncoderBlock

    for bname, blk in model.named_modules():
        if not isinstance(blk, TransformerEncoderBlock):
            continue
        attn = "qkv" if hasattr(blk.attn, "qkv") else None
        if attn:
            a = {"qkv.weight": (None, "model", None),
                 "qkv.bias": ("model", None),
                 "proj.weight": ("model", None, None)}
        else:
            a = {"in_proj_weight": (None, "model", None),
                 "in_proj_bias": ("model", None),
                 "out_proj.weight": ("model", None, None)}
        fc1, fc2 = blk.mlp.names
        m = {f"{fc1}.weight": (None, "model"),
             f"{fc1}.bias": ("model",),
             f"{fc2}.weight": ("model", None)}
        yield f"{bname}.attn", blk.attn, a
        yield f"{bname}.mlp", blk.mlp, m


def tp_param_spec(model: nn.Module) -> Dict[str, ParamSpec]:
    """Parameter name → :class:`ParamSpec` for a transformer (every
    parameter outside the encoder blocks' attention and MLP whole)."""
    lays = jax_layouts(model, full_shapes(model))
    out = {n: REPLICATED for n in lays}
    for mname, _, specs in _tp_modules(model):
        for pname, jspec in specs.items():
            name = f"{mname}.{pname}"
            lay = lays[name]
            out[name] = ParamSpec(lay.to_port(jspec), lay.view)
    return out


def shard_state_for_tp(state, mesh, axis: str = "model"):
    """Shard ``state`` in place by :func:`tp_param_spec` over ``mesh``'s
    ``axis`` (moments and EMA copies follow; buffers and scalars whole) and
    set ``module.tp`` on each sharded attention and MLP. Returns
    ``state``."""
    model = state.model
    specs = {n: ParamSpec(tuple(axis if d else None for d in s.dims), s.view)
             if s.sharded else s for n, s in tp_param_spec(model).items()}
    plan = ShardPlan(mesh, specs, axis, "tp", full_shapes(model))
    apply_plan(state, plan)
    ctx = TensorParallel(plan.group, plan.size, plan.index)
    for _, mod, _ in _tp_modules(model):
        mod.tp = ctx
    return state

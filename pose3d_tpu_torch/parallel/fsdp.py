"""FSDP-style (ZeRO-3) sharding of the parameters and the optimizer state
over the ``data`` axis (counterpart of ``pose3d_tpu/parallel/fsdp.py``).

``fsdp_param_spec`` applies the JAX package's rule to each parameter as
the JAX leaves see it (:func:`.shard.jax_layouts`): a leaf of at least
``min_size`` elements shards its largest dimension whose extent the axis
size divides (the earliest on ties); a dimension a base (tensor-parallel)
spec shards is kept, and FSDP takes another. The result is the same
elements per shard as the JAX layout, which is not FSDP2's default (dim 0
of every tensor).

``shard_state_for_fsdp`` keeps this rank's shard of each such parameter,
of its AdamW moments and of its EMA copy; buffers (BatchNorm running
statistics) and scalars stay whole. A train or eval step then gathers the
full parameters for the forward and the backward
(:meth:`.shard.ShardPlan.unsharded`), and the backward reduce-scatters
each gradient into its shard: the bytes of a data-parallel all-reduce,
with the parameter and moment memory divided by the axis size. The JAX
package lets GSPMD place these collectives; here they are explicit.
"""

from __future__ import annotations

from typing import Dict, Optional

from torch import nn

from pose3d_tpu_torch.parallel.shard import (
    REPLICATED,
    ParamSpec,
    ShardPlan,
    apply_plan,
    full_shapes,
    jax_layouts,
)

# Tiny tensors (biases, norm scales) stay whole: the all-gather latency
# outweighs the few KB saved. 2**13 elements = 32 KiB fp32.
DEFAULT_MIN_SIZE = 2 ** 13


def _fsdp_spec_for(shape, axis_size: int, axis: str, base, min_size: int):
    """The JAX rule on one JAX leaf: a tuple of axis names, one per dim."""
    base_spec = tuple(base) if base is not None else ()
    base_spec = base_spec + (None,) * (len(shape) - len(base_spec))
    size = 1
    for s in shape:
        size *= s
    if size < min_size:
        return base_spec
    best = -1
    for i, extent in enumerate(shape):
        if base_spec[i] is not None:
            continue
        if extent % axis_size == 0 and (best < 0 or extent > shape[best]):
            best = i
    if best < 0:
        return base_spec
    spec = list(base_spec)
    spec[best] = axis
    return tuple(spec)


def fsdp_param_spec(model: nn.Module, axis_size: int, axis: str = "data",
                    base_specs: Optional[Dict[str, ParamSpec]] = None,
                    min_size: int = DEFAULT_MIN_SIZE
                    ) -> Dict[str, ParamSpec]:
    """Parameter name → :class:`ParamSpec` sharding each large parameter
    over ``axis``. ``base_specs`` (e.g. :func:`.tp.tp_param_spec`'s) keep
    their sharded dimensions; FSDP then takes a different one, the 2-D
    fsdp × tp layout."""
    base_specs = base_specs or {}
    out = {}
    for name, lay in jax_layouts(model, full_shapes(model)).items():
        base = base_specs.get(name, REPLICATED)
        jbase = lay.to_jax(base.dims) if base.dims else None
        spec = _fsdp_spec_for(lay.jax_shape, axis_size, axis, jbase,
                              min_size)
        dims = lay.to_port(spec)
        out[name] = (ParamSpec(dims, lay.view, base.stage)
                     if any(d is not None for d in dims)
                     else ParamSpec(stage=base.stage))
    return out


def shard_state_for_fsdp(state, mesh, axis: str = "data",
                         min_size: int = DEFAULT_MIN_SIZE):
    """Shard ``state`` in place over ``mesh``'s ``axis`` by
    :func:`fsdp_param_spec`: parameters, AdamW moments and EMA copies;
    buffers and scalars whole. Returns ``state``; its model carries the
    plan (``model.shard_plan``) that the steps and checkpoints read."""
    specs = fsdp_param_spec(state.model, mesh.shape[axis], axis=axis,
                            min_size=min_size)
    plan = ShardPlan(mesh, specs, axis, "fsdp", full_shapes(state.model))
    return apply_plan(state, plan)

"""Parameters held in shards across ranks: the specs, and the state that
follows them (the machinery under :mod:`.fsdp`, :mod:`.tp` and :mod:`.pp`).

A :class:`ParamSpec` says where a parameter's shards lie, in the port's own
tensor layout: ``dims`` names the mesh axis (or None) of each dimension of
``view``, a reshape of the parameter (None: its own shape), and ``stage``
the pipeline stage that alone holds it. The JAX package's PartitionSpecs
refer to its own leaves (a Dense kernel ``[in, out]``, a conv ``[kh, kw,
in, out]``, attention ``query`` ``[D, H, hd]``); :func:`jax_layouts` maps
each port parameter onto them, so a rule written for the JAX leaves picks
the same elements here (the packed ``[3D, D]`` q/k/v weight is the view
``[3, H, hd, D]``, three JAX leaves of ``[D, H, hd]``).

A :class:`ShardPlan` applies the specs of one mesh axis: each sharded
parameter's data becomes this rank's shard (its view, chunked along the
sharded dimension; an empty tensor on a stage that does not hold it), and
AdamW's moments and the EMA copies follow. :meth:`ShardPlan.gather` is the
collective inverse. The plan hangs on the model as ``model.shard_plan``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from pose3d_tpu_torch.core.comm import (
    all_gather,
    broadcast_,
    reduce_scatter_dim,
)

_MOMENTS = ("exp_avg", "exp_avg_sq")


@dataclass(frozen=True)
class ParamSpec:
    dims: Tuple[Optional[str], ...] = ()
    view: Optional[Tuple[int, ...]] = None
    stage: Optional[int] = None

    @property
    def sharded(self) -> bool:
        return self.stage is not None or any(d is not None for d in self.dims)


REPLICATED = ParamSpec()


@dataclass(frozen=True)
class JaxLayout:
    """``view``: a reshape of the port parameter; ``order[k]``: the view
    dimension of the JAX leaf's dimension k. View dimensions outside
    ``order`` enumerate separate JAX leaves (q, k, v)."""

    view: Tuple[int, ...]
    order: Tuple[int, ...]

    @property
    def jax_shape(self) -> Tuple[int, ...]:
        return tuple(self.view[o] for o in self.order)

    def to_port(self, jax_dims) -> Tuple:
        """Per view dimension, the entry of ``jax_dims`` (one per JAX
        dimension) that lands there (None elsewhere)."""
        out = [None] * len(self.view)
        for k, o in enumerate(self.order):
            out[o] = jax_dims[k]
        return tuple(out)

    def to_jax(self, port_dims) -> Tuple:
        port_dims = tuple(port_dims) + (None,) * (len(self.view)
                                                  - len(port_dims))
        return tuple(port_dims[o] for o in self.order)


def jax_layouts(model: nn.Module, shapes: Optional[Dict] = None
                ) -> Dict[str, JaxLayout]:
    """Parameter name → its :class:`JaxLayout` (``shapes``: full shapes by
    name, for a model whose parameters are already shards)."""
    from pose3d_tpu_torch.models.transformer import (
        MultiHeadAttention,
        TimmAttention,
    )

    special: Dict[str, str] = {}
    heads: Dict[str, int] = {}
    for mname, mod in model.named_modules():
        if isinstance(mod, TimmAttention):
            names = ("qkv.weight", "qkv.bias", "proj.weight")
        elif isinstance(mod, MultiHeadAttention):
            names = ("in_proj_weight", "in_proj_bias", "out_proj.weight")
        else:
            continue
        for role, n in zip(("packed_w", "packed_b", "out_w"), names):
            full = f"{mname}.{n}" if mname else n
            special[full] = role
            heads[full] = mod.heads
    out = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            shape = tuple(shapes[name]) if shapes else tuple(p.shape)
            role = special.get(name)
            if role is not None:
                H = heads[name]
                if role == "packed_w":
                    D = shape[1]
                    out[name] = JaxLayout((3, H, D // H, D), (3, 1, 2))
                elif role == "packed_b":
                    D = shape[0] // 3
                    out[name] = JaxLayout((3, H, D // H), (1, 2))
                else:
                    D = shape[0]
                    out[name] = JaxLayout((D, H, shape[1] // H), (1, 2, 0))
            elif isinstance(mod, nn.Linear) and pname == "weight":
                out[name] = JaxLayout(shape, (1, 0))
            elif isinstance(mod, nn.Conv2d) and pname == "weight":
                out[name] = JaxLayout(shape, (2, 3, 1, 0))
            elif isinstance(mod, nn.Conv1d) and pname == "weight":
                out[name] = JaxLayout(shape, (2, 1, 0))
            else:
                out[name] = JaxLayout(shape, tuple(range(len(shape))))
    return out


def full_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    plan = getattr(model, "shard_plan", None)
    if plan is not None:
        return dict(plan.full_shapes)
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


class ShardPlan:
    """The sharded parameters of ``model`` over mesh axis ``axis``.

    ``kind``: "fsdp" (a step gathers the full parameters for its forward
    and backward: :meth:`unsharded`), "tp" (the modules compute on their
    shards) or "pp" (a stage runs only the blocks it holds)."""

    def __init__(self, mesh, specs: Dict[str, ParamSpec], axis: str,
                 kind: str, shapes: Dict[str, Tuple[int, ...]]):
        self.mesh, self.axis, self.kind = mesh, axis, kind
        self.size = mesh.shape[axis]
        self.index = mesh.axis_index(axis) if self.size > 1 else 0
        self.group = mesh.group(axis)
        self.specs = {n: s for n, s in specs.items() if s.sharded}
        self.full_shapes = dict(shapes)
        for n, s in self.specs.items():
            if s.stage is None and sum(d is not None for d in s.dims) != 1:
                raise NotImplementedError(
                    f"{n}: a spec sharded over {s.dims} (one mesh axis at "
                    "a time is applied)")
            if s.stage is None and s.dims[self._dim(s)] != axis:
                raise ValueError(f"{n}: {s} is not over axis {axis!r}")

    @staticmethod
    def _dim(spec: ParamSpec) -> int:
        return next(i for i, d in enumerate(spec.dims) if d is not None)

    def _owner_rank(self, stage: int) -> int:
        c = self.mesh.coords()
        c[self.axis] = stage
        return int(self.mesh.devices[tuple(c[a]
                                           for a in self.mesh.axis_names)])

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full tensor ``full``."""
        spec = self.specs.get(name)
        if spec is None:
            return full
        if spec.stage is not None:
            return (full.clone() if spec.stage == self.index
                    else full.new_empty(0))
        v = full.reshape(spec.view or full.shape)
        return v.chunk(self.size, self._dim(spec))[self.index].contiguous()

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's shard (collective)."""
        spec = self.specs.get(name)
        if spec is None:
            return local
        shape = self.full_shapes[name]
        if spec.stage is not None:
            buf = (local.clone() if spec.stage == self.index
                   else local.new_empty(shape))
            return broadcast_(buf, self._owner_rank(spec.stage), self.group)
        return torch.cat(all_gather(local, self.group),
                         self._dim(spec)).reshape(shape)

    @contextlib.contextmanager
    def unsharded(self, model: nn.Module, grad: bool):
        """Inside the block the model's sharded parameters are the full
        tensors, gathered from every rank (differentiably when ``grad``:
        the backward reduce-scatters the gradients, summed over the ranks,
        into each shard's ``.grad``)."""
        mods = dict(model.named_modules())
        saved = []
        try:
            for name in self.specs:
                mname, _, pname = name.rpartition(".")
                mod = mods[mname]
                p = mod._parameters[pname]
                if grad and p.requires_grad:
                    full = GatherParam.apply(p, self, name)
                else:
                    full = self.gather(name, p.detach())
                saved.append((mod, pname, p))
                mod._parameters[pname] = full
            yield
        finally:
            for mod, pname, p in saved:
                mod._parameters[pname] = p


class GatherParam(torch.autograd.Function):
    """The full parameter from its shards; backward: this shard's part of
    the gradient summed over the ranks (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, local, plan, name):
        ctx.plan, ctx.name, ctx.shape = plan, name, local.shape
        return plan.gather(name, local)

    @staticmethod
    def backward(ctx, dy):
        plan = ctx.plan
        spec = plan.specs[ctx.name]
        d = plan._dim(spec)
        g = reduce_scatter_dim(dy.reshape(spec.view or dy.shape), plan.group,
                               d)
        return g.reshape(ctx.shape), None, None


def _param_names(state) -> Dict[int, str]:
    return {id(p): n for n, p in state.model.named_parameters()}


def apply_plan(state, plan: ShardPlan):
    """Make ``state`` hold this rank's shards under ``plan``, in place:
    the parameters, their AdamW moments and the EMA copies; buffers
    (BatchNorm running statistics) and scalars stay as they are. Returns
    ``state``."""
    model = state.model
    if getattr(model, "shard_plan", None) is not None:
        raise ValueError("the state is sharded already")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name not in plan.specs:
                continue
            if p.grad is not None:
                p.grad = None
            full_shape = p.shape
            p.data = plan.local(name, p.data)
            st = state.optimizer.state.get(p, {})
            for k in _MOMENTS:
                t = st.get(k)
                if torch.is_tensor(t) and t.shape == full_shape:
                    st[k] = plan.local(name, t)
            if state.ema_params is not None:
                state.ema_params[name] = plan.local(
                    name, state.ema_params[name])
    model.shard_plan = plan
    return state


def full_state(state) -> Tuple[Dict, Dict, Optional[Dict]]:
    """(model state_dict, optimizer state_dict, EMA parameters) with every
    sharded tensor gathered to its full shape: a collective, which every
    rank of a sharded state calls in the same order."""
    model = state.model
    plan = getattr(model, "shard_plan", None)
    sd = model.state_dict()
    opt = state.optimizer.state_dict()
    ema = state.ema_params
    if plan is None:
        return sd, opt, ema
    names = _param_names(state)
    sd = dict(sd)
    for name in plan.specs:
        sd[name] = plan.gather(name, sd[name])
    trainable = state.trainable()
    opt = {"state": dict(opt["state"]), "param_groups": opt["param_groups"]}
    for i, p in enumerate(trainable):
        name = names[id(p)]
        if name not in plan.specs or i not in opt["state"]:
            continue
        st = dict(opt["state"][i])
        for k in _MOMENTS:
            if torch.is_tensor(st.get(k)) and st[k].dim() > 0:
                st[k] = plan.gather(name, st[k])
        opt["state"][i] = st
    if ema is not None:
        ema = {n: plan.gather(n, t) if n in plan.specs else t
               for n, t in ema.items()}
    return sd, opt, ema


def shard_full_state(state, model_sd: Dict, opt_sd: Optional[Dict],
                     ema: Optional[Dict]):
    """The inverse of :func:`full_state` on this rank: full tensors (a
    checkpoint's) → the shards this rank holds. Returns the three
    arguments cut to size."""
    plan = getattr(state.model, "shard_plan", None)
    if plan is None:
        return model_sd, opt_sd, ema
    names = _param_names(state)
    model_sd = {n: plan.local(n, t) if n in plan.specs else t
                for n, t in model_sd.items()}
    if opt_sd is not None:
        opt_sd = {"state": dict(opt_sd["state"]),
                  "param_groups": opt_sd["param_groups"]}
        for i, p in enumerate(state.trainable()):
            name = names[id(p)]
            if name in plan.specs and i in opt_sd["state"]:
                st = dict(opt_sd["state"][i])
                for k in _MOMENTS:
                    if torch.is_tensor(st.get(k)) and st[k].dim() > 0:
                        st[k] = plan.local(name, st[k])
                opt_sd["state"][i] = st
    if ema is not None:
        ema = {n: plan.local(n, t) if n in plan.specs else t
               for n, t in ema.items()}
    return model_sd, opt_sd, ema

"""Collectives over ``torch.distributed`` process groups, and the autograd
Functions that carry them through the backward pass.

Every helper takes ``group=None`` to mean "no peers": it is then the
identity (a one-process mesh, or a mesh axis of size 1), so model code calls
them unconditionally and a single process runs the plain arithmetic.

Transport: NCCL takes CUDA tensors as they are. gloo is the CPU backend;
on CUDA tensors (two ranks sharing one card, where NCCL refuses the
duplicate device) every gloo collective here copies through host memory,
explicitly and always, so that each collective the port uses works on that
backend. Reductions of 16-bit floats over gloo are summed in fp32 and
rounded once (for two ranks the rounding of a native 16-bit add).

Uneven shards (a token axis of 1,025 over two ranks) follow
``torch.tensor_split``: the first ``n % k`` ranks hold one row more.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

_HALF = (torch.bfloat16, torch.float16)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def chunk_sizes(n: int, k: int) -> List[int]:
    """Rows of each of ``k`` shards of ``n`` rows (``torch.tensor_split``)."""
    return [n // k + (1 if i < n % k else 0) for i in range(k)]


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``; returns ``t``."""
    if group is None:
        return t
    staged = _staged(t, group)
    wide = dist.get_backend(group) == "gloo" and t.dtype in _HALF
    if not staged and not wide:
        dist.all_reduce(t, op=op, group=group)
        return t
    h = t.detach().to("cpu", torch.float32 if wide else t.dtype)
    dist.all_reduce(h, op=op, group=group)
    with torch.no_grad():
        t.copy_(h)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in group-rank order."""
    if group is None:
        return [t]
    t = t.contiguous()
    if _staged(t, group):
        h = t.detach().cpu()
        out = [torch.empty_like(h) for _ in range(group_size(group))]
        dist.all_gather(out, h, group=group)
        return [o.to(t.device) for o in out]
    out = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def all_gather_cat(t: torch.Tensor, group, dim: int,
                   sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim``; ``sizes`` gives each
    rank's extent there when they differ (shards are padded to the largest
    for the transfer and trimmed after)."""
    if group is None:
        return t
    if sizes is None or len(set(sizes)) == 1:
        return torch.cat(all_gather(t, group), dim)
    top = max(sizes)
    pad = list(t.shape)
    pad[dim] = top - t.shape[dim]
    padded = torch.cat([t, t.new_zeros(pad)], dim) if pad[dim] else t
    parts = all_gather(padded, group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                     dim)


def reduce_scatter_dim(t: torch.Tensor, group, dim: int,
                       sizes: Optional[Sequence[int]] = None
                       ) -> torch.Tensor:
    """This rank's shard along ``dim`` of the sum of every rank's ``t``:
    NCCL's reduce-scatter for equal shards on the card, else an all-reduce
    and a slice (gloo has no reduce-scatter)."""
    if group is None:
        return t
    k, r = group_size(group), group_rank(group)
    sizes = list(sizes) if sizes is not None else chunk_sizes(t.shape[dim], k)
    if (dist.get_backend(group) == "nccl" and len(set(sizes)) == 1
            and t.is_cuda):
        parts = [p.contiguous() for p in t.split(sizes, dim)]
        out = torch.empty_like(parts[r])
        dist.reduce_scatter(out, parts, group=group)
        return out
    full = all_reduce_(t.clone(), group)
    return full.narrow(dim, sum(sizes[:r]), sizes[r]).contiguous()


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """In place: ``t`` takes the value of global rank ``src``'s ``t``."""
    if group is None:
        return t
    if _staged(t, group):
        h = t.detach().cpu()
        dist.broadcast(h, src=src, group=group)
        with torch.no_grad():
            t.copy_(h)
        return t
    dist.broadcast(t, src=src, group=group)
    return t


def exchange(send: Optional[torch.Tensor], dst: Optional[int],
             recv: Optional[torch.Tensor], src: Optional[int], group) -> None:
    """One point-to-point step: send ``send`` to global rank ``dst`` and
    receive into ``recv`` from global rank ``src`` (either may be None),
    posted together so that a ring of such calls cannot deadlock."""
    staged = any(t is not None and _staged(t, group) for t in (send, recv))
    s = send.detach().cpu() if staged and send is not None else send
    r = recv.detach().cpu() if staged and recv is not None else recv
    ops = []
    if s is not None:
        ops.append(dist.P2POp(dist.isend, s.contiguous(), dst, group))
    if r is not None:
        ops.append(dist.P2POp(dist.irecv, r, src, group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if staged and recv is not None:
        with torch.no_grad():
            recv.copy_(r)


# --- autograd ----------------------------------------------------------------

class AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x; the gradient of each rank's x is Σ_ranks dy (every
    rank's loss reads y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.clone(), ctx.group), None


class CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward; the gradient is summed over the
    group (each rank computed part of it from its shard of the weights)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.clone(), ctx.group), None


class ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: the partial sums of the ranks added in the forward;
    the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class GatherDim(torch.autograd.Function):
    """All-gather along ``dim`` (shards of ``sizes``). Backward: the
    gradient of this rank's shard, summed over the ranks when each rank's
    gradient of the gathered tensor is partial (``partial``: it fed a
    tensor-parallel region), else taken as it is."""

    @staticmethod
    def forward(ctx, x, group, dim, sizes, partial):
        ctx.args = (group, dim, sizes, partial)
        return all_gather_cat(x, group, dim, sizes)

    @staticmethod
    def backward(ctx, dy):
        group, dim, sizes, partial = ctx.args
        r = group_rank(group)
        if partial:
            dx = reduce_scatter_dim(dy, group, dim, sizes)
        else:
            dx = dy.narrow(dim, sum(sizes[:r]), sizes[r])
        return dx, None, None, None, None


class ScatterDim(torch.autograd.Function):
    """This rank's shard along ``dim``: of the ranks' sum when ``partial``
    (a reduce-scatter), else of the tensor as it is. Backward: all-gather."""

    @staticmethod
    def forward(ctx, x, group, dim, sizes, partial):
        ctx.args = (group, dim, sizes)
        if partial:
            return reduce_scatter_dim(x, group, dim, sizes)
        r = group_rank(group)
        return x.narrow(dim, sum(sizes[:r]), sizes[r]).contiguous()

    @staticmethod
    def backward(ctx, dy):
        group, dim, sizes = ctx.args
        return all_gather_cat(dy, group, dim, sizes), None, None, None, None

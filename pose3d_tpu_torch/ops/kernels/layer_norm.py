"""Row LayerNorm over the last axis: the Hopper forward and backward
kernels, their plain versions, and the autograd Function that pairs them
(counterpart of ``pose3d_tpu/ops/pallas/layer_norm.py``).

Forward: ``x`` ``[..., C]`` (bf16 or fp32), ``scale`` and ``bias`` ``[C]``
fp32 give ``(y, mean, rstd)``: per row, in fp32, ``mean = Σx/C``,
``var = max(Σx²/C − mean², 0)`` (one pass), ``rstd = 1/√(var + eps)`` and
``y = (x − mean)·rstd·scale + bias`` rounded to x's dtype; ``mean`` and
``rstd`` are fp32 ``[rows]``.
Backward: with ``x̂ = (x − mean)·rstd`` and ``gs = g·scale``,
``dx = rstd·(gs − mean_row(gs) − x̂·mean_row(gs·x̂))``,
``dscale = Σ_rows g·x̂`` and ``dbias = Σ_rows g``, the two sums in fp32 and
returned in scale's dtype.

:func:`layer_norm_fwd` and :func:`layer_norm_bwd` launch
``csrc/layer_norm_fwd.cu`` and ``csrc/layer_norm_bwd.cu`` and accept only
CUDA tensors; :func:`layer_norm_fwd_reference` and
:func:`layer_norm_bwd_reference` are the plain PyTorch versions the tests
and ``chip_smoke.py`` hold them against. :func:`layer_norm` is the
differentiable op: the kernel pair for a CUDA tensor, the plain pair for a
CPU tensor or when asked for by ``impl="reference"``. No model calls it
(as in the JAX package, where the op stands alone);
:func:`layer_norm_params` carries a module's parameters across.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from pose3d_tpu_torch.ops.kernels import _build
from pose3d_tpu_torch.ops.kernels._launch import (
    SMS,
    on_device,
    refuse_grad_inputs,
    rows_view,
    stream_counters,
)

IMPLS = ("auto", "reference")
_DTYPES = (torch.bfloat16, torch.float32)
_WARPS = 8            # rows a block works on at a time, one warp each
# widest row a lane keeps in registers (32 values a lane); wider rows are
# read twice
_CACHED_C = 1024
_STAGES = 4           # groups of eight rows in flight in a forward block

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "layer_norm_fwd": [_P] * 6 + [_I, _LL, _I, _LL, ctypes.c_float, _P],
    "layer_norm_bwd": [_P] * 9 + [_LL, _P, _LL, _I, _LL, _I, _LL, _P],
}


def layer_norm_fwd_reference(x: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, eps: float = 1e-6
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain PyTorch version with the TPU kernel's arithmetic: fp32, the
    one-pass variance with its clamp at 0 (``F.layer_norm`` takes two
    passes)."""
    x2 = rows_view("layer_norm_fwd_reference", x)
    xf = x2.float()
    mu = xf.mean(1, keepdim=True)
    var = (xf * xf).mean(1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var.clamp_min(0.0) + eps)
    y = (xf - mu) * rstd * scale.float() + bias.float()
    return y.to(x.dtype).view(x.shape), mu[:, 0], rstd[:, 0]


def layer_norm_bwd_reference(x: torch.Tensor, scale: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor,
                             g: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain PyTorch backward, the TPU kernel's arithmetic step by step;
    returns ``(dx`` in x's dtype, ``dscale, dbias`` in scale's dtype)."""
    x2 = rows_view("layer_norm_bwd_reference", x)
    gf = g.reshape(x2.shape).float()
    xhat = (x2.float() - mean[:, None]) * rstd[:, None]
    gs = gf * scale.float()
    m1 = gs.mean(1, keepdim=True)
    m2 = (gs * xhat).mean(1, keepdim=True)
    dx = rstd[:, None] * (gs - m1 - xhat * m2)
    return (dx.to(x.dtype).view(x.shape),
            (gf * xhat).sum(0).to(scale.dtype), gf.sum(0).to(scale.dtype))


def fwd_launch_config(rows: int, C: int, itemsize: int,
                      aligned: bool) -> dict:
    """The forward's plan, mirroring ``pose3d_layer_norm_fwd_config``
    (which :func:`fwd_library_config` reads from the built library).
    ``vec``: values a lane reads at once (16 bytes' worth when ``aligned``
    and C divides, else 1); ``cached``: the TMA ring (``vec`` > 1 and C <=
    1024: each row read once, through shared memory, a lane keeping ``nv``
    16-byte vectors of it), else the row loop (read twice, ``nv`` 0). A
    persistent grid of ``blocks`` of ``threads`` (the ring: eight consumer
    warps and a producer warp; the loop: eight warps), at most
    ``blocks_per_sm`` on each of the card's SMs: the ring two where a lane
    keeps at most 64 words (its ``nv`` vectors and its columns of scale and
    bias), else one; the loop two. Warp g of the grid's W warps takes rows
    g, g + W, ...: at most ``rows_per_warp`` of them. The ring's ``stages``
    of eight rows take ``smem`` bytes of dynamic shared memory. ``launches``:
    one a call. ``aligned``: x, y, scale and bias start on 16 bytes and the
    row stride in bytes is a multiple of 16. A function of the shape only,
    so a shape's outputs are the same from run to run."""
    full = 16 // itemsize
    vec = full if aligned and C % full == 0 else 1
    cached = int(vec > 1 and C <= _CACHED_C)
    nv = -(-C // (32 * vec)) if cached else 0
    per_sm = 2 if nv * (4 + 2 * vec) <= 64 else 1
    blocks = min(SMS * per_sm, -(-rows // _WARPS))
    return dict(vec=vec, cached=cached, nv=nv, blocks=blocks,
                threads=32 * (_WARPS + cached),
                rows_per_warp=-(-rows // (blocks * _WARPS)),
                blocks_per_sm=per_sm, stages=_STAGES * cached,
                smem=_STAGES * _WARPS * C * itemsize * cached, launches=1)


def fwd_library_config(rows: int, C: int, itemsize: int,
                       aligned: bool) -> dict:
    """:func:`fwd_launch_config` as the built library reports it (builds it
    at first use): the card's check that the mirror is the C plan."""
    lib = load_library("layer_norm_fwd")
    cfg = (ctypes.c_longlong * 10)()
    lib.pose3d_layer_norm_fwd_config.argtypes = [_LL, _I, _I, _I, _P]
    rc = lib.pose3d_layer_norm_fwd_config(rows, C, int(itemsize == 2),
                                          int(aligned), cfg)
    _build.raise_if_failed(lib, "layer_norm_fwd config", rc)
    keys = ("vec", "cached", "nv", "blocks", "threads", "rows_per_warp",
            "blocks_per_sm", "stages", "smem", "launches")
    return dict(zip(keys, list(cfg)))


def launch_config(rows: int, C: int, itemsize: int, aligned: bool) -> dict:
    """The backward's plan, mirroring ``pose3d_layer_norm_bwd_config``
    (which :func:`library_config` reads from the built library). ``vec``:
    values a lane reads at once (16 bytes' worth when ``aligned`` and C
    divides, else 1); ``cached``: whether a lane keeps its share of the row
    in registers (C <= 1024); ``nv`` vectors a lane keeps of a row (0 when
    not cached), ``blocks`` of 8 warps on contiguous runs of
    ``rows_per_block`` rows, at most ``blocks_per_sm`` (two for bf16 rows of
    up to 768 columns, else one) on each of the card's SMs (the launch is
    cooperative: every block resident at once), a block's static shared
    memory ``smem`` (the warps' fold when cached, else the combine's lanes),
    the ``scratch_floats`` of the blocks' partial rows [dscale | dbias] (C
    rounded up to 4 each; and a row for each warp when not cached), the two
    ``counters`` of the barrier before they are added, and ``launches``: one
    a call. A function of the shape only, so a shape's gradients are the
    same from run to run."""
    full = 16 // itemsize
    vec = full if aligned and C % full == 0 else 1
    cached = int(C <= _CACHED_C)
    nv = 0 if not cached else (
        _CACHED_C // 32 if vec == 1 else -(-C // (32 * vec)))
    per_sm = 2 if vec == 8 and nv <= 3 else 1
    blocks = min(SMS * per_sm, -(-rows // _WARPS))
    rpb = -(-rows // blocks)
    blocks = -(-rows // rpb)
    width = 2 * (-(-C // 4) * 4)
    scratch = blocks * width * (1 if cached else 1 + _WARPS)
    return dict(vec=vec, cached=cached, nv=nv, blocks=blocks,
                rows_per_block=rpb, blocks_per_sm=per_sm,
                smem=_WARPS * _CACHED_C * 4 if cached else 32 * _WARPS * 16,
                scratch_floats=scratch, counters=2, launches=1)


def library_config(rows: int, C: int, itemsize: int, aligned: bool) -> dict:
    """:func:`launch_config` (the backward's) as the built library reports
    it (builds it at first use): the card's check that the mirror is the C
    dispatch."""
    lib = load_library("layer_norm_bwd")
    cfg = (ctypes.c_longlong * 10)()
    lib.pose3d_layer_norm_bwd_config.argtypes = [_LL, _I, _I, _I, _P]
    rc = lib.pose3d_layer_norm_bwd_config(rows, C, int(itemsize == 2),
                                          int(aligned), cfg)
    _build.raise_if_failed(lib, "layer_norm_bwd config", rc)
    keys = ("vec", "cached", "nv", "blocks", "rows_per_block",
            "blocks_per_sm", "scratch_floats", "counters", "launches",
            "smem")
    return dict(zip(keys, list(cfg)))


def load_library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``'s library
    (``layer_norm_fwd`` or ``layer_norm_bwd``); idempotent."""
    return _build.load_library(name, _ARGTYPES[name])


def _check(fn: str, x2: torch.Tensor, **more) -> None:
    """Raise ValueError for anything the kernels do not take. ``more``:
    name → (tensor, shape, dtype) of every other operand."""
    if x2.dtype not in _DTYPES:
        raise ValueError(f"{fn}: x is {x2.dtype}; supported: bfloat16, "
                         "float32")
    rows, C = x2.shape
    if rows > 1 and x2.stride(0) < C:
        raise ValueError(f"{fn}: rows overlap (strides {x2.stride()}, shape "
                         f"{tuple(x2.shape)})")
    for name, (t, shape, dtype) in more.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise ValueError(f"{fn}: {name} is {t.dtype}, must be {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous (strides "
                             f"{t.stride()}); the kernel never copies")
    tensors = {"x": x2, **{k: v[0] for k, v in more.items()}}
    if not x2.is_cuda or any(t.device != x2.device for t in tensors.values()):
        raise ValueError(
            f"{fn}: {', '.join(tensors)} are on "
            f"{', '.join(str(t.device) for t in tensors.values())}; the "
            "kernel takes CUDA tensors of one device only")


def _ld_aligned(x2: torch.Tensor, *others) -> Tuple[int, bool]:
    rows, C = x2.shape
    ld = x2.stride(0) if rows > 1 else C
    aligned = ((ld * x2.element_size()) % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in (x2, *others)))
    return ld, aligned


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-6
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the Hopper forward kernel on PyTorch's current stream (one
    launch of a persistent grid; the C entry point takes the plan that
    :func:`fwd_launch_config` mirrors, from the shape and the alignment of
    these addresses): ``(y`` like x, ``mean, rstd`` fp32 ``[rows])``.
    Raises on anything it does not take (non-CUDA tensors, other dtypes, a
    last axis that is not contiguous, scale or bias that are not fp32
    ``[C]``) and when the launch is refused; it never copies and never falls
    back to the plain version. With grad mode on it raises for an input that requires grad:
    differentiate through :func:`layer_norm`."""
    refuse_grad_inputs("layer_norm_fwd", "layer_norm()", x, scale, bias)
    x2 = rows_view("layer_norm_fwd", x)
    rows, C = x2.shape
    f32 = torch.float32
    _check("layer_norm_fwd", x2, scale=(scale, (C,), f32),
           bias=(bias, (C,), f32))
    y = torch.empty((rows, C), dtype=x.dtype, device=x.device)
    stats = torch.empty((2, rows), dtype=f32, device=x.device)
    ld = x2.stride(0) if rows > 1 else C
    lib = load_library("layer_norm_fwd")
    with on_device(x.device):
        rc = lib.pose3d_layer_norm_fwd(
            x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(),
            int(x.dtype == torch.bfloat16), rows, C, ld, float(eps),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_if_failed(lib, "layer_norm_fwd", rc)
    layer_norm_fwd.launches += 1
    return y.view(x.shape), stats[0], stats[1]


layer_norm_fwd.launches = 0


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, g: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the Hopper backward kernel on PyTorch's current stream (one
    launch: the blocks' partial rows of dscale and dbias are added in the
    same launch, in a fixed order, no atomics in any sum): ``(dx`` like x,
    ``dscale, dbias`` in scale's dtype). ``g`` must be contiguous and of
    x's dtype and shape. Raises as :func:`layer_norm_fwd` does."""
    refuse_grad_inputs("layer_norm_bwd", "layer_norm()", x, scale, mean, rstd,
                       g)
    x2 = rows_view("layer_norm_bwd", x)
    rows, C = x2.shape
    f32 = torch.float32
    if g.shape != x.shape:
        raise ValueError(f"layer_norm_bwd: g must have x's shape "
                         f"{tuple(x.shape)}, got {tuple(g.shape)}")
    _check("layer_norm_bwd", x2, scale=(scale, (C,), f32),
           mean=(mean, (rows,), f32), rstd=(rstd, (rows,), f32),
           g=(g, tuple(x.shape), x.dtype))
    dx = torch.empty((rows, C), dtype=x.dtype, device=x.device)
    ld, aligned = _ld_aligned(x2, g, dx, scale)
    cfg = launch_config(rows, C, x.element_size(), aligned)
    scratch = torch.empty(cfg["scratch_floats"], dtype=f32, device=x.device)
    out = torch.empty((2, C), dtype=f32, device=x.device)
    lib = load_library("layer_norm_bwd")
    with on_device(x.device):
        counters = stream_counters(x.device, cfg["counters"])
        rc = lib.pose3d_layer_norm_bwd(
            x2.data_ptr(), scale.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), g.data_ptr(), dx.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), scratch.data_ptr(),
            scratch.numel(), counters.data_ptr(), counters.numel(),
            int(x.dtype == torch.bfloat16), rows, C, ld,
            torch.cuda.current_stream().cuda_stream)
    _build.raise_if_failed(lib, "layer_norm_bwd", rc)
    layer_norm_bwd.launches += 1
    return (dx.view(x.shape), out[0].to(scale.dtype),
            out[1].to(scale.dtype))


layer_norm_bwd.launches = 0


class LayerNormFn(torch.autograd.Function):
    """``LayerNormFn.apply(x, scale, bias, eps, use_kernel)`` → y.
    ``use_kernel`` picks the Hopper pair (CUDA tensors only), otherwise the
    plain pair runs, forward and backward. scale and bias enter the
    kernels in fp32; their gradients come back in their own dtype."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, use_kernel: bool):
        fwd = layer_norm_fwd if use_kernel else layer_norm_fwd_reference
        with torch.no_grad():
            y, mean, rstd = fwd(x, scale.float(), bias.float(), eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.use_kernel = use_kernel
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, scale, mean, rstd = ctx.saved_tensors
        bwd = layer_norm_bwd if ctx.use_kernel else layer_norm_bwd_reference
        # autograd hands g over in whatever layout the next op produced
        dx, dscale, dbias = bwd(x, scale.float(), mean, rstd,
                                g.contiguous())
        return (dx, dscale.to(scale.dtype), dbias.to(ctx.bias_dtype), None,
                None)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6, impl: str = "auto") -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (any leading shape): fp32
    statistics, output in x's dtype; differentiable in x, scale and bias.

    ``impl="auto"``: the kernels for a CUDA tensor (they raise rather than
    degrade to the plain version), the plain pair for a CPU tensor.
    ``impl="reference"`` forces the plain pair on any device (the on-card
    comparisons)."""
    if impl not in IMPLS:
        raise ValueError(f"layer_norm impl {impl!r} not in {IMPLS}")
    use_kernel = impl == "auto" and x.device.type != "cpu"
    return LayerNormFn.apply(x, scale, bias, float(eps), use_kernel)


def layer_norm_params(source) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scale, bias)`` for :func:`layer_norm` from a ``torch.nn.LayerNorm``
    (``weight``, ``bias``: the tensors themselves) or from a flax
    ``LayerNorm``'s parameters (a mapping with ``scale`` and ``bias``,
    numpy leaves: copied into contiguous tensors)."""
    if isinstance(source, torch.nn.LayerNorm):
        return source.weight, source.bias
    return tuple(torch.from_numpy(np.array(source[k], copy=True))
                 for k in ("scale", "bias"))

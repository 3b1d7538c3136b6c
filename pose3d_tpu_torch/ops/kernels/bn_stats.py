"""Per-channel moments for BatchNorm statistics: the Hopper kernel, its
plain version and the autograd Function (counterpart of
``pose3d_tpu/ops/pallas/bn_stats.py``).

``x`` ``[n, C]`` (bf16 or fp32, channels contiguous, any row stride) gives
``(s1, s2)``, fp32 ``[C]`` each: ``s1 = Σ_r x[r]`` and ``s2 = Σ_r x[r]²``
with fp32 accumulation, from one read of x, for any ``n >= 1``.

:func:`bn_stats` launches ``csrc/bn_stats.cu`` and accepts only CUDA
tensors; :func:`bn_stats_reference` is the plain PyTorch version the tests
and ``chip_smoke.py`` hold it against. :class:`BnStats` is the
differentiable pair: the kernel (CUDA tensors) or the plain version as its
forward, and the closed-form plain-PyTorch backward
``dx = g1 + 2·x·g2`` (the TPU kernel's backward has no kernel either).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pose3d_tpu_torch.ops.kernels import _build
from pose3d_tpu_torch.ops.kernels._launch import (
    SMS,
    on_device,
    stream_counters,
)

_DTYPES = (torch.bfloat16, torch.float32)
# one block is 32 row lanes x 8 threads along a tile of channels (16 bytes
# a thread: 64 bf16 / 32 fp32 channels); each lane has 8 rows in flight
_THREADS = 256
_TX = 8
_BATCH = _THREADS // _TX * 8
# the grid: at most three resident blocks on each of the card's SMs (the
# launch is cooperative: every block resident at once)
_PER_SM = 3

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 4 + [_LL, _P, _LL, _I, _LL, _I, _LL, _P]


def bn_stats_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: fp32 Σx and Σx² over the rows."""
    xf = x.float()
    return xf.sum(0), (xf * xf).sum(0)


def bn_stats_backward(x: torch.Tensor, g1: torch.Tensor,
                      g2: torch.Tensor) -> torch.Tensor:
    """Closed-form gradient of ``(s1, s2)`` with respect to x:
    ``g1 + 2·x·g2`` in fp32, cast to x's dtype."""
    return (g1[None, :] + 2.0 * x.float() * g2[None, :]).to(x.dtype)


def launch_config(n: int, C: int, itemsize: int, aligned: bool) -> dict:
    """The plan of a launch, mirroring ``pose3d_bn_stats_config`` (which
    :func:`library_config` reads from the built library): ``vec`` channels
    a thread reads at once (16 bytes' worth when ``aligned`` and C
    divides, else 1), ``tiles`` of 8·vec channels, ``blocks`` row runs of
    ``rows_per_block`` (whole batches of 256 rows) for each tile, the grid
    ``(tiles, blocks)`` at most ``blocks_per_sm`` blocks on each SM, a
    block's static shared memory ``smem`` (the eight warps' fold and the
    combine's lanes), the ``scratch_floats`` of the partial rows [s1 | s2]
    and the ``counters`` of the barrier before they are added (two a
    tile), and ``launches``: one a call. A function of the shape only, so
    a shape's sums are the same from run to run."""
    full = 16 // itemsize
    vec = full if aligned and C % full == 0 else 1
    width = _TX * vec
    tiles = -(-C // width)
    batches = -(-n // _BATCH)
    per_block = -(-batches // max(1, _PER_SM * SMS // tiles))
    blocks = -(-batches // per_block)
    return dict(vec=vec, tiles=tiles, blocks=blocks,
                rows_per_block=per_block * _BATCH, blocks_per_sm=_PER_SM,
                smem=8 * 2 * width * 4 + _THREADS * 16,
                scratch_floats=tiles * blocks * 2 * width,
                counters=2 * tiles, launches=1)


def library_config(n: int, C: int, itemsize: int, aligned: bool) -> dict:
    """:func:`launch_config` as the built library reports it (builds it at
    first use): the card's check that the mirror is the C dispatch."""
    lib = load_library()
    cfg = (ctypes.c_longlong * 9)()
    lib.pose3d_bn_stats_config.argtypes = [_LL, _I, _I, _I, _P]
    rc = lib.pose3d_bn_stats_config(n, C, int(itemsize == 2), int(aligned),
                                    cfg)
    _build.raise_if_failed(lib, "bn_stats config", rc)
    keys = ("vec", "tiles", "blocks", "rows_per_block", "blocks_per_sm",
            "scratch_floats", "counters", "launches", "smem")
    return dict(zip(keys, list(cfg)))


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/bn_stats.cu``'s library;
    idempotent."""
    return _build.load_library("bn_stats", _ARGTYPES)


def _check(x: torch.Tensor) -> None:
    """Raise ValueError for anything the kernel does not take."""
    if x.dim() != 2:
        raise ValueError(f"bn_stats: x must be [n, C], got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"bn_stats: x is {x.dtype}; supported: bfloat16, "
                         "float32")
    n, C = x.shape
    if n < 1 or C < 1:
        raise ValueError(f"bn_stats: empty input {tuple(x.shape)}")
    if C > 1 and x.stride(1) != 1:
        raise ValueError(
            f"bn_stats: channels must be contiguous; got strides "
            f"{x.stride()} for shape {tuple(x.shape)} (the kernel reads "
            "rows by their stride but never copies: pass a [n, C] view of "
            "a channels-last activation)")
    if n > 1 and x.stride(0) < C:
        raise ValueError(
            f"bn_stats: rows overlap (strides {x.stride()}, shape "
            f"{tuple(x.shape)})")
    if not x.is_cuda:
        raise ValueError(f"bn_stats: x is on {x.device}; the kernel takes "
                         "CUDA tensors only")


def bn_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on PyTorch's current stream. Raises on
    anything it does not take (non-CUDA tensors, other dtypes, channels
    that are not contiguous) and when the launch is refused; it never
    copies x and never falls back to the plain version.

    The outputs carry no autograd graph, so with grad mode on it raises
    for an input that requires grad: differentiate through
    :class:`BnStats`."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            "bn_stats: x requires grad, and the raw kernel would drop its "
            "gradient; call BnStats.apply instead")
    _check(x)
    n, C = x.shape
    ld = x.stride(0) if n > 1 else C
    aligned = (x.data_ptr() % 16 == 0
               and (ld * x.element_size()) % 16 == 0)
    cfg = launch_config(n, C, x.element_size(), aligned)
    lib = load_library()
    dev = x.device
    out = torch.empty((2, C), dtype=torch.float32, device=dev)
    scratch = torch.empty(cfg["scratch_floats"], dtype=torch.float32,
                          device=dev)
    s1 = out.data_ptr()
    with on_device(dev):
        counters = stream_counters(dev, cfg["counters"])
        rc = lib.pose3d_bn_stats(
            x.data_ptr(), s1, s1 + 4 * C, scratch.data_ptr(),
            scratch.numel(), counters.data_ptr(), counters.numel(),
            int(x.dtype == torch.bfloat16), n, C, ld,
            torch.cuda.current_stream().cuda_stream)
    _build.raise_if_failed(lib, "bn_stats", rc)
    bn_stats.launches += 1
    return out[0], out[1]


bn_stats.launches = 0


class BnStats(torch.autograd.Function):
    """Differentiable moments: ``BnStats.apply(x, use_kernel)`` →
    ``(s1, s2)``. ``use_kernel`` picks the Hopper kernel (CUDA tensors
    only), otherwise the plain version runs; the backward is the closed
    form in plain PyTorch either way."""

    @staticmethod
    def forward(ctx, x, use_kernel: bool):
        ctx.save_for_backward(x)
        return bn_stats(x) if use_kernel else bn_stats_reference(x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g1, g2):
        (x,) = ctx.saved_tensors
        return bn_stats_backward(x, g1, g2), None

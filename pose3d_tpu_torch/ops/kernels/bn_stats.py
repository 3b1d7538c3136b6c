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

import contextlib
import ctypes
from typing import Tuple

import torch

from pose3d_tpu_torch.ops.kernels import _build

_DTYPES = (torch.bfloat16, torch.float32)
_THREADS = 256
# one 256-thread block reduces one chunk of rows for one tile of channels;
# the grid aims at this many blocks (4 for each of the card's 132 SMs)
_TARGET_BLOCKS = 528
# rows each of a block's row lanes should at least walk
_MIN_ROWS_PER_LANE = 8

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 5 + [_I, _LL, _I, _LL, _I, _I, _I, _P]


def bn_stats_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: fp32 Σx and Σx² over the rows."""
    xf = x.float()
    return xf.sum(0), (xf * xf).sum(0)


def bn_stats_backward(x: torch.Tensor, g1: torch.Tensor,
                      g2: torch.Tensor) -> torch.Tensor:
    """Closed-form gradient of ``(s1, s2)`` with respect to x:
    ``g1 + 2·x·g2`` in fp32, cast to x's dtype."""
    return (g1[None, :] + 2.0 * x.float() * g2[None, :]).to(x.dtype)


def launch_config(n: int, C: int, itemsize: int, aligned: bool
                  ) -> Tuple[int, int, int]:
    """(vec, tx, chunks) of a launch: channels per thread (16 bytes' worth
    when ``aligned`` and C divides, else 1), threads along the channel
    vectors (a power of two; the block's other 256/tx threads are row
    lanes), and the number of row chunks whose partial sums the second
    kernel adds. A function of the shapes only, so a shape's sums are the
    same from run to run."""
    full = 16 // itemsize
    vec = full if aligned and C % full == 0 else 1
    vecs = -(-C // vec)
    tx = 1
    while tx < vecs and tx < (32 if vec > 1 else _THREADS):
        tx *= 2
    ty = _THREADS // tx
    ctiles = -(-vecs // tx)
    chunks = min(max(1, _TARGET_BLOCKS // ctiles),
                 max(1, n // (ty * _MIN_ROWS_PER_LANE)))
    return vec, tx, chunks


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
    vec, tx, chunks = launch_config(n, C, x.element_size(), aligned)
    lib = load_library()
    dev = x.device
    out = torch.empty((2, C), dtype=torch.float32, device=dev)
    s1 = out.data_ptr()
    if chunks > 1:
        partial = torch.empty((2, chunks, C), dtype=torch.float32,
                              device=dev)
        p1 = partial.data_ptr()
    else:
        p1 = s1                      # unused: the kernel writes s1, s2
    # entering a device context costs tens of microseconds per launch;
    # the model's tensors live on the current device
    on_device = (contextlib.nullcontext()
                 if dev.index == torch.cuda.current_device()
                 else torch.cuda.device(dev))
    with on_device:
        rc = lib.pose3d_bn_stats(
            x.data_ptr(), s1, s1 + 4 * C, p1, p1 + 4 * chunks * C,
            int(x.dtype == torch.bfloat16), n, C, ld, chunks, vec, tx,
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

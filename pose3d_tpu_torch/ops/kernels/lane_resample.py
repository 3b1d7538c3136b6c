"""Per-row affine 1-D resample: the Hopper kernel and its plain version
(counterpart of ``pose3d_tpu/ops/pallas/lane_resample.py``).

``x`` ``[N, W]`` fp32 or bf16, ``a`` and ``o`` ``[N]`` fp32 give ``out``
``[N, W]`` in x's dtype with ``out[n, j]`` = row n sampled at ``p = a[n]·j + o[n]``: order 1
is two-tap linear with partial edge weights (positions in (−1, 0) and
(W−1, W) blend toward the constant 0), order 0 is the pixel
``floor(p + 0.5)``; anything outside ``[0, W−1]`` contributes 0. These are
the semantics of ``map_coordinates(order, mode="constant", cval=0)`` along
one axis. No gradient flows through it: the augmentor warps data.
As in the TPU kernel, the positions stay fp32 and everything after them is
in x's dtype: the weight ``p − floor(p)`` is cast to it, and the masks,
products and the sum are rounded to it one by one (in bf16 the kernel
rounds each fp32 result, the plain version lets PyTorch's bf16 operators
do the same). The augmentor calls it in fp32.

:func:`lane_resample` launches ``csrc/lane_resample.cu`` and accepts only
CUDA tensors; :func:`lane_resample_reference` is the plain PyTorch version
the tests and ``chip_smoke.py`` hold it against; :func:`resample_rows` is
what the augmentor calls: the kernel for CUDA tensors, the plain version
for CPU tensors or when asked for by ``impl="reference"``.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Tuple

import torch

from pose3d_tpu_torch.ops.kernels import _build

IMPLS = ("auto", "reference")
_THREADS = 256
# threads along a row: at least a warp, so that a warp's loads stay in one
# row
_MIN_TX = 32

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 4 + [_LL, _I, _I, _I, _I, _P]
_DTYPES = (torch.float32, torch.bfloat16)


def lane_resample_reference(x: torch.Tensor, a: torch.Tensor,
                            o: torch.Tensor, order: int = 1) -> torch.Tensor:
    """Plain PyTorch version: fp32 positions, clipped indices, ``gather``,
    masks and weights in x's dtype, each product and sum rounded on its own
    (no fused multiply-add), in the kernel's order."""
    if order not in (0, 1):
        raise ValueError(f"lane_resample: order must be 0 or 1, got {order}")
    w = x.shape[1]
    j = torch.arange(w, dtype=torch.float32, device=x.device)
    p = a[:, None] * j[None, :] + o[:, None]

    def take(f):
        """x[n, f] and the validity of the unclipped f."""
        v = torch.gather(x, 1, f.clamp(0, w - 1).long())
        return v, ((f >= 0) & (f <= w - 1)).to(x.dtype)

    if order == 0:
        v, valid = take(torch.floor(p + 0.5))
        return v * valid
    f = torch.floor(p)
    wt = (p - f).to(x.dtype)
    v0, m0 = take(f)
    v1, m1 = take(f + 1)
    return v0 * m0 * (1.0 - wt) + v1 * m1 * wt


def launch_config(n: int, w: int) -> Tuple[int, int, int]:
    """(tx, ty, blocks) of a launch: tx threads along the columns (a power
    of two from 32 to 256, the least that covers W or 256), ty = 256/tx
    rows to a block, and the number of blocks on ``gridDim.x``."""
    tx = _MIN_TX
    while tx < w and tx < _THREADS:
        tx *= 2
    ty = _THREADS // tx
    return tx, ty, -(-n // ty)


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/lane_resample.cu``'s library;
    idempotent."""
    return _build.load_library("lane_resample", _ARGTYPES)


def _check(x: torch.Tensor, a: torch.Tensor, o: torch.Tensor,
           order: int) -> None:
    """Raise ValueError for anything the kernel does not take."""
    if order not in (0, 1):
        raise ValueError(f"lane_resample: order must be 0 or 1, got {order}")
    if x.dim() != 2:
        raise ValueError(f"lane_resample: x must be [N, W], got shape "
                         f"{tuple(x.shape)}")
    n, w = x.shape
    if n < 1 or w < 1:
        raise ValueError(f"lane_resample: empty input {tuple(x.shape)}")
    if a.shape != (n,) or o.shape != (n,):
        raise ValueError(f"lane_resample: a and o must be [{n}], got "
                         f"{tuple(a.shape)} and {tuple(o.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"lane_resample: x is {x.dtype}; the kernel takes "
                         "float32 or bfloat16")
    for name, t in (("a", a), ("o", o)):
        if t.dtype != torch.float32:
            raise ValueError(f"lane_resample: {name} is {t.dtype}; the "
                             "positions are float32")
    for name, t in (("x", x), ("a", a), ("o", o)):
        if not t.is_contiguous():
            raise ValueError(
                f"lane_resample: {name} is not contiguous (strides "
                f"{t.stride()} for shape {tuple(t.shape)}); the kernel never "
                "copies: make the layout copy explicit at the call")
    for name, t in (("x", x), ("a", a), ("o", o)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"lane_resample: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors of one device only")


def lane_resample(x: torch.Tensor, a: torch.Tensor, o: torch.Tensor,
                  order: int = 1) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream. Raises on
    anything it does not take (non-CUDA tensors, x neither fp32 nor bf16,
    positions other than fp32, tensors that are not contiguous) and when the launch is refused; it never copies an
    input and never falls back to the plain version.

    The output carries no autograd graph, so with grad mode on it raises
    for an input that requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, a, o)):
        raise RuntimeError(
            "lane_resample: an input requires grad, and the kernel would "
            "drop its gradient; the warp is not differentiable (call it "
            "under torch.no_grad() on data)")
    _check(x, a, o, order)
    n, w = x.shape
    tx, _, _ = launch_config(n, w)
    lib = load_library()
    out = torch.empty_like(x)
    dev = x.device
    on_device = (contextlib.nullcontext()
                 if dev.index == torch.cuda.current_device()
                 else torch.cuda.device(dev))
    with on_device:
        rc = lib.pose3d_lane_resample(
            x.data_ptr(), a.data_ptr(), o.data_ptr(), out.data_ptr(), n, w,
            order, tx, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_if_failed(lib, "lane_resample", rc)
    lane_resample.launches += 1
    return out


lane_resample.launches = 0


def resample_rows(x: torch.Tensor, a: torch.Tensor, o: torch.Tensor,
                  order: int = 1, impl: str = "auto") -> torch.Tensor:
    """``impl="auto"``: the kernel for a CUDA tensor (it raises rather than
    degrade to the plain version), the plain version for a CPU tensor.
    ``impl="reference"`` forces the plain version on any device (the
    on-card comparisons)."""
    if impl not in IMPLS:
        raise ValueError(f"resample impl {impl!r} not in {IMPLS}")
    if impl == "auto" and x.device.type != "cpu":
        return lane_resample(x, a, o, order)
    return lane_resample_reference(x, a, o, order)

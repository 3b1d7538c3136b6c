"""The transformer MLP core, Linear → exact GELU → Linear, as one fused op:
the Hopper forward and backward kernels, their plain versions, and the
autograd Function that pairs them (counterpart of
``pose3d_tpu/ops/pallas/mlp_block.py``).

Forward: ``x`` ``[..., D]`` (bf16 or fp32), ``w1`` ``[D, H]``, ``b1``
``[H]``, ``w2`` ``[H, D]``, ``b2`` ``[D]`` (the JAX layout: ``x @ w1``) give
``out = gelu(x·w1 + b1)·w2 + b2`` in x's dtype. Both products accumulate
in fp32 from operands in x's dtype (the weights are cast outside the
kernel, as in JAX); ``a = x·w1 + b1`` stays fp32; GELU is
``a·½·(1 + erf(a/√2))`` with erf by Abramowitz–Stegun 7.1.26 (the TPU
kernel's polynomial, max error 1.5e-7); ``gelu(a)`` is rounded to x's dtype
before the second product. The ``[N, H]`` hidden activation never reaches
device memory.
Backward: the hidden is recomputed from x; ``dga = g·w2ᵀ`` (fp32),
``da = dga·(Φ(a) + a·φ(a))`` rounded to x's dtype, ``dx = da·w1ᵀ``,
``dw1 = xᵀ·da``, ``db1 = Σ da`` (of the rounded da), ``dw2 = gelu(a)ᵀ·g``,
``db2 = Σ g``, all accumulated in fp32 and returned in each parameter's own
dtype.

:func:`mlp_block_fwd` and :func:`mlp_block_bwd` launch
``csrc/mlp_block_fwd.cu`` and ``csrc/mlp_block_bwd.cu`` and accept only
CUDA tensors; :func:`mlp_block_fwd_reference` and
:func:`mlp_block_bwd_reference` are the plain PyTorch versions the tests
and ``chip_smoke.py`` hold them against. :func:`fused_mlp` is the
differentiable op: the kernel pair for a CUDA tensor, the plain pair for a
CPU tensor or when asked for by ``impl="reference"``. No model calls it
(as in the JAX package, where the op stands alone); :func:`mlp_params`
carries a module's parameters across.

The plain versions round only where the kernels round: a bf16
``torch.matmul`` would return bf16 and so round ``a`` before the GELU and
``dga`` before its product, hence every product here is taken in fp32 of
operands already rounded to x's dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from pose3d_tpu_torch.ops.kernels import _build
from pose3d_tpu_torch.ops.kernels._launch import (
    on_device,
    refuse_grad_inputs,
    rows_view,
)

IMPLS = ("auto", "reference")
_DTYPES = (torch.bfloat16, torch.float32)
# a block keeps its [rows, D] output tile in registers, six 16-column
# fragments to each of its eight warps: D <= 768
MAX_D = 768

_SQRT_HALF = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "mlp_block_fwd": [_P] * 6 + [_I, _LL, _I, _I, _P],
    "mlp_block_bwd": [_P] * 10 + [_I, _LL, _I, _I, _P],
}


def erf_as(z: torch.Tensor) -> torch.Tensor:
    """erf by Abramowitz–Stegun 7.1.26 (max abs error 1.5e-7), the
    polynomial of the TPU kernel and of the Hopper kernels."""
    s = torch.sign(z)
    z = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * z)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return s * (1.0 - poly * torch.exp(-z * z))


def gelu_as(a: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU with :func:`erf_as`."""
    return a * 0.5 * (1.0 + erf_as(a * _SQRT_HALF))


def gelu_grad_as(a: torch.Tensor) -> torch.Tensor:
    """d gelu / da = Φ(a) + a·φ(a), Φ with :func:`erf_as`."""
    cdf = 0.5 * (1.0 + erf_as(a * _SQRT_HALF))
    pdf = torch.exp(-0.5 * a * a) * _INV_SQRT_2PI
    return cdf + a * pdf


def _hidden(x2, w1, b1):
    """fp32 ``a = x·w1 + b1`` from operands rounded to x's dtype."""
    return x2.float() @ w1.to(x2.dtype).float() + b1.float()


def mlp_block_fwd_reference(x: torch.Tensor, w1: torch.Tensor,
                            b1: torch.Tensor, w2: torch.Tensor,
                            b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's arithmetic and its
    roundings only (module docstring)."""
    x2 = rows_view("mlp_block_fwd_reference", x)
    ga = gelu_as(_hidden(x2, w1, b1)).to(x.dtype)
    out = ga.float() @ w2.to(x.dtype).float() + b2.float()
    return out.to(x.dtype).view(x.shape)


def mlp_block_bwd_reference(x: torch.Tensor, w1: torch.Tensor,
                            b1: torch.Tensor, w2: torch.Tensor,
                            b2: torch.Tensor, g: torch.Tensor
                            ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch backward, the TPU kernel's arithmetic step by step:
    ``(dx, dw1, db1, dw2, db2)``, dx in x's dtype, the others in their
    parameter's (``b2`` is read for its dtype only)."""
    x2 = rows_view("mlp_block_bwd_reference", x)
    dt = x.dtype
    gf = g.reshape(x2.shape).to(dt).float()
    w1c, w2c = w1.to(dt).float(), w2.to(dt).float()
    a = _hidden(x2, w1, b1)
    ga = gelu_as(a).to(dt).float()
    dga = gf @ w2c.t()
    da = (dga * gelu_grad_as(a)).to(dt).float()
    dx = da @ w1c.t()
    return (dx.to(dt).view(x.shape),
            (x2.float().t() @ da).to(w1.dtype), da.sum(0).to(b1.dtype),
            (ga.t() @ gf).to(w2.dtype), gf.sum(0).to(b2.dtype))


def load_library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``'s library
    (``mlp_block_fwd`` or ``mlp_block_bwd``); idempotent."""
    return _build.load_library(name, _ARGTYPES[name])


def _check(fn: str, x2, w1, b1, w2, b2, g=None) -> Tuple[int, int, int]:
    """Raise ValueError for anything the kernels do not take; returns
    (N, D, H)."""
    if x2.dtype not in _DTYPES:
        raise ValueError(f"{fn}: x is {x2.dtype}; supported: bfloat16, "
                         "float32")
    N, D = x2.shape
    if w1.dim() != 2 or w1.shape[0] != D:
        raise ValueError(f"{fn}: w1 must be [D={D}, H], got "
                         f"{tuple(w1.shape)}")
    H = w1.shape[1]
    want = {"b1": (b1, (H,)), "w2": (w2, (H, D)), "b2": (b2, (D,))}
    if g is not None:
        want["g"] = (g, (N, D))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if D % 16 or H % 16 or D > MAX_D:
        raise ValueError(
            f"{fn}: D={D}, H={H}: the kernels take D and H that are "
            f"multiples of 16 (tensor-core tiles) and D <= {MAX_D} (a "
            "block keeps its output tile of width D in registers)")
    named = {"x": x2, "w1": w1, "b1": b1, "w2": w2, "b2": b2}
    if g is not None:
        named["g"] = g
    for name, t in named.items():
        if t.dtype != (torch.float32 if name in ("b1", "b2") else x2.dtype):
            raise ValueError(f"{fn}: {name} is {t.dtype}; x, w1, w2 and g "
                             "must share x's dtype, b1 and b2 be float32 "
                             "(fused_mlp casts them)")
        if not t.is_contiguous():
            raise ValueError(
                f"{fn}: {name} is not contiguous (strides {t.stride()} for "
                f"shape {tuple(t.shape)}); the kernel never copies: make "
                "the layout copy explicit at the call")
    if not x2.is_cuda or any(t.device != x2.device for t in named.values()):
        raise ValueError(
            f"{fn}: {', '.join(named)} are on "
            f"{', '.join(str(t.device) for t in named.values())}; the "
            "kernel takes CUDA tensors of one device only")
    for name, t in named.items():
        if t.data_ptr() % 32:
            raise ValueError(f"{fn}: {name} starts at an address that is "
                             "not a multiple of 32 bytes (the tensor cores' "
                             "loads need it)")
    return N, D, H


def mlp_block_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper forward kernel on PyTorch's current stream.
    ``w1`` and ``w2`` must already be in x's dtype and ``b1``, ``b2`` in
    fp32 (:func:`fused_mlp` casts them). Raises on anything the kernel does
    not take (non-CUDA tensors, other dtypes, tensors that are not
    contiguous, D or H not a multiple of 16, D > 768) and when the launch
    is refused; it never copies and never falls back to the plain version.
    With grad mode on it raises for an input that requires grad:
    differentiate through :func:`fused_mlp`."""
    refuse_grad_inputs("mlp_block_fwd", "fused_mlp()", x, w1, b1, w2, b2)
    x2 = rows_view("mlp_block_fwd", x)
    N, D, H = _check("mlp_block_fwd", x2, w1, b1, w2, b2)
    out = torch.empty((N, D), dtype=x.dtype, device=x.device)
    lib = load_library("mlp_block_fwd")
    with on_device(x.device):
        rc = lib.pose3d_mlp_block_fwd(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
            N, D, H, torch.cuda.current_stream().cuda_stream)
    _build.raise_if_failed(lib, "mlp_block_fwd", rc)
    mlp_block_fwd.launches += 1
    return out.view(x.shape)


mlp_block_fwd.launches = 0


def mlp_block_bwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor, g: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """Launch the Hopper backward on PyTorch's current stream: two
    kernels from one source, one over row tiles for dx, one over chunks of
    the hidden axis for dw1, db1, dw2 and db2 (no atomics: a shape's
    gradients are the same from run to run). One call counts as one
    launch. Returns ``(dx`` in x's dtype, ``dw1, db1, dw2, db2`` in
    fp32``)``; operands as :func:`mlp_block_fwd`, ``g`` contiguous and of
    x's dtype and shape (``b2`` is checked, not read)."""
    refuse_grad_inputs("mlp_block_bwd", "fused_mlp()", x, w1, b1, w2, b2, g)
    x2 = rows_view("mlp_block_bwd", x)
    if g.shape != x.shape:
        raise ValueError(f"mlp_block_bwd: g must have x's shape "
                         f"{tuple(x.shape)}, got {tuple(g.shape)}")
    if not g.is_contiguous():
        raise ValueError(f"mlp_block_bwd: g is not contiguous (strides "
                         f"{g.stride()}); the kernel never copies")
    N, D, H = _check("mlp_block_bwd", x2, w1, b1, w2, b2, g.view(x2.shape))
    f32 = torch.float32
    dx = torch.empty((N, D), dtype=x.dtype, device=x.device)
    dw1 = torch.empty((D, H), dtype=f32, device=x.device)
    dw2 = torch.empty((H, D), dtype=f32, device=x.device)
    db1 = torch.empty((H,), dtype=f32, device=x.device)
    db2 = torch.empty((D,), dtype=f32, device=x.device)
    lib = load_library("mlp_block_bwd")
    with on_device(x.device):
        rc = lib.pose3d_mlp_block_bwd(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            g.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            dw2.data_ptr(), db2.data_ptr(), int(x.dtype == torch.bfloat16),
            N, D, H, torch.cuda.current_stream().cuda_stream)
    _build.raise_if_failed(lib, "mlp_block_bwd", rc)
    mlp_block_bwd.launches += 1
    return dx.view(x.shape), dw1, db1, dw2, db2


mlp_block_bwd.launches = 0


class FusedMlp(torch.autograd.Function):
    """``FusedMlp.apply(x, w1, b1, w2, b2, use_kernel)`` → out.
    ``use_kernel`` picks the Hopper pair (CUDA tensors only), otherwise the
    plain pair runs, forward and backward. The weights are cast to x's
    dtype and the biases to fp32 here, outside the kernels; every gradient
    comes back in its parameter's own dtype."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, use_kernel: bool):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.use_kernel = use_kernel
        with torch.no_grad():
            if use_kernel:
                return mlp_block_fwd(x, w1.to(x.dtype), b1.float(),
                                     w2.to(x.dtype), b2.float())
            return mlp_block_fwd_reference(x, w1, b1, w2, b2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        # autograd hands g over in whatever layout the next op produced
        g = g.contiguous()
        if ctx.use_kernel:
            dx, dw1, db1, dw2, db2 = mlp_block_bwd(
                x, w1.to(x.dtype), b1.float(), w2.to(x.dtype), b2.float(), g)
            grads = (dx, dw1.to(w1.dtype), db1.to(b1.dtype),
                     dw2.to(w2.dtype), db2.to(b2.dtype))
        else:
            grads = mlp_block_bwd_reference(x, w1, b1, w2, b2, g)
        return (*grads, None)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              impl: str = "auto") -> torch.Tensor:
    """``gelu_exact(x @ w1 + b1) @ w2 + b2`` over the last axis of ``x``
    (any leading shape), output in x's dtype; differentiable in all five.

    ``impl="auto"``: the kernels for a CUDA tensor (they raise rather than
    degrade to the plain version), the plain pair for a CPU tensor.
    ``impl="reference"`` forces the plain pair on any device (the on-card
    comparisons)."""
    if impl not in IMPLS:
        raise ValueError(f"fused_mlp impl {impl!r} not in {IMPLS}")
    use_kernel = impl == "auto" and x.device.type != "cpu"
    return FusedMlp.apply(x, w1, b1, w2, b2, use_kernel)


def mlp_params(source) -> Tuple[torch.Tensor, ...]:
    """``(w1 [D, H], b1, w2 [H, D], b2)`` for :func:`fused_mlp`,
    contiguous, from the port's ``Mlp`` module (two ``nn.Linear``s under
    the keys in ``source.names``, ``("fc1", "fc2")`` or ``("0", "3")``,
    weights ``[out, in]``: transposed copies) or from a flax ``Mlp``'s
    parameters (a mapping ``Dense_0``/``Dense_1`` → ``kernel`` ``[in,
    out]``, ``bias``, numpy leaves: copied as they lie)."""
    if isinstance(source, torch.nn.Module):
        fc1, fc2 = (getattr(source, n) for n in source.names)
        return (fc1.weight.t().contiguous(), fc1.bias,
                fc2.weight.t().contiguous(), fc2.bias)
    return tuple(torch.from_numpy(np.array(source[d][k], copy=True))
                 for d in ("Dense_0", "Dense_1") for k in ("kernel", "bias"))

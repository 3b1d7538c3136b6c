"""Flash attention: the Hopper forward and backward kernels, their plain
versions, and the autograd Function that pairs them (counterpart of
``pose3d_tpu/ops/pallas/flash_attention.py``).

Forward: q ``[B, Tq, H, D]`` and k, v ``[B, Tk, H, D]`` give
``(o [B, Tq, H, D], lse [B, H, Tq] fp32)``:
``o = softmax(QKᵀ/√D) V`` with the softmax in fp32, and
``lse = log Σ_j exp(s_j/√D)`` per query row.
Backward: q, k, v, o, dO and lse give ``(dq, dk, dv)`` in q's dtype, from
``P = exp(s/√D − lse)``, ``δ = rowsum(dO∘O)`` and ``dS = P∘(dO Vᵀ − δ)``.

:func:`flash_attention_fwd` and :func:`flash_attention_bwd` launch
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu`` and
accept only CUDA tensors; :func:`flash_attention_fwd_reference` and
:func:`flash_attention_bwd_reference` are the plain PyTorch versions the
tests and ``chip_smoke.py`` hold them against. :class:`FlashAttention`
runs the kernel pair on CUDA tensors and the plain pair otherwise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pose3d_tpu_torch.ops.kernels import _build

HEAD_DIMS = (32, 48, 64, 128)
_DTYPES = (torch.bfloat16, torch.float32)


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention with the TPU kernel's arithmetic: fp32
    scores, max-subtracted exp with the 1/√D scale folded in, e cast to
    v's dtype for PV, division deferred to the output."""
    D = q.shape[-1]
    scale = 1.0 / D ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp((s - m) * scale)
    denom = e.sum(dim=-1, keepdim=True)                       # [B,H,Tq,1]
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).float(), v.float())
    o = o / denom.permute(0, 2, 1, 3)
    lse = (m * scale + torch.log(denom))[..., 0]
    return o.to(q.dtype), lse


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  do: torch.Tensor, lse: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain PyTorch backward with the TPU kernel's arithmetic: fp32
    scores, P recomputed from lse in one exp, δ = rowsum(dO∘O) in fp32,
    P cast to dO's dtype before dV and dS to q's dtype before dQ and dK,
    fp32 accumulation. Returns (dq, dk, dv) in q's dtype."""
    D = q.shape[-1]
    scale = 1.0 / D ** 0.5
    f = torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f), k.to(f))
    p = torch.exp(s * scale - lse[..., None])                 # [B,H,Tq,Tk]
    delta = (do.to(f) * o.to(f)).sum(-1).transpose(1, 2)      # [B,H,Tq]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(f), do.to(f))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(f), v.to(f))
    ds = (p * (dp - delta[..., None])).to(q.dtype).to(f)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(f)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(f)) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """The kernel reads 16 bytes at a time: the last dim must be
    contiguous and the base and other strides 16-byte aligned. Views that
    are not (none on the model's path) are copied."""
    per16 = 16 // x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s % per16 == 0 for s in x.stride()[:-1]))
    return x if ok else x.contiguous()


def _check(fn: str, q, k, v, **more) -> None:
    """Raise ValueError for anything the kernels do not take. ``more``
    holds the backward's o and do, which must match q."""
    named = {"q": q, "k": k, "v": v, **more}
    for name, x in named.items():
        if x.dim() != 4:
            raise ValueError(f"{fn}: {name} must be "
                             f"[B, T, H, D], got shape {tuple(x.shape)}")
        if x.dtype not in _DTYPES:
            raise ValueError(f"{fn}: {name} is {x.dtype}; "
                             "supported: bfloat16, float32")
    if len({x.dtype for x in named.values()}) != 1:
        raise ValueError(f"{fn}: {', '.join(named)} dtypes differ")
    B, Tq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != H \
            or k.shape[3] != D:
        raise ValueError(
            f"{fn}: need k, v [B, Tk, H, D] matching q "
            f"{tuple(q.shape)}; got k {tuple(k.shape)}, v {tuple(v.shape)} "
            "(a value depth other than D is not supported)"
        )
    for name, x in more.items():
        if x.shape != q.shape:
            raise ValueError(f"{fn}: {name} must have q's shape "
                             f"{tuple(q.shape)}, got {tuple(x.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {D} not in {HEAD_DIMS}")
    if Tq == 0 or k.shape[1] == 0:
        raise ValueError(f"{fn}: empty query or key sequence")
    if B > 65535 or H > 65535:
        raise ValueError(f"{fn}: B and H must be <= 65535 "
                         "(grid dimensions)")
    devices = {x.device for x in named.values()}
    if not (q.is_cuda and len(devices) == 1):
        raise ValueError(
            f"{fn}: {', '.join(named)} are on "
            f"{', '.join(str(x.device) for x in named.values())}; "
            "the kernel takes CUDA tensors on one device only")


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature of each library's entry point (see the extern "C" blocks)
_ARGTYPES = {
    "flash_attention_fwd": [_P] * 5 + [_I] * 6 + [ctypes.c_float]
    + [_LL] * 9 + [_P],
    "flash_attention_bwd": [_P] * 11 + [_I] * 6 + [ctypes.c_float]
    + [_LL] * 15 + [_P],
}


def load_library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``'s library, with its
    entry point's C signature declared; idempotent."""
    return _build.load_library(name, _ARGTYPES[name])


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on PyTorch's current stream. Raises on
    anything it does not take (non-CUDA tensors, other dtypes or head
    dims, an empty key sequence) and when the launch is refused; it never
    falls back to the plain version.

    The output carries no autograd graph, so with grad mode on it raises
    for inputs that require grad: differentiate through
    :class:`FlashAttention` (``ops.attention.dot_product_attention``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_fwd: inputs require grad, and the raw kernel "
            "would drop their gradients; call FlashAttention.apply or "
            "ops.attention.dot_product_attention instead")
    _check("flash_attention_fwd", q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    lib = load_library("flash_attention_fwd")
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pose3d_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), int(q.dtype == torch.bfloat16), B, Tq, Tk, H, D,
            1.0 / D ** 0.5,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            stream,
        )
    _build.raise_if_failed(lib, "flash_attention_fwd", rc)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the Hopper backward (prologue, main kernel and, for bf16,
    the dQ cast) on PyTorch's current stream; returns contiguous
    ``(dq, dk, dv)`` in q's dtype. ``do`` may be any strided view (it is
    copied when the kernel cannot read it in place). Raises like
    :func:`flash_attention_fwd`; never falls back to the plain version."""
    _check("flash_attention_bwd", q, k, v, o=o, do=do)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if (lse.shape != (B, H, Tq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(
            f"flash_attention_bwd: lse must be float32 {(B, H, Tq)} on "
            f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    q, k, v, o, do = (_aligned(x) for x in (q, k, v, o, do))
    lse = lse.contiguous()
    lib = load_library("flash_attention_bwd")
    dev = q.device
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Tk, H, D), dtype=q.dtype, device=dev)
    dv = torch.empty((B, Tk, H, D), dtype=q.dtype, device=dev)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=dev)
    is_bf16 = q.dtype == torch.bfloat16
    dq_acc = (torch.empty((B, Tq, H, D), dtype=torch.float32, device=dev)
              if is_bf16 else dq)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pose3d_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            int(is_bf16), B, Tq, Tk, H, D, 1.0 / D ** 0.5,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], *do.stride()[:3],
            stream,
        )
    _build.raise_if_failed(lib, "flash_attention_bwd", rc)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable attention: ``FlashAttention.apply(q, k, v,
    use_kernel)`` → o ``[B, Tq, H, D]``. The forward saves q, k, v, o and
    the fp32 lse; the backward recomputes P from lse. ``use_kernel`` picks
    the Hopper kernel pair (CUDA tensors only), otherwise the plain
    pair runs."""

    @staticmethod
    def forward(ctx, q, k, v, use_kernel: bool):
        fwd = flash_attention_fwd if use_kernel else \
            flash_attention_fwd_reference
        o, lse = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.use_kernel = use_kernel
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        bwd = flash_attention_bwd if ctx.use_kernel else \
            flash_attention_bwd_reference
        return (*bwd(*ctx.saved_tensors[:4], do, ctx.saved_tensors[4]),
                None)

"""Flash-attention forward: the Hopper kernel and its plain version
(counterpart of ``pose3d_tpu/ops/pallas/flash_attention.py``, forward only).

Both take q ``[B, Tq, H, D]`` and k, v ``[B, Tk, H, D]`` and return
``(o [B, Tq, H, D], lse [B, H, Tq] fp32)``:
``o = softmax(QKᵀ/√D) V`` with the softmax in fp32, and
``lse = log Σ_j exp(s_j/√D)`` per query row.

:func:`flash_attention_fwd` launches ``csrc/flash_attention_fwd.cu`` and
accepts only CUDA tensors; :func:`flash_attention_fwd_reference` is the
plain PyTorch version the tests and ``chip_smoke.py`` hold it against.
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


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """The kernel reads 16 bytes at a time: the last dim must be
    contiguous and the base and other strides 16-byte aligned. Views that
    are not (none on the model's path) are copied."""
    per16 = 16 // x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s % per16 == 0 for s in x.stride()[:-1]))
    return x if ok else x.contiguous()


def _check(q, k, v) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4:
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             f"[B, T, H, D], got shape {tuple(x.shape)}")
        if x.dtype not in _DTYPES:
            raise ValueError(f"flash_attention_fwd: {name} is {x.dtype}; "
                             "supported: bfloat16, float32")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention_fwd: q, k, v dtypes differ")
    B, Tq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != H \
            or k.shape[3] != D:
        raise ValueError(
            "flash_attention_fwd: need k, v [B, Tk, H, D] matching q "
            f"{tuple(q.shape)}; got k {tuple(k.shape)}, v {tuple(v.shape)} "
            "(a value depth other than D is not supported)"
        )
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if Tq == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention_fwd: empty query or key sequence")
    if B > 65535 or H > 65535:
        raise ValueError("flash_attention_fwd: B and H must be <= 65535 "
                         "(grid dimensions)")
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError(
            f"flash_attention_fwd: q, k, v are on {q.device}, {k.device}, "
            f"{v.device}; the kernel takes CUDA tensors on one device only")


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library; idempotent."""
    lib = _build.load("flash_attention_fwd")
    fn = lib.pose3d_flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float,
                       ll, ll, ll, ll, ll, ll, ll, ll, ll, p]
        fn.restype = ctypes.c_int
        lib.pose3d_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pose3d_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on PyTorch's current stream. Raises on
    anything it does not take (non-CUDA tensors, other dtypes or head
    dims, an empty key sequence) and when the launch is refused; it never
    falls back to the plain version."""
    _check(q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    lib = load_library()
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
    if rc != 0:
        msg = lib.pose3d_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {msg} ({rc})")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0

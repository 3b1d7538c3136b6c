"""Pose metrics: MPJPE and batched PA-MPJPE (counterpart of
``pose3d_tpu/geometry/metrics.py``).

Procrustes conventions as the JAX module: covariance M = Pcᵀ Gc with
SVD M = U diag(S) Vᵀ; the smallest singular vector flipped (and its
singular value negated in the scale) when det(U)·det(Vᵀ) < 0; scale
s = Σ S_eff / ‖Pc‖² with s = 1 when ‖Pc‖² ≤ 1e-9; aligned = s·Pc·R + μ_gt.
The default rotation is the Procrustes optimum for row vectors, R = U Z Vᵀ;
``compat_transposed_rotation=True`` gives the reference project's
transposed R = V Z Uᵀ.

Everything is fp32, and the small products are broadcast multiply-and-sum
rather than matmuls, so no TF32 setting on the card can round them.
"""

from __future__ import annotations

import torch


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b as multiply-and-sum: exact fp32 whatever the TF32
    flags."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _check(pred, gt):
    pred = torch.as_tensor(pred).float()
    gt = torch.as_tensor(gt).float()
    if pred.shape != gt.shape:
        raise ValueError(f"Shape mismatch: pred {tuple(pred.shape)}, "
                         f"gt {tuple(gt.shape)}")
    return pred, gt


def mpjpe(pred, gt) -> torch.Tensor:
    """Mean per-joint L2 error over all leading axes and joints of
    [..., J, 3] inputs (scalar)."""
    pred, gt = _check(pred, gt)
    return torch.linalg.vector_norm(pred - gt, dim=-1).mean()


def procrustes_align(pred: torch.Tensor, gt: torch.Tensor,
                     compat_transposed_rotation: bool = False
                     ) -> torch.Tensor:
    """Similarity-align each ``pred`` [B, J, 3] onto ``gt`` (fp32)."""
    pred, gt = _check(pred, gt)
    mu_p = pred.mean(1, keepdim=True)
    mu_g = gt.mean(1, keepdim=True)
    pc = pred - mu_p
    gc = gt - mu_g
    M = _mm(pc.transpose(1, 2), gc)                              # [B, 3, 3]
    U, S, Vt = torch.linalg.svd(M)
    sign = torch.where(torch.linalg.det(U) * torch.linalg.det(Vt) < 0,
                       -1.0, 1.0)                                # [B]
    flip = torch.ones_like(S)
    flip[:, -1] = sign
    s_eff = S * flip
    if compat_transposed_rotation:
        R = _mm((Vt * flip[:, :, None]).transpose(1, 2), U.transpose(1, 2))
    else:
        R = _mm(U * flip[:, None, :], Vt)
    var_p = (pc * pc).sum((1, 2))
    scale = torch.where(var_p > 1e-9, s_eff.sum(1) / var_p,
                        torch.ones_like(var_p))
    return scale[:, None, None] * _mm(pc, R) + mu_g


def pa_mpjpe(pred, gt, compat_transposed_rotation: bool = False
             ) -> torch.Tensor:
    """Procrustes-aligned MPJPE: batch mean of each sample's mean joint
    error after similarity alignment (scalar)."""
    pred, gt = _check(pred, gt)
    aligned = procrustes_align(pred, gt, compat_transposed_rotation)
    return torch.linalg.vector_norm(aligned - gt, dim=-1).mean(-1).mean()

"""Gaussian heatmaps from 2D keypoints (counterpart of
``pose3d_tpu/ops/heatmap.py``).

For joint j at normalised (x, y): exp(-((X-μx)² + (Y-μy)²) / 2σ²) on an
S×S grid, μ = kpt·(S-1), zeroed when any coordinate is <= 0. The Gaussian
is separable, so it is built as an outer product of two [B, J, S] factors.
"""

from __future__ import annotations

import torch


def gaussian_heatmaps(keypoints_2d: torch.Tensor, heatmap_size: int,
                      sigma: float, dtype=torch.float32) -> torch.Tensor:
    """Render per-joint heatmaps.

    Args:
      keypoints_2d: [B, J, 2] normalised (x, y).
      heatmap_size: output spatial size S.
      sigma: std-dev in heatmap pixels.
      dtype: output dtype.

    Returns:
      [B, S, S, J] (NHWC, as the JAX function).
    """
    kpts = keypoints_2d.to(torch.float32)
    S = heatmap_size
    mu = kpts * (S - 1)                                          # [B, J, 2]
    coords = torch.arange(S, dtype=torch.float32, device=kpts.device)
    inv = 1.0 / (2.0 * sigma * sigma)
    dx = coords[None, None, :] - mu[..., 0:1]                    # [B, J, S]
    dy = coords[None, None, :] - mu[..., 1:2]
    gx = torch.exp(-(dx * dx) * inv)
    gy = torch.exp(-(dy * dy) * inv)
    valid = (kpts > 0).all(dim=-1)                               # [B, J]
    gx = gx * valid[..., None]
    return torch.einsum("bjh,bjw->bhwj", gy, gx).to(dtype)

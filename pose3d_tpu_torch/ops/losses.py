"""Composite pose loss (counterpart of ``pose3d_tpu/ops/losses.py``).

total = w_mse·MSE + w_l1·L1 + w_ij·inter-joint + w_root·abs-root, in fp32
(or in the prediction's dtype where that is wider), with a components dict
for logging. The inter-joint term compares all
J·(J−1)/2 unique pairwise joint distances as a masked mean over the dense
[B, J, J] distance matrices (strict upper triangle), with 1e-12 inside the
square root, as the JAX function does.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch


class LossWeights(NamedTuple):
    """Loss weights (the JAX package's defaults)."""

    mse: float = 1.0
    l1: float = 1.0
    inter_joint: float = 100.0
    abs_root: float = 1.0


def _pairwise_distances(joints: torch.Tensor) -> torch.Tensor:
    """[B, J, 3] → [B, J, J] Euclidean distance matrix."""
    diff = joints[:, :, None, :] - joints[:, None, :, :]
    return torch.sqrt((diff * diff).sum(-1) + 1e-12)


def inter_joint_distance_per_sample(pred: torch.Tensor,
                                    gt: torch.Tensor) -> torch.Tensor:
    """Per-sample mean |pairwise-dist(pred) − pairwise-dist(gt)| over the
    unique joint pairs: [B]."""
    J = pred.shape[-2]
    err = (_pairwise_distances(pred) - _pairwise_distances(gt)).abs()
    mask = torch.ones(J, J, dtype=err.dtype, device=err.device).triu(1)
    return (err * mask).sum((1, 2)) / mask.sum()


def composite_pose_loss_per_sample(
    pred: torch.Tensor, gt: torch.Tensor,
    weights: LossWeights = LossWeights(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Every component as a [B] fp32 (or wider) vector (sample-weighted
    validation averages over a ragged last batch): batch means of these
    equal the scalar loss."""
    acc = torch.promote_types(pred.dtype, torch.float32)
    pred = pred.to(acc)
    gt = gt.to(acc)
    diff = pred - gt
    mse = (diff * diff).mean((1, 2))
    l1 = diff.abs().mean((1, 2))
    ij = inter_joint_distance_per_sample(pred, gt)
    root = (pred[:, 0, :] - gt[:, 0, :]).abs().mean(1)
    total = (weights.mse * mse + weights.l1 * l1
             + weights.inter_joint * ij + weights.abs_root * root)
    return total, {
        "mse_loss": mse,
        "l1_loss": l1,
        "inter_joint_loss": ij,
        "abs_root_loss": root,
        "total_loss": total,
    }


def composite_pose_loss(
    pred: torch.Tensor, gt: torch.Tensor,
    weights: LossWeights = LossWeights(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(scalar total loss, {"mse_loss", "l1_loss", "inter_joint_loss",
    "abs_root_loss", "total_loss"} batch means) for [B, J, 3] pred/gt."""
    total, comps = composite_pose_loss_per_sample(pred, gt, weights)
    return total.mean(), {k: v.mean() for k, v in comps.items()}

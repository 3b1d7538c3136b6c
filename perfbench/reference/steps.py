"""The reference's runs: the first optimizer steps of a training cell, in
plain fp32 (TF32 off) from the benchmark's own weights and inputs.

A training step follows the published trainer: A microbatches of B
samples, each a forward with its own BatchNorm statistics and the running
averages moved after it, the mean loss's gradients summed and divided by
A, then AdamW and the EMA of the parameters and of the running
statistics. The dropout masks are drawn again from the run's seed
(:class:`MaskReplay`). The uint8 pixels and per-sample depth range the
benchmark made are decoded here."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from perfbench.reference.cnn import CNN, momentum_update
from perfbench.reference.common import (
    AdamW,
    MaskReplay,
    Precision,
    pose_loss,
)
from perfbench.reference.vit import ViT

STAT_SUFFIXES = (".running_mean", ".running_var")


def set_plain_fp32() -> None:
    """fp32 products in fp32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def decode(batch: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    """uint8 image → [0, 1]; uint8 depth with its [B, 2] (min, max) →
    metric depth, both worked out in fp32 as the data's own type; then
    everything in ``dtype``."""
    f = torch.float32
    s = batch["depth_scale"].to(f)
    lo, hi = s[:, 0, None, None, None], s[:, 1, None, None, None]
    out = {
        "image": batch["image"].to(f) / 255.0,
        "depth": batch["depth"].to(f) / 255.0 * (hi - lo) + lo,
        "keypoints_2d": batch["keypoints_2d"],
        "joints_3d": batch["joints_3d"],
    }
    return {k: v.to(dtype) for k, v in out.items()}


def make_model(cfg: dict, sd, prec: Precision, train: bool, dropout):
    if cfg["model_type"] == "cnn":
        return CNN(cfg, sd, prec, train, dropout)
    return ViT(cfg, sd, prec, dropout)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double()))
            for n, t in tensors.items()}


def train_steps(cfg: dict, weights: Dict[str, torch.Tensor],
                superbatches: List[Dict[str, torch.Tensor]], *,
                drop_seed: int, lr: float, weight_decay: float,
                ema_decay: Optional[float], precision: str = "fp32",
                dtype=torch.float32, mask_dtype=torch.bfloat16,
                fault: Optional[str] = None) -> dict:
    """Run ``len(superbatches)`` optimizer steps from ``weights`` (each
    superbatch ``[A, B, ...]``) and return what the check compares: each
    step's mean loss, the first step's loss components and running
    statistics, every parameter's first gradient, and each
    parameter's and EMA's change over the steps (tensors), and the norm of
    each running statistic's change.

    ``fault="half_batch"`` plants a fault in the reference's place: each
    microbatch's second half left out, the mean taken over the rest."""
    prec = Precision(precision)
    params = {n: w.detach().to(dtype).clone().requires_grad_(True)
              for n, w in weights.items()
              if w.is_floating_point() and not n.endswith(STAT_SUFFIXES)
              and not n.endswith(("x_grid", "y_grid"))}
    running = {n: w.detach().to(dtype).clone() for n, w in weights.items()
               if n.endswith(STAT_SUFFIXES)}
    start = {n: p.detach().clone() for n, p in params.items()}
    start_stats = {n: r.clone() for n, r in running.items()}
    opt = AdamW(params, lr, weight_decay, ema_decay)
    opt.ema = {n: t.clone() for n, t in {**start, **start_stats}.items()}
    losses, parts1, grad1, stats1 = [], None, None, None
    for step, sb in enumerate(superbatches):
        A, B = sb["image"].shape[:2]
        device = sb["image"].device
        masks = MaskReplay(drop_seed, step, A * B, device, mask_dtype)
        sd = {**params, **running}
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        total, parts = 0.0, {}
        for a in range(A):
            mb = decode({k: v[a] for k, v in sb.items()}, dtype)
            rows = B // 2 if fault == "half_batch" else B
            mb = {k: v[:rows] for k, v in mb.items()}
            masks.microbatch(a * B)
            model = make_model(cfg, sd, prec, True, masks)
            out = model.forward(mb["image"], mb["depth"], mb["keypoints_2d"])
            loss, comps = pose_loss(out, mb["joints_3d"])
            g = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
            for n, gi in zip(params, g):
                if gi is not None:
                    grads[n] += gi
            total += float(loss.detach())
            for k, v in comps.items():
                parts[k] = parts.get(k, 0.0) + float(v.detach()) / A
            if cfg["model_type"] == "cnn":
                momentum_update(running, model.norm.stats)
            del out, loss, g, model
        for gi in grads.values():
            gi /= A
        losses.append(total / A)
        parts1 = parts1 or parts
        if grad1 is None:
            grad1 = {n: g.clone() for n, g in grads.items()}
            stats1 = {n: r.clone() for n, r in running.items()}
        opt.step(params, grads, running)
        del grads
    return {
        "losses": losses,
        "parts1": parts1,
        "grad1": grad1,
        "change": {n: p.detach() - start[n] for n, p in params.items()},
        "ema_change": {n: opt.ema[n] - start[n] for n in params},
        "stats_change": _norms({n: r - start_stats[n]
                                for n, r in running.items()}),
        "stats1": stats1,
        "stats_start": start_stats,
    }

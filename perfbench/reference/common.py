"""Plain fp32 pieces shared by the two lifters' references: the operand
precision of every product, the replay of the dropout masks from the run's
seed, the heatmaps, the losses and the optimizer.

Nothing here imports the program under test. Every function takes plain
tensors and a flat ``{name: tensor}`` dict of weights under the reference
checkpoint's names (the public ``.pth`` schema both lifters load)."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

_MASK64 = (1 << 64) - 1
FP8_MAX = 448.0          # largest finite float8_e4m3fn


def step_seed(seed: int, step: int) -> int:
    """The seed a training run seeded ``seed`` gives its dropout generator
    before optimizer step ``step`` (splitmix64 of the pair)."""
    x = (seed * 0x9E3779B97F4A7C15 + step + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


class Precision:
    """The operand precision of every matrix product and convolution.

    ``"fp32"``: the operands as they are (the reference). ``"fp8"``: each
    operand rounded to float8 e4m3 under a per-tensor scale (amax / 448),
    the step below bf16 that the control takes; gradients pass the
    rounding unchanged."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return x
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = amax / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x + (q - x.detach()) if x.requires_grad else q


class MaskReplay:
    """The dropout masks of one step, drawn as the trained program draws
    them: from a generator seeded with :func:`step_seed`, in forward order,
    one mask for the whole flat batch of each dropout, each element kept
    with probability 1 − rate in ``mask_dtype`` (the program's compute
    dtype). The reference runs one microbatch at a time and takes its rows
    of each mask: the first microbatch's forward draws them, the others
    read them back by position."""

    def __init__(self, seed: int, step: int, rows: int, device,
                 mask_dtype=torch.bfloat16):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(step_seed(seed, step))
        self.rows = rows
        self.mask_dtype = mask_dtype
        self.masks: List[torch.Tensor] = []
        self.cursor = 0
        self.lo = 0

    def microbatch(self, lo: int) -> None:
        """Start the forward of the microbatch whose first row is ``lo``."""
        self.cursor = 0
        self.lo = lo

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate == 0.0:
            return x
        if self.cursor == len(self.masks):
            keep = torch.empty((self.rows, *x.shape[1:]),
                               dtype=self.mask_dtype, device=x.device)
            keep.bernoulli_(1.0 - rate, generator=self.gen)
            self.masks.append(keep.bool())
        keep = self.masks[self.cursor][self.lo:self.lo + x.shape[0]]
        self.cursor += 1
        return x * keep.to(x.dtype) * (1.0 / (1.0 - rate))


def no_dropout(x: torch.Tensor, rate: float) -> torch.Tensor:
    return x


def activation(name: str):
    return {"silu": F.silu, "gelu": F.gelu, "relu": F.relu}[name]


def linear(x, w, b, prec: Precision):
    return F.linear(prec(x), prec(w), b)


def layer_norm(x, sd: Dict[str, torch.Tensor], prefix: str,
               eps: float = 1e-6):
    return F.layer_norm(x, x.shape[-1:], sd[prefix + "weight"],
                        sd[prefix + "bias"], eps)


def attention(q, k, v, prec: Precision):
    """softmax(q·kᵀ/√D)·v over [B, T, H, D] tensors, fp32 softmax."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    s = torch.matmul(prec(q), prec(k).transpose(-1, -2)) / math.sqrt(
        q.shape[-1])
    p = torch.softmax(s, dim=-1)
    return torch.matmul(prec(p), prec(v)).transpose(1, 2)


def heatmaps(kpts: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """[B, J, 2] normalised (x, y) → [B, J, S, S] Gaussians centred at
    kpt·(S − 1), zero for a joint with a coordinate <= 0; worked out in
    fp32, the keypoints' own type, and returned in the keypoints' dtype."""
    dtype = kpts.dtype
    kpts = kpts.float()
    c = torch.arange(size, dtype=kpts.dtype, device=kpts.device)
    mu = kpts * (size - 1)
    gx = torch.exp(-(c - mu[..., 0:1]) ** 2 / (2 * sigma ** 2))
    gy = torch.exp(-(c - mu[..., 1:2]) ** 2 / (2 * sigma ** 2))
    valid = (kpts > 0).all(-1).to(kpts.dtype)[..., None, None]
    return (gy[..., :, None] * gx[..., None, :] * valid).to(dtype)


def pose_loss(pred: torch.Tensor, gt: torch.Tensor):
    """(batch mean of MSE + L1 + 100·inter-joint + abs-root, the four
    components' batch means): the published trainer's loss."""
    diff = pred - gt
    mse = (diff ** 2).mean((1, 2))
    l1 = diff.abs().mean((1, 2))
    J = pred.shape[1]
    iu = torch.triu_indices(J, J, 1, device=pred.device)

    def dist(j):
        d = j[:, :, None, :] - j[:, None, :, :]
        return torch.sqrt((d ** 2).sum(-1) + 1e-12)[:, iu[0], iu[1]]
    ij = (dist(pred) - dist(gt)).abs().mean(1)
    root = (pred[:, 0] - gt[:, 0]).abs().mean(1)
    parts = {"mse_loss": mse.mean(), "l1_loss": l1.mean(),
             "inter_joint_loss": ij.mean(), "abs_root_loss": root.mean()}
    return (mse + l1 + 100.0 * ij + root).mean(), parts


class AdamW:
    """Decoupled AdamW (b1 0.9, b2 0.999, eps 1e-8 on √v̂) over a dict of
    leaves, with the parameters' EMA (decay ramp min(d, (1 + t)/(10 + t)))
    of the leaves and of ``extra`` tensors (running statistics)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float, ema_decay: Optional[float]):
        self.lr, self.wd, self.ema_decay = lr, weight_decay, ema_decay
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0
        self.ema: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor],
             extra: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2, t = 0.9, 0.999, self.t
        for n, p in params.items():
            g = grads[n]
            p.mul_(1.0 - self.lr * self.wd)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[n].sqrt() / math.sqrt(1 - b2 ** t) + 1e-8
            p.addcdiv_(self.m[n], denom, value=-self.lr / (1 - b1 ** t))
        if self.ema_decay is None:
            return
        d = min(self.ema_decay, (1.0 + t) / (10.0 + t))
        for n, x in {**params, **extra}.items():
            if n not in self.ema:
                raise KeyError(f"EMA has no start value for {n}")
            self.ema[n].mul_(d).add_(x, alpha=1 - d)

"""What a run is fed, made from its seed: the weights and the training
superbatches. Both sides, the program and the
reference, get the same tensors.

Weights come from one draw on the device (one normal sample for every
float leaf, then each leaf scaled and shifted in two fused calls): LeCun
normal (variance 1/fan-in) for every kernel, N(0, 0.02) for the class
tokens and positions, unit norm scales, zero biases, running mean 0 and
variance 1, the pyramid's branch weights 1/n. Inputs come from a few
large draws on the device: uint8 pixels and depth with a per-sample depth
range of 1–8 m, keypoints in (0.05, 0.95) and joints N(0, 0.3²), a
body's spread in metres, so that the loss turns on the prediction."""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference.common import step_seed

TOKENS = ("cls_token", "pos_embed", "pos_embed_hm", "final_cls_token",
          "final_pos_embed")

# sub-streams of a run's seed
WEIGHTS, TRAIN_DATA, DROPOUT = 0, 1, 4


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each use of the run's seed (any whole number,
    negative and past 64 bits included)."""
    return step_seed(seed & ((1 << 64) - 1), stream) & ((1 << 63) - 1)


def _rule(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    """(mean, std) of a float leaf."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return 1.0, 0.0
    if leaf in ("running_mean", "x_grid", "y_grid"):
        return 0.0, 0.0
    if name.endswith("wasp.weights"):
        return 1.0 / shape[0], 0.0
    if leaf in TOKENS:
        return 0.0, 0.02
    if len(shape) == 1:
        return (1.0 if leaf == "weight" else 0.0), 0.0
    fan_in = math.prod(shape[1:])
    return 0.0, 1.0 / math.sqrt(fan_in)


def make_weights(spec: List[Tuple[str, Sequence[int], torch.dtype]],
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """A ``{name: tensor}`` of every leaf in ``spec`` (name, shape, dtype),
    float leaves in fp32 as views of one buffer."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, WEIGHTS))
    floats = [(n, tuple(s)) for n, s, dt in spec if dt.is_floating_point]
    total = sum(math.prod(s) for _, s in floats)
    flat = torch.randn(total, generator=gen, device=device)
    out, views, means, stds, off = {}, [], [], [], 0
    for n, s in floats:
        k = math.prod(s)
        v = flat[off:off + k].view(s)
        off += k
        mean, std = _rule(n, s)
        out[n] = v
        views.append(v)
        means.append(mean)
        stds.append(std)
    torch._foreach_mul_(views, stds)
    torch._foreach_add_(views, means)
    for n, s, dt in spec:
        if not dt.is_floating_point:
            out[n] = torch.zeros(s, dtype=dt, device=device)
    return out


def train_pool(cfg: dict, superbatches: int, accum: int, batch: int,
               seed: int, device) -> Dict[str, np.ndarray]:
    """``superbatches`` × accum × batch distinct samples as the loader
    hands them to the trainer: uint8 image and depth with the depth's
    per-sample (min, max), float keypoints and joints; host arrays."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, TRAIN_DATA))
    n = superbatches * accum * batch
    h, w = cfg["model_args"]["image_size"]
    j = cfg["model_args"]["num_joints"]
    lo = 1.0 + 2.0 * torch.rand(n, generator=gen, device=device)
    hi = lo + 1.0 + 4.0 * torch.rand(n, generator=gen, device=device)
    out = {
        "image": torch.randint(0, 256, (n, h, w, 3), generator=gen,
                               device=device, dtype=torch.uint8),
        "depth": torch.randint(0, 256, (n, h, w, 1), generator=gen,
                               device=device, dtype=torch.uint8),
        "depth_scale": torch.stack([lo, hi], 1),
        "keypoints_2d": 0.05 + 0.9 * torch.rand(n, j, 2, generator=gen,
                                                device=device),
        "joints_3d": 0.3 * torch.randn(n, j, 3, generator=gen,
                                       device=device),
    }
    return {k: v.cpu().numpy() for k, v in out.items()}


def superbatch(pool: Dict[str, np.ndarray], index: int, accum: int,
               batch: int, device) -> Dict[str, torch.Tensor]:
    """Superbatch ``index`` of the pool as [A, B, ...] tensors."""
    n = accum * batch
    return {k: torch.from_numpy(v[index * n:(index + 1) * n]).to(device)
            .view(accum, batch, *v.shape[1:]) for k, v in pool.items()}


class PoolLoader:
    """The trainer's loader: batches of ``batch`` rows of the pool, from
    superbatch ``start`` on, around the pool for ever."""

    def __init__(self, pool: Dict[str, np.ndarray], batch: int, accum: int,
                 start: int):
        self.pool, self.batch = pool, batch
        self.rows = next(iter(pool.values())).shape[0]
        self.first = (start * accum * batch) % self.rows

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        lo = self.first
        while True:
            yield {k: v[lo:lo + self.batch] for k, v in self.pool.items()}
            lo = (lo + self.batch) % self.rows

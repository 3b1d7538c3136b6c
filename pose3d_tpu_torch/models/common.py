"""Shared model components (counterpart of ``pose3d_tpu/models/common.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from pose3d_tpu_torch.ops.activations import get_activation


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype``: input, weight and bias are cast at
    use (fp32 master weights), as a flax ``Dense(dtype=...)`` does."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: each element kept with
    probability 1 − rate (mask drawn from ``gen`` in x's dtype) and scaled
    by 1/(1 − rate). Identity when ``gen`` is None (eval mode) or rate
    is 0."""
    if gen is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=gen)
    return x * keep * (1.0 / (1.0 - rate))


class PoseRegressionHead(nn.Module):
    """MLP head: per hidden dim Linear → activation → dropout (rate
    ``dropout``), then a final Linear to ``num_joints·3`` reshaped to
    [B, J, 3].

    The Linears sit at the reference Sequentials' indices. Flat (the
    transformer's head): ``decoder.{0, 3, 6, ...}`` (Linear, activation,
    Dropout per hidden layer; the two weightless entries are not
    registered). ``nested`` (the CNN's head): hidden layer k is its own
    Sequential, ``decoder.{k}.0``, and the final Linear ``decoder.{n}``.
    Hidden Linears run in the compute dtype; the final Linear runs in fp32.
    """

    def __init__(self, in_dim: int, num_joints: int,
                 hidden_dims: Sequence[int], activation: str = "gelu",
                 *, dropout: float = 0.0, nested: bool = False, device=None):
        super().__init__()
        self.num_joints = num_joints
        self.rate = dropout
        self.act = get_activation(activation)
        dims = (in_dim, *hidden_dims, num_joints * 3)
        last = len(dims) - 2
        self.linears = [nn.Linear(dims[i], dims[i + 1], device=device)
                        for i in range(last + 1)]
        if nested:
            self.decoder = nn.ModuleDict(
                (str(i), lin if i == last else nn.ModuleDict({"0": lin}))
                for i, lin in enumerate(self.linears))
        else:
            self.decoder = nn.ModuleDict(
                (str(3 * i), lin) for i, lin in enumerate(self.linears))

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        *hidden, last = self.linears
        for layer in hidden:
            x = dropout(self.act(linear(x, layer, dtype)), self.rate, gen)
        x = linear(x, last, torch.promote_types(dtype, torch.float32))
        return x.reshape(-1, self.num_joints, 3)

"""Activation factory (counterpart of ``pose3d_tpu/ops/activations.py``)."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def _mish(x):
    return x * torch.tanh(F.softplus(x))


_ACTIVATIONS = {
    "relu": F.relu,
    "silu": F.silu,
    "gelu": F.gelu,  # exact (erf) GELU, as the JAX package's "gelu"
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.2),
    "mish": _mish,
}


def get_activation(name: str) -> Callable:
    """Look up an activation by name; unknown names fall back to relu, as
    the JAX package's factory does."""
    return _ACTIVATIONS.get(name, F.relu)

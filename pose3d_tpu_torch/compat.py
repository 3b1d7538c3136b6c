"""Weights carried across from the JAX package.

The reference-schema state_dict that the port's
:mod:`pose3d_tpu_torch.compat_export` builds from the JAX package's
variables (numpy leaves; the same state_dict ``pose3d-convert --to-torch``
writes into a ``.pth``) strict-loads into the port's models: parameters
and, for the CNN, the BatchNorm running statistics.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from pose3d_tpu_torch.compat_export import (
    export_reference_cnn,
    export_reference_transformer,
)


def state_dict_from_jax(variables: Dict, cfg) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``variables`` (``{"params": ..., "batch_stats": ...}``, numpy
    leaves) → an ordered torch state_dict in the reference's key order.
    ``cfg`` may be either package's config (only field names are read). The
    CNN is taken with every ``normalization`` the port builds."""
    model_type = getattr(cfg, "model_type", "transformer")
    if model_type == "cnn":
        writer = export_reference_cnn(variables, cfg)
    elif model_type == "transformer":
        writer = export_reference_transformer(variables, cfg)
    else:
        raise ValueError(f"unsupported model_type {model_type!r}")
    return OrderedDict(
        (k, torch.from_numpy(np.array(v))) for k, v in writer.sd.items()
    )

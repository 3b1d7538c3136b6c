"""Weights carried across from the JAX package.

The reference-schema state_dict that
``pose3d_tpu.compat_export.export_reference_transformer`` builds from the
JAX package's variables (numpy-only; the same state_dict
``pose3d-convert --to-torch`` writes into a ``.pth``) strict-loads into
:class:`pose3d_tpu_torch.models.TransformerPoseEstimation`.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from pose3d_tpu.compat_export import export_reference_transformer


def state_dict_from_jax(variables: Dict, cfg) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``variables`` (``{"params": ...}``, numpy leaves) → an ordered
    torch state_dict in the reference's key order. ``cfg`` may be either
    package's config (only field names are read)."""
    if getattr(cfg, "model_type", "transformer") != "transformer":
        raise NotImplementedError(
            "only the transformer lifter is ported; the CNN bridge "
            "(export_reference_cnn) comes with the CNN port"
        )
    writer = export_reference_transformer(variables, cfg)
    return OrderedDict(
        (k, torch.from_numpy(np.array(v))) for k, v in writer.sd.items()
    )

"""Weights carried across from the JAX package.

The reference-schema state_dict that the port's
:mod:`pose3d_tpu_torch.compat_export` builds from the JAX package's
variables (numpy leaves; the same state_dict ``pose3d-convert --to-torch``
writes into a ``.pth``) strict-loads into the port's models: parameters
and, for the CNN, the BatchNorm running statistics. The stage-1 networks'
variables map onto the port's stage-1 modules through
:func:`stage1_state_dict_from_jax`.
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


# --- stage 1 ---------------------------------------------------------------
# The JAX package's stage-1 variables (numpy leaves) → the port's stage-1
# state_dicts: the inverse of its map_yolo_state_dict and
# map_depthpro_state_dict (flax kernels [kh, kw, in, out] → torch
# [out, in, kh, kw], dense kernels transposed, BatchNorm scale → weight and
# mean / var → running statistics), and for the untrained native nets,
# whose port modules carry the flax names, the same leaf rules over the
# flax paths as they stand.

STAGE1_FAMILIES = ("yolo11", "depthpro", "keypoint_net", "depth_net")


def _leaves(tree: Dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _is_deconv(path) -> bool:
    """The transposed-conv sites of DepthPro's flax tree (the JAX
    package's ``depthpro_port._is_deconv``: by path, since a transposed
    kernel with in == out has a plain kernel's shape)."""
    if path[-1] == "deconv":
        return True
    if "feature_upsample" in path:
        blk = path[path.index("feature_upsample") + 1]
        leaf = path[-1]
        if not leaf.startswith("layers_"):
            return False
        j = int(leaf.split("_")[1])
        if blk == "image_block":
            return True
        if blk.startswith("scaled_images") or blk.startswith("intermediate"):
            return j >= 1
    return path[0] == "head" and path[-1] == "layers_1"


def stage1_state_dict_from_jax(variables: Dict, family: str
                               ) -> "OrderedDict[str, torch.Tensor]":
    """A JAX stage-1 network's ``variables`` (``{"params": ...[,
    "batch_stats": ...]}``, numpy leaves) → the port module's state_dict,
    for ``family`` in :data:`STAGE1_FAMILIES`. DepthPro's transposed-conv
    kernels, which the JAX loader flips spatially, are flipped back."""
    from pose3d_tpu_torch.stage1.port import unfold_flax_path

    if family not in STAGE1_FAMILIES:
        raise ValueError(f"family {family!r} not in {STAGE1_FAMILIES}")
    native = family in ("keypoint_net", "depth_net")
    bn = "BatchNorm_0" if native else "bn"

    def key(path, leaf):
        mod = ".".join(path) if native else unfold_flax_path(path)
        return f"{mod}.{leaf}" if mod else leaf

    sd = OrderedDict()
    for path, val in _leaves(variables["params"]):
        mod, leaf = path[:-1], path[-1]
        if leaf == "kernel" and val.ndim == 4:
            if family == "depthpro" and _is_deconv(mod):
                val = np.transpose(val[::-1, ::-1], (2, 3, 0, 1))
            else:
                val = np.transpose(val, (3, 2, 0, 1))
            sd[key(mod, "weight")] = val
        elif leaf == "kernel":
            sd[key(mod, "weight")] = val.T
        elif leaf == "scale":          # BatchNorm and LayerNorm
            sd[key(mod, "weight")] = val
        elif family == "depthpro" and leaf.startswith("layer_scale"):
            sd[key(path, "lambda1")] = val
        else:                          # bias, tokens, depth scale / shift
            sd[key(mod, leaf)] = val
    for path, val in _leaves(variables.get("batch_stats", {})):
        mod, leaf = path[:-1], path[-1]
        if mod[-1] != bn:
            raise ValueError(f"unexpected statistics at {'/'.join(path)}")
        sd[key(mod, {"mean": "running_mean", "var": "running_var"}[leaf])] \
            = val
    return OrderedDict((k, torch.from_numpy(np.array(v))) for k, v in sd.items())

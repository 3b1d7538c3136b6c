"""Transfer encoding of batches (counterpart of ``compact_batch`` in
``pose3d_tpu/data/collate.py``; numpy only)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def compact_batch(batch: Dict) -> Dict:
    """Re-encode a float batch for the host→device copy: image → uint8,
    depth → uint8 plus a per-sample (min, max) ``depth_scale`` [B, 2].
    Batches already in uint8 pass through. The device-side inverse is
    :func:`pose3d_tpu_torch.train.step.decompact_batch`."""
    img = batch["image"]
    depth = batch["depth"]
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if depth.dtype != np.uint8:
        dmin = depth.min(axis=(1, 2, 3))
        dmax = depth.max(axis=(1, 2, 3))
        scale = np.where(dmax > dmin, dmax - dmin, 1.0)
        d01 = (depth - dmin[:, None, None, None]) / scale[:, None, None, None]
        depth = np.clip(d01 * 255.0 + 0.5, 0, 255).astype(np.uint8)
        depth_scale = np.stack([dmin, dmax], axis=1).astype(np.float32)
    else:
        depth_scale = np.asarray(batch["depth_scale"], np.float32)
    out = dict(batch)
    out["image"] = img
    out["depth"] = depth
    out["depth_scale"] = depth_scale
    return out

"""Fixed-shape batching and the transfer encoding of batches (counterpart
of ``pose3d_tpu/data/collate.py``; numpy only).

Batches are padded to a static target size: samples already at the model
input size are stacked as they are; samples of other sizes are zero-padded
bottom/right or top-left-cropped, keeping the origin where augmented
keypoints land.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _pad_or_crop(arr: np.ndarray, target_hw: Tuple[int, int]) -> np.ndarray:
    """Zero-pad bottom/right or crop top-left to the static target size."""
    th, tw = target_hw
    h, w = arr.shape[:2]
    if h > th:
        arr = arr[:th]
        h = th
    if w > tw:
        arr = arr[:, :tw]
        w = tw
    if h < th or w < tw:
        pad = [(0, th - h), (0, tw - w)] + [(0, 0)] * (arr.ndim - 2)
        arr = np.pad(arr, pad)
    return arr


def sample_pixels_to_float(sample: Dict) -> Dict:
    """Promote a uint8-pixel sample (``decode_chunk_samples(...,
    pixel_dtype="uint8")``) to the float convention: image → [0, 1] f32,
    depth → metric f32 through the record's stored depth_min/depth_max.
    Float samples pass through."""
    out = dict(sample)
    img = np.asarray(sample["image"])
    if img.dtype == np.uint8:
        out["image"] = img.astype(np.float32) / 255.0
    depth = np.asarray(sample["depth"])
    if depth.dtype == np.uint8:
        dmin = float(sample.get("depth_min", 0.0))
        dmax = float(sample.get("depth_max", 1.0))
        out["depth"] = (
            depth.astype(np.float32) / 255.0 * (dmax - dmin) + dmin
        )
    return out


def collate_fixed(
    batch: List[Dict], image_size: Optional[Tuple[int, int]] = None
) -> Dict:
    """Collate decoded samples into fixed-shape numpy batch arrays: stacked
    image/depth/keypoints_2d/joints_3d/image_size, the passthrough lists
    (camera_params, image_path, action, subaction, frame_idx) and the
    padding.

    uint8 samples stay uint8 and the batch gains ``depth_scale`` [B, 2],
    each sample's stored (min, max): the transfer encoding of
    :func:`compact_batch`, which the device decodes. Off-size uint8
    samples and mixed batches are promoted to f32 first, so that padding
    means metric 0.0 and not a byte that decodes to depth_min."""
    if image_size is None:
        image_size = batch[0]["image"].shape[:2]
    img_u8 = all(np.asarray(s["image"]).dtype == np.uint8 for s in batch)
    dep_u8 = all(np.asarray(s["depth"]).dtype == np.uint8 for s in batch)
    if (img_u8 and dep_u8) and any(
        np.asarray(s["image"]).shape[:2] != tuple(image_size)
        or np.asarray(s["depth"]).shape[:2] != tuple(image_size)
        for s in batch
    ):
        img_u8 = dep_u8 = False
    if not (img_u8 and dep_u8):
        batch = [sample_pixels_to_float(s) for s in batch]
        img_u8 = dep_u8 = False
    images = np.stack([_pad_or_crop(s["image"], image_size) for s in batch])
    depths = np.stack([_pad_or_crop(s["depth"], image_size) for s in batch])
    out = {
        "image": np.ascontiguousarray(
            images, np.uint8 if img_u8 else np.float32
        ),
        "depth": np.ascontiguousarray(
            depths, np.uint8 if dep_u8 else np.float32
        ),
        "keypoints_2d": np.stack([s["keypoints_2d"] for s in batch]).astype(
            np.float32
        ),
        "joints_3d": np.stack([s["joints_3d"] for s in batch]).astype(np.float32),
        "camera_params": [s.get("camera_params") for s in batch],
        "image_path": [s.get("image_path") for s in batch],
        "action": [s.get("action") for s in batch],
        "subaction": [s.get("subaction") for s in batch],
        "image_size": np.stack([s["image_size"] for s in batch]),
        "frame_idx": [s.get("frame_idx") for s in batch],
        "padding": [tuple(image_size)] * len(batch),
    }
    if dep_u8:
        out["depth_scale"] = np.array(
            [
                [
                    float(s.get("depth_min", 0.0)),
                    float(s.get("depth_max", 1.0)),
                ]
                for s in batch
            ],
            np.float32,
        )
    return out


def device_batch(batch: Dict) -> Dict:
    """Strip host-only fields, keeping the arrays the model consumes."""
    keys = ("image", "depth", "keypoints_2d", "joints_3d", "depth_scale")
    return {k: batch[k] for k in keys if k in batch}


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

"""Stage-1 provider API: 2D keypoints and metric depth per image
(counterpart of ``pose3d_tpu/stage1/api.py``).

:class:`CachedStage1` reads the artifacts the preprocess stage wrote beside
each image (``<stem>_depth.png`` and ``<stem>.json``), so inference runs
with no stage-1 model; ``"jax"`` (the name the CLIs' ``--stage1`` gives
it) builds :class:`~pose3d_tpu_torch.stage1.models.TorchStage1`, the
keypoint and depth networks batched on the card.

Keypoints: ``[J, 3]`` rows of (x/W, y/H, confidence), padded or cut to J
joints, zeros where nothing was detected. Depth: a metric depth map at the
image's resolution.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger("pose3d_tpu_torch.stage1")


@dataclass
class Stage1Result:
    """One image's stage-1 outputs."""

    keypoints: np.ndarray  # [J, 3] (norm_x, norm_y, conf)
    depth: np.ndarray      # [H, W] metric depth at the image's resolution
    depth_min: float
    depth_max: float


class CachedStage1:
    """Reads the preprocess artifacts next to each image:
    ``<stem>_depth.png`` (uint8, min/max-normalised) and ``<stem>.json``
    (``{image_size, keypoints, depth_min, depth_max}``). Depth is mapped
    back to metric with the stored min and max, as the training pipeline
    does. cv2 is imported when a depth map is read."""

    def __init__(self, num_joints: int = 17):
        self.num_joints = num_joints

    def available_for(self, image_path) -> bool:
        p = Path(image_path)
        return (p.with_name(p.stem + "_depth.png").exists()
                and p.with_suffix(".json").exists())

    def predict_one(self, image_path, image: Optional[np.ndarray] = None
                    ) -> Optional[Stage1Result]:
        import cv2

        p = Path(image_path)
        depth_path = p.with_name(p.stem + "_depth.png")
        meta_path = p.with_suffix(".json")
        if not depth_path.exists() or not meta_path.exists():
            logger.warning("No cached stage-1 artifacts for %s", p)
            return None
        with open(meta_path) as f:
            meta = json.load(f)
        depth_u8 = cv2.imread(str(depth_path), cv2.IMREAD_GRAYSCALE)
        if depth_u8 is None:
            return None
        dmin = float(meta.get("depth_min", 0.0))
        dmax = float(meta.get("depth_max", 1.0))
        depth = depth_u8.astype(np.float32) / 255.0 * (dmax - dmin) + dmin

        w, h = meta.get("image_size", [depth.shape[1], depth.shape[0]])
        kpts = np.zeros((self.num_joints, 3), np.float32)
        kp_data = meta.get("keypoints") or []
        # a list of persons, each a list of {x, y[, conf]}, or one person
        person = None
        if kp_data and isinstance(kp_data[0], list):
            person = kp_data[0]
        elif kp_data and isinstance(kp_data[0], dict):
            person = kp_data
        if person:
            for i, kp in enumerate(person[: self.num_joints]):
                kpts[i, 0] = float(kp["x"]) / float(w)
                kpts[i, 1] = float(kp["y"]) / float(h)
                kpts[i, 2] = float(kp.get("conf", 1.0))
        return Stage1Result(kpts, depth, dmin, dmax)

    def predict(self, image_paths: Sequence, images=None
                ) -> List[Optional[Stage1Result]]:
        return [self.predict_one(p) for p in image_paths]


def get_stage1_provider(kind: str = "cached", **kwargs):
    """Factory: ``"cached"`` | ``"jax"`` (the stage-1 networks:
    :class:`~pose3d_tpu_torch.stage1.models.TorchStage1`)."""
    if kind == "cached":
        return CachedStage1(**kwargs)
    if kind == "jax":
        from pose3d_tpu_torch.stage1.models import TorchStage1

        return TorchStage1(**kwargs)
    raise ValueError(f"Unknown stage1 provider: {kind}")

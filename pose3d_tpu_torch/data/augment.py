"""Coupled pose augmentations on the host, numpy and cv2, applied between
chunk decode and collation (counterpart of ``pose3d_tpu/data/augment.py``:
the same transforms, the same draws from ``np.random.default_rng(seed)``
in the same order, the same cv2 calls and flags, so both packages give
bitwise equal samples).

Interface and transform set match the reference's PoseAugmentor
(src/dataset/augmentation.py:9-351): horizontal flip with symmetric-joint
swap, rotation, scale, translation, brightness/contrast — all applied
consistently to {image, depth, keypoints_2d, joints_3d}.

Deliberate fixes of reference quirks (SURVEY.md §7: "handle deliberately,
not copy blindly"):

  * The reference rotates 3D joints about the camera *Y axis* (yaw) while
    rotating the image *in-plane*, then reprojects 2D keypoints from the
    ROOT-RELATIVE pose through the camera intrinsics
    (augmentation.py:241-263) — root-relative z spans ±0.5 m around 0, so
    most joints project behind the camera and come back as (-1, -1). Here
    rotation is a consistent in-plane rotation: the image, the 2D
    keypoints, and the 3D pose's (x, y) plane all rotate together.
  * The reference's scale aug changes the image resolution and relies on
    pad-to-max collation (dynamic shapes). Here the scaled image is
    composited back onto the static canvas (pad bottom/right or crop), so
    shapes stay static; keypoints transform accordingly.
  * Depth stays float metric throughout instead of round-tripping through
    uint8 PIL (augmentation.py:201-204) — same semantics, no quantization.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from pose3d_tpu_torch.core.config import SYMMETRIC_JOINTS_H36M
from pose3d_tpu_torch.data.collate import sample_pixels_to_float


class PoseAugmentor:
    """Sample-level augmentor; __call__ takes and returns a decoded sample
    dict (see data.chunks.decode_sample). cv2 is imported where a
    transform calls it."""

    def __init__(
        self,
        rotation_range: Tuple[float, float] = (-30.0, 30.0),
        flip_prob: float = 0.5,
        scale_range: Tuple[float, float] = (0.8, 1.2),
        translate_range: Tuple[float, float] = (-0.1, 0.1),
        brightness_range: Tuple[float, float] = (0.8, 1.2),
        contrast_range: Tuple[float, float] = (0.8, 1.2),
        enable_rotation: bool = True,
        enable_flip: bool = True,
        enable_scale: bool = True,
        enable_translate: bool = True,
        enable_color: bool = True,
        symmetric_joints: Sequence[Tuple[int, int]] = SYMMETRIC_JOINTS_H36M,
        seed: Optional[int] = None,
    ):
        self.rotation_range = rotation_range
        self.flip_prob = flip_prob
        self.scale_range = scale_range
        self.translate_range = translate_range
        self.brightness_range = brightness_range
        self.contrast_range = contrast_range
        self.enable_rotation = enable_rotation
        self.enable_flip = enable_flip
        self.enable_scale = enable_scale
        self.enable_translate = enable_translate
        self.enable_color = enable_color
        self.symmetric_joints = tuple(symmetric_joints)
        self.rng = np.random.default_rng(seed)

    # -- individual transforms -------------------------------------------

    def _flip(self, img, depth, joints, kpts):
        """Mirror image/depth; negate 3D x; x → 1−x for 2D; swap L/R joints
        (reference augmentation.py:138-180)."""
        img = img[:, ::-1].copy()
        depth = depth[:, ::-1].copy()
        joints = joints.copy()
        joints[:, 0] *= -1
        kpts = kpts.copy()
        kpts[:, 0] = 1.0 - kpts[:, 0]
        for l, r in self.symmetric_joints:
            joints[[l, r]] = joints[[r, l]]
            kpts[[l, r]] = kpts[[r, l]]
        return img, depth, joints, kpts

    def _rotate(self, img, depth, joints, kpts, angle_deg):
        """Consistent in-plane rotation about the image center."""
        import cv2

        h, w = img.shape[:2]
        center = (w / 2.0, h / 2.0)
        M = cv2.getRotationMatrix2D(center, angle_deg, 1.0)
        img = cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR)
        depth2 = cv2.warpAffine(
            depth[..., 0], M, (w, h), flags=cv2.INTER_NEAREST
        )[..., None]

        # 2D keypoints through the same affine (pixel space).
        px = np.stack([kpts[:, 0] * w, kpts[:, 1] * h, np.ones(len(kpts))], 1)
        px = px @ M.T  # [J, 2]
        kpts2 = np.stack([px[:, 0] / w, px[:, 1] / h], 1).astype(np.float32)

        # 3D pose (x, y) plane rotates with the pixels: y is down in both
        # image and camera coordinates, so the same 2×2 rotation applies.
        th = math.radians(angle_deg)
        R2 = np.array(
            [[math.cos(th), math.sin(th)], [-math.sin(th), math.cos(th)]]
        )
        joints2 = joints.copy()
        joints2[:, :2] = joints[:, :2] @ R2.T
        return img, depth2, joints2, kpts2.astype(np.float32)

    def _scale(self, img, depth, joints, kpts, factor, camera_params):
        """Zoom about the top-left corner on a static canvas: resize by
        ``factor`` then pad (f<1) or crop (f>1) back to the original H×W.
        Camera f, c scale accordingly (reference augmentation.py:266-296);
        normalized keypoints simply scale by ``factor``."""
        import cv2

        h, w = img.shape[:2]
        nh, nw = max(1, int(h * factor)), max(1, int(w * factor))
        img_s = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        dep_s = cv2.resize(
            depth[..., 0], (nw, nh), interpolation=cv2.INTER_NEAREST
        )[..., None]

        canvas = np.zeros_like(img)
        dcanvas = np.zeros_like(depth)
        ch, cw = min(h, nh), min(w, nw)
        canvas[:ch, :cw] = img_s[:ch, :cw]
        dcanvas[:ch, :cw] = dep_s[:ch, :cw]

        kpts2 = (kpts * factor).astype(np.float32)
        cam2 = None
        if camera_params:
            cam2 = dict(camera_params)
            cam2["f"] = [float(f) * factor for f in camera_params["f"]]
            cam2["c"] = [float(c) * factor for c in camera_params["c"]]
        return canvas, dcanvas, joints, kpts2, cam2

    def _translate(self, img, depth, kpts, tx, ty):
        """Shift image/depth and keypoints (reference augmentation.py:299-325)."""
        import cv2

        h, w = img.shape[:2]
        M = np.float32([[1, 0, tx], [0, 1, ty]])
        img = cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR)
        depth2 = cv2.warpAffine(
            depth[..., 0], M, (w, h), flags=cv2.INTER_NEAREST
        )[..., None]
        kpts2 = kpts.copy()
        kpts2[:, 0] += tx / w
        kpts2[:, 1] += ty / h
        return img, depth2, kpts2

    def _color(self, img, brightness, contrast):
        """Brightness then contrast, torchvision semantics
        (adjust_brightness: x·b; adjust_contrast: (x−mean_gray)·c+mean_gray)."""
        img = np.clip(img * brightness, 0.0, 1.0)
        gray_mean = float(
            (0.2989 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
            .mean()
        )
        img = np.clip((img - gray_mean) * contrast + gray_mean, 0.0, 1.0)
        return img.astype(np.float32)

    # -- pipeline --------------------------------------------------------

    def __call__(self, sample: Dict) -> Dict:
        # uint8-pixel samples (pixel_dtype="uint8" decode) enter the
        # float convention here — geometric/color transforms below assume
        # [0,1] images and metric depth. Per-sample conversion keeps the
        # prefetch queue's 4× memory win upstream of augmentation.
        sample = sample_pixels_to_float(sample)
        out = dict(sample)
        img = np.asarray(sample["image"], np.float32)
        depth = np.asarray(sample["depth"], np.float32)
        joints = np.asarray(sample["joints_3d"], np.float32)
        kpts = np.asarray(sample["keypoints_2d"], np.float32)
        cam = sample.get("camera_params")

        if self.enable_flip and self.rng.random() < self.flip_prob:
            img, depth, joints, kpts = self._flip(img, depth, joints, kpts)

        if self.enable_rotation:
            angle = self.rng.uniform(*self.rotation_range)
            img, depth, joints, kpts = self._rotate(
                img, depth, joints, kpts, angle
            )

        if self.enable_scale:
            f = self.rng.uniform(*self.scale_range)
            img, depth, joints, kpts, cam2 = self._scale(
                img, depth, joints, kpts, f, cam
            )
            if cam2 is not None:
                out["camera_params"] = cam2

        if self.enable_translate:
            h, w = img.shape[:2]
            tx = self.rng.uniform(*self.translate_range) * w
            ty = self.rng.uniform(*self.translate_range) * h
            img, depth, kpts = self._translate(img, depth, kpts, tx, ty)

        if self.enable_color:
            b = self.rng.uniform(*self.brightness_range)
            c = self.rng.uniform(*self.contrast_range)
            img = self._color(img, b, c)

        out["image"] = img.astype(np.float32)
        out["depth"] = depth.astype(np.float32)
        out["joints_3d"] = joints.astype(np.float32)
        out["keypoints_2d"] = kpts.astype(np.float32)
        return out

"""Camera geometry on tensors (counterpart of
``pose3d_tpu/geometry/camera.py``).

Numerics match the reference's utilities (reference src/utils.py:6-52),
vectorized: the reference's per-joint Python loop in
``camera_to_pixel_coords`` (src/utils.py:26-46) becomes one broadcasted op.
Points, rotations and camera parameters are taken as tensors or anything
``torch.as_tensor`` reads, and computed in fp32 on the points' device.
"""

from __future__ import annotations

import torch


def _f32(x, like=None) -> torch.Tensor:
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def world_to_camera(joints_world, R, t) -> torch.Tensor:
    """Rigid transform of points from world to camera coordinates.

    Args:
      joints_world: [..., J, 3] world-space points.
      R: [3, 3] rotation matrix.
      t: [3] or [3, 1] translation.

    Returns:
      [..., J, 3] camera-space points, ``R @ x + t`` per point
      (reference src/utils.py:6-23).
    """
    joints_world = _f32(joints_world)
    R = _f32(R, joints_world)
    t = _f32(t, joints_world).reshape(3)
    return joints_world @ R.T + t


def camera_to_pixel(joints_camera, f, c) -> torch.Tensor:
    """Pinhole projection of camera-space points to pixel coordinates.

    Args:
      joints_camera: [..., J, 3] camera-space points.
      f: [2] focal lengths (fx, fy).
      c: [2] principal point (cx, cy).

    Returns:
      [..., J, 2] pixel coordinates ``(x*fx/z + cx, y*fy/z + cy)``
      (reference src/utils.py:26-46, vectorized).
    """
    joints_camera = _f32(joints_camera)
    f = _f32(f, joints_camera)
    c = _f32(c, joints_camera)
    xy = joints_camera[..., :2]
    z = joints_camera[..., 2:3]
    return xy * f / z + c


def project_with_validity(joints_camera, f, c,
                          invalid_value: float = -1.0) -> torch.Tensor:
    """Projection with a behind-camera guard: joints with z <= 0 map to
    ``invalid_value`` (reference src/dataset/augmentation.py:89-117)."""
    joints_camera = _f32(joints_camera)
    px = camera_to_pixel(joints_camera, f, c)
    valid = joints_camera[..., 2:3] > 0
    return torch.where(valid, px, torch.full_like(px, invalid_value))


def normalize_depth(depth, depth_min, depth_max):
    """Min/max normalization of a depth map to [0, 1]
    (reference src/utils.py:49-52)."""
    return (depth - depth_min) / (depth_max - depth_min)


def denormalize_depth(depth01, depth_min, depth_max):
    """Inverse of :func:`normalize_depth`: rescale a [0,1] depth back toward
    metric using the stored per-image min/max (the training input-pipeline
    convention, reference src/dataset/chunked_dataset.py:159-167)."""
    return depth01 * (depth_max - depth_min) + depth_min


def root_center(joints_3d, root_index: int = 0) -> torch.Tensor:
    """Subtract the root joint, producing root-relative (IND-P) poses
    (reference src/dataset/chunked_dataset.py:205-206)."""
    joints_3d = torch.as_tensor(joints_3d)
    return joints_3d - joints_3d[..., root_index:root_index + 1, :]

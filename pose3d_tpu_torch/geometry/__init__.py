"""Pose geometry (counterpart of ``pose3d_tpu.geometry``)."""

from pose3d_tpu_torch import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "world_to_camera": "camera",
    "camera_to_pixel": "camera",
    "normalize_depth": "camera",
    "root_center": "camera",
    "mpjpe": "metrics",
    "pa_mpjpe": "metrics",
    "procrustes_align": "metrics",
})

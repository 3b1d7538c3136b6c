"""Pose geometry (counterpart of ``pose3d_tpu.geometry``)."""

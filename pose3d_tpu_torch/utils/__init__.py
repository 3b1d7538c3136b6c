"""Profiling and memory reports (counterpart of ``pose3d_tpu.utils``)."""

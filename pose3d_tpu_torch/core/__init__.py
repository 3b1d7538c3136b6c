"""Configuration (counterpart of ``pose3d_tpu.core``)."""

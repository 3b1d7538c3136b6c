"""Training of the lifter (counterpart of ``pose3d_tpu.train``)."""

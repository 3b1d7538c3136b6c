"""3D pose plots (counterpart of ``pose3d_tpu.viz``); matplotlib and PIL
are imported when a plot is made."""

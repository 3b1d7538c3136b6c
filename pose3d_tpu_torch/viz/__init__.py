"""3D pose plots (counterpart of ``pose3d_tpu.viz``); matplotlib and PIL
are imported when a plot is made."""

from pose3d_tpu_torch import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "visualize_3d_pose": "plots",
    "visualize_comparison": "plots",
    "fig_to_image": "plots",
})

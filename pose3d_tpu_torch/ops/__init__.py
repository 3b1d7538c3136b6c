"""Tensor ops (counterpart of ``pose3d_tpu.ops``); hand-written CUDA
kernels live in :mod:`pose3d_tpu_torch.ops.kernels`."""

from pose3d_tpu_torch import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "gaussian_heatmaps": "heatmap",
    "composite_pose_loss": "losses",
    "LossWeights": "losses",
    "get_activation": "activations",
})

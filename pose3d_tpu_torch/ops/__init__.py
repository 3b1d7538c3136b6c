"""Tensor ops (counterpart of ``pose3d_tpu.ops``); hand-written CUDA
kernels live in :mod:`pose3d_tpu_torch.ops.kernels`."""

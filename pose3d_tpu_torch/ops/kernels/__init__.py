"""Hand-written CUDA kernels (counterpart of ``pose3d_tpu.ops.pallas``).

Each kernel module holds the wrapper that launches the kernel on CUDA
tensors, with a launch counter, and its plain PyTorch version beside it.
The libraries are built from ``pose3d_tpu_torch/csrc`` at first use
(:mod:`._build`).
"""

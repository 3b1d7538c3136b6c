"""Hand-written CUDA kernels (counterpart of ``pose3d_tpu.ops.pallas``).

Each kernel module holds the wrapper that launches the kernel on CUDA
tensors, with a launch counter, and its plain PyTorch version beside it.
The libraries are built from ``pose3d_tpu_torch/csrc`` at first use
(:mod:`._build`).
"""


def wrappers() -> tuple:
    """The eight kernel wrappers; each counts its launches in its
    ``launches`` attribute."""
    from pose3d_tpu_torch.ops.kernels import (
        bn_stats,
        flash_attention,
        lane_resample,
        layer_norm,
        mlp_block,
    )

    return (flash_attention.flash_attention_fwd,
            flash_attention.flash_attention_bwd, bn_stats.bn_stats,
            lane_resample.lane_resample, layer_norm.layer_norm_fwd,
            layer_norm.layer_norm_bwd, mlp_block.mlp_block_fwd,
            mlp_block.mlp_block_bwd)


def launch_counts() -> dict:
    """Each kernel wrapper's launch count in this process, by the wrapper's
    name (what a script reports beside the run that drove the kernels)."""
    return {fn.__name__: fn.launches for fn in wrappers()}

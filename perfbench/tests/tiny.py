"""Tiny versions of the benchmark's cells for the CPU tests: the same
files, with the models cut to a few channels and the traffic to a few
samples."""

import copy

from perfbench.harness import cell

TINY = {
    "cnn": dict(image_size=[32, 32], heatmap_size=32, initial_channels=8,
                stage_channels=[16, 24, 32], stage_depths=[1, 2, 3],
                stage_strides=[2, 2, 2], stage_expand_ratios=[1, 2, 3],
                global_pool_size=2, global_feature_dim=16,
                regression_dims=[16, 8]),
    "transformer": dict(image_size=[32, 32], vit_patch_size=16,
                        transformer_embed_dim=32, vit_heads=2,
                        transformer_heads=4, heatmap_size=16,
                        heatmap_patch_size=8, vit_depth=2,
                        num_cross_modal_layers=1, final_encoder_depth=1,
                        regression_hidden_dims=[16, 8]),
}


def tiny_spec(name: str, compute: str = "float32", limit: float = 1e-3):
    """Cell ``name`` at a tiny size on the CPU, the program in ``compute``
    and every limit at ``limit``."""
    spec = copy.deepcopy(cell(name))
    cfg = spec["config"]
    cfg["model_args"].update(TINY[cfg["model_args"]["model_type"]])
    cfg["precision"]["compute"] = compute
    spec["traffic"].update(batch=4, accumulation=3, trace_steps=1)
    spec["limits"] = {k: limit for k in spec["limits"]}
    return spec

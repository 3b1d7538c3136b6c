"""Model construction from self-describing configs (counterpart of
``pose3d_tpu/models/factory.py``)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from pose3d_tpu_torch.core.config import (
    TransformerModelConfig,
    make_model_config,
)
from pose3d_tpu_torch.models.transformer import (
    HeatmapGrid,
    MultiHeadAttention,
    TransformerPoseEstimation,
)


@torch.no_grad()
def _init_weights(model: nn.Module, gen: torch.Generator) -> None:
    """Random init from ``gen``, after the JAX package's initialisers:
    xavier-uniform Linears with zero bias, LeCun-normal patch convs,
    truncated-normal(0.02) tokens and positions, unit LayerNorms."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            nn.init.xavier_uniform_(mod.weight, generator=gen)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, MultiHeadAttention):
            # three D×D projections packed row-wise, each xavier on its own
            for w in mod.in_proj_weight.chunk(3, dim=0):
                nn.init.xavier_uniform_(w, generator=gen)
            nn.init.zeros_(mod.in_proj_bias)
        elif isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            nn.init.normal_(mod.weight, 0.0, 1.0 / math.sqrt(fan_in),
                            generator=gen)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, HeatmapGrid):
            mod.reset_buffers()
        for name, p in mod.named_parameters(recurse=False):
            if name.endswith(("cls_token", "pos_embed", "pos_embed_hm")):
                nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04,
                                      generator=gen)


def build_model(config, *, device="cpu", dtype=torch.bfloat16,
                generator: Optional[torch.Generator] = None,
                attention_impl: str = "auto",
                train: bool = False) -> TransformerPoseEstimation:
    """Instantiate the lifter for a config (or model_type string) on
    ``device`` with fp32 parameters randomly initialised from
    ``generator`` (default: a generator on ``device`` seeded 0).
    ``dtype`` is the compute dtype; see :class:`TransformerPoseEstimation`
    for ``attention_impl``. Load trained weights with
    ``load_state_dict``.

    By default the model is frozen in eval mode (serving). ``train=True``
    returns it in train mode with every parameter requiring grad, for
    :mod:`pose3d_tpu_torch.train`."""
    if isinstance(config, str):
        config = make_model_config(config)
    if not isinstance(config, TransformerModelConfig):
        raise ValueError(f"Unsupported model config: {type(config)}")
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    with torch.device("meta"):
        model = TransformerPoseEstimation(
            config, dtype=dtype, attention_impl=attention_impl)
    model = model.to_empty(device=generator.device)
    _init_weights(model, generator)
    return model.to(device).train(train).requires_grad_(train)


def dummy_inputs(config, batch_size: int = 1, device="cpu"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inputs with the model's static shapes (NHWC): zero image and depth,
    keypoints at the centre."""
    H, W = config.image_size
    J = config.num_joints
    return (
        torch.zeros((batch_size, H, W, 3), device=device),
        torch.zeros((batch_size, H, W, 1), device=device),
        torch.full((batch_size, J, 2), 0.5, device=device),
    )

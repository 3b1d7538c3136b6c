"""Model construction from self-describing configs (counterpart of
``pose3d_tpu/models/factory.py``)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from pose3d_tpu_torch.core.config import (
    CNNModelConfig,
    TransformerModelConfig,
    make_model_config,
)
from pose3d_tpu_torch.models.cnn import (
    CNNPoseEstimation,
    CoordAttention,
    ECABlock,
    GroupNorm,
    _BatchNormBase,
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


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default kernel init: a normal of variance 1/fan_in cut at two
    standard deviations (and widened so the cut keeps that variance)."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


@torch.no_grad()
def _init_cnn_weights(model: nn.Module, gen: torch.Generator) -> None:
    """Random init from ``gen``, after the JAX package's initialisers:
    Kaiming-normal (fan-out) for every conv and Linear with zero bias,
    LeCun-normal for the ECA and CoordAttention convs, WASP branch weights
    1/n, BatchNorm scale 1, bias 0, running mean 0 and variance 1,
    GroupNorm scale 1, bias 0."""
    lecun = {id(c) for m in model.modules()
             for c in ((m.conv,) if isinstance(m, ECABlock) else
                       (m.conv1, m.conv_h, m.conv_w)
                       if isinstance(m, CoordAttention) else ())}
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv1d, nn.Linear)):
            if id(mod) in lecun:
                _lecun_normal_(mod.weight, gen)
            else:
                fan_out = mod.weight.shape[0] * mod.weight[0, 0].numel()
                nn.init.normal_(mod.weight, 0.0, math.sqrt(2.0 / fan_out),
                                generator=gen)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, _BatchNormBase):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
            mod.num_batches_tracked.zero_()
        elif isinstance(mod, GroupNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, HeatmapGrid):
            mod.reset_buffers()
    model.wasp.weights.fill_(1.0 / model.wasp.weights.numel())


def build_model(config, *, device="cuda", dtype=torch.bfloat16,
                generator: Optional[torch.Generator] = None,
                attention_impl: str = "auto", stats_impl: str = "auto",
                remat: bool = False, train: bool = False,
                **model_kwargs) -> nn.Module:
    """Instantiate the lifter for a config (or model_type string) on
    ``device`` with fp32 parameters randomly initialised from
    ``generator`` (default: a generator on ``device`` seeded 0). The
    device defaults to the card and there is no fallback: without CUDA
    this raises unless the caller asks for ``device="cpu"``.
    ``dtype`` is the compute dtype; see :class:`TransformerPoseEstimation`
    for ``attention_impl`` and :class:`CNNPoseEstimation` for
    ``stats_impl`` (each is read by its own model only); ``remat``
    rematerialises either model's blocks in the backward pass.
    ``model_kwargs`` go to the transformer, as the JAX factory forwards
    them: ``vit_stacked``, ``vit_block_runner`` and ``sp_constraint``
    (pipeline and sequence parallelism); the CNN refuses them.
    Load trained weights with ``load_state_dict``.

    By default the model is frozen in eval mode (serving). ``train=True``
    returns it in train mode with every parameter requiring grad, for
    :mod:`pose3d_tpu_torch.train`."""
    if isinstance(config, str):
        config = make_model_config(config)
    if not isinstance(config, (CNNModelConfig, TransformerModelConfig)):
        raise ValueError(f"Unsupported model config: {type(config)}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    is_cnn = isinstance(config, CNNModelConfig)
    allowed = () if is_cnn else ("vit_stacked", "vit_block_runner",
                                 "sp_constraint")
    if set(model_kwargs) - set(allowed):
        raise ValueError(f"unsupported {'CNN' if is_cnn else 'transformer'} "
                         f"model kwargs: {sorted(model_kwargs)}")
    with torch.device("meta"):
        if is_cnn:
            model = CNNPoseEstimation(config, dtype=dtype,
                                      stats_impl=stats_impl, remat=remat)
        else:
            model = TransformerPoseEstimation(
                config, dtype=dtype, attention_impl=attention_impl,
                remat=remat, **model_kwargs)
    model = model.to_empty(device=generator.device)
    (_init_cnn_weights if is_cnn else _init_weights)(model, generator)
    return model.to(device).train(train).requires_grad_(train)


def parameter_names(config) -> list:
    """The model's parameter names in ``model.parameters()`` order (built
    on the meta device: nothing is allocated)."""
    if isinstance(config, str):
        config = make_model_config(config)
    cls = (CNNPoseEstimation if isinstance(config, CNNModelConfig)
           else TransformerPoseEstimation)
    with torch.device("meta"):
        return [n for n, _ in cls(config).named_parameters()]


def dummy_inputs(config, batch_size: int = 1, device="cuda"
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

"""Configuration (counterpart of ``pose3d_tpu/core/config.py``).

``GlobalConfig`` holds the training hyperparameters the port reads.
``CNNModelConfig`` and ``TransformerModelConfig`` have the same field
names, defaults and checks as the JAX package's, so the ``model_args``
stored in a reference ``.pth`` (``pose3d-convert --to-torch``) rebuild the
same architecture.
The JAX module is not imported: its package ``__init__`` loads JAX.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple

# Bones of the Human3.6M 17-joint skeleton: 0 pelvis, 1-3 right leg, 4-6
# left leg, 7 spine, 8 thorax, 9 neck, 10 head, 11-13 left arm, 14-16 right
# arm.
CONNECTIONS_H36M: Tuple[Tuple[int, int], ...] = (
    (0, 1), (1, 2), (2, 3),
    (0, 4), (4, 5), (5, 6),
    (0, 7), (7, 8), (8, 9), (9, 10),
    (8, 11), (11, 12), (12, 13),
    (8, 14), (14, 15), (15, 16),
)

# Bones of the COCO 17-keypoint skeleton of the 2D detector's outputs (the
# inference CLI's keypoint panel).
CONNECTIONS_COCO: Tuple[Tuple[int, int], ...] = (
    (0, 1), (0, 2), (1, 3), (2, 4), (0, 5), (0, 6), (5, 7), (7, 9),
    (6, 8), (8, 10), (5, 6), (5, 11), (6, 12), (11, 12), (11, 13),
    (13, 15), (12, 14), (14, 16),
)

# Left/right joint pairs of the Human3.6M 17-joint skeleton, swapped when a
# sample is mirrored.
SYMMETRIC_JOINTS_H36M: Tuple[Tuple[int, int], ...] = (
    (1, 4), (2, 5), (3, 6), (11, 14), (12, 15), (13, 16),
)


@dataclass(frozen=True)
class GlobalConfig:
    """Training hyperparameters: the fields of the JAX package's
    ``GlobalConfig`` that the port's training runs read, with the same
    names and defaults (batch 10 × accumulation 10, a validation and
    checkpoint every 5,000 steps, a preview every 50, AdamW lr 1e-3 and
    weight decay 0.01, loss weights mse 1, l1 1, inter-joint 100,
    abs-root 1, TensorBoard under ``./logs``, checkpoints named
    ``model_epoch__<type>_step_<N>``, bf16 compute over fp32 parameters).
    Host augmentation is ``--augment`` alone, with ``PoseAugmentor``'s
    default ranges; device augmentation has its own
    ``ops.augment_device.DeviceAugmentConfig``; mesh fields come with the
    modules that read them."""

    random_seed: int = 42
    batch_size: int = 10
    gradient_accumulation_steps: int = 10
    eval_interval: int = 5000
    preview_interval: int = 50
    model_type: str = "cnn"

    inter_joint_loss_weight: float = 100.0
    abs_root_loss_weight: float = 1.0
    l1_loss_weight: float = 1.0
    mse_loss_weight: float = 1.0

    learning_rate: float = 1e-3
    weight_decay: float = 0.01

    log_dir: str = "./logs"
    checkpoint_prefix: str = "model_epoch_"

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class CNNModelConfig:
    """CNN lifting-model hyperparameters: the published architecture
    (500×500 input of RGB + depth + 17 heatmaps, stem 64, stages
    128/256/512 of depths 3/4/5 with expand ratios 1/3/6, WASP, 8×8 global
    pooling to 1024 features, head 1024/512).

    ``normalization``: "batch" (BatchNorm with flax's numerics),
    "batch_pallas" (the BatchNorm whose batch statistics come from the
    hand-written ``bn_stats`` kernel), "batch_pallas:N" (the kernel only
    for layers of N pixels a sample or more) or "batch_dot" (the same
    BatchNorm with plain statistics)."""

    model_type: str = "cnn"
    image_size: Tuple[int, int] = (500, 500)
    in_channels: int = 3 + 1 + 17  # RGB + depth + per-joint heatmaps
    num_joints: int = 17

    heatmap_size: int = 500
    heatmap_sigma: float = 10.0

    initial_channels: int = 64
    initial_kernel_size: int = 5
    initial_stride: int = 2

    stage_channels: Tuple[int, ...] = (128, 256, 512)
    stage_depths: Tuple[int, ...] = (3, 4, 5)
    stage_strides: Tuple[int, ...] = (2, 2, 2)
    stage_expand_ratios: Tuple[int, ...] = (1, 3, 6)

    use_se_blocks: bool = True
    se_reduction: int = 16
    use_dual_path_blocks: bool = True

    global_pool_size: int = 8
    global_feature_dim: int = 1024

    regression_dims: Tuple[int, ...] = (1024, 512)
    regression_dropout: float = 0.2

    activation: str = "silu"
    normalization: str = "batch"

    residual_scale: float = 1.0
    depthwise_kernel_size: int = 3

    def __post_init__(self):
        h, w = self.image_size
        if self.heatmap_size != h or self.heatmap_size != w:
            raise ValueError(
                "CNNModelConfig: heatmap_size must equal image_size — the "
                "forward pass concatenates [image, depth, heatmaps] on the "
                "channel axis at full resolution; "
                f"got heatmap_size={self.heatmap_size}, "
                f"image_size={self.image_size}"
            )
        expected_in = 3 + 1 + self.num_joints
        if self.in_channels != expected_in:
            raise ValueError(
                "CNNModelConfig: in_channels must be 3 (RGB) + 1 (depth) + "
                f"num_joints heatmaps = {expected_in}; got {self.in_channels} "
                f"(num_joints={self.num_joints})"
            )
        if not (len(self.stage_channels) == len(self.stage_depths)
                == len(self.stage_strides) == len(self.stage_expand_ratios)):
            raise ValueError(
                "CNNModelConfig: stage_channels/stage_depths/stage_strides/"
                "stage_expand_ratios must all have the same length; got "
                f"{len(self.stage_channels)}/{len(self.stage_depths)}/"
                f"{len(self.stage_strides)}/{len(self.stage_expand_ratios)}"
            )

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CNNModelConfig":
        return _from_dict(cls, d)


@dataclass(frozen=True)
class TransformerModelConfig:
    """Transformer lifting-model hyperparameters (ViT-B/16 image stream at
    512×512, 64×64 heatmap stream, 2 fusion blocks, 4 final blocks)."""

    model_type: str = "transformer"
    num_joints: int = 17
    heatmap_sigma: float = 2.0

    vit_model_name: str = "vit_base_patch16_384"
    vit_pretrained: bool = True
    vit_freeze_backbone: bool = False
    image_size: Tuple[int, int] = (512, 512)
    image_in_channels: int = 4  # RGB + depth

    heatmap_size: int = 64
    heatmap_patch_size: int = 16
    heatmap_in_channels: int = 17

    transformer_embed_dim: int = 768
    transformer_heads: int = 16
    transformer_mlp_ratio: float = 4.0
    transformer_dropout_rate: float = 0.1
    transformer_attention_dropout_rate: float = 0.1

    num_cross_modal_layers: int = 2
    final_encoder_depth: int = 4

    activation: str = "gelu"

    regression_hidden_dims: Tuple[int, ...] = (1024, 512, 256)
    regression_dropout: float = 0.25

    vit_depth: int = 12
    vit_heads: int = 12
    vit_patch_size: int = 16

    def __post_init__(self):
        h, w = self.image_size
        if h % self.vit_patch_size or w % self.vit_patch_size:
            raise ValueError(
                "TransformerModelConfig: image_size must be divisible by "
                f"vit_patch_size={self.vit_patch_size}; got {self.image_size}"
            )
        if self.heatmap_size % self.heatmap_patch_size:
            raise ValueError(
                "TransformerModelConfig: heatmap_size must be divisible by "
                f"heatmap_patch_size={self.heatmap_patch_size}; got "
                f"{self.heatmap_size}"
            )
        if self.transformer_embed_dim % self.transformer_heads:
            raise ValueError(
                "TransformerModelConfig: transformer_embed_dim must be "
                f"divisible by transformer_heads; got "
                f"{self.transformer_embed_dim} / {self.transformer_heads}"
            )
        if self.heatmap_in_channels != self.num_joints:
            raise ValueError(
                "TransformerModelConfig: heatmap_in_channels must equal "
                f"num_joints; got {self.heatmap_in_channels} vs "
                f"{self.num_joints}"
            )

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TransformerModelConfig":
        return _from_dict(cls, d)


def _from_dict(cls, d: Dict[str, Any]):
    """Build a config from a (possibly checkpoint-loaded) dict, ignoring
    unknown keys and turning lists into tuples (a ``.pth``'s
    ``model_args`` holds ``image_size`` as a list)."""
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            continue
        if isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[k] = v
    return cls(**kwargs)


def make_model_config(model_type: str = None, /, **kwargs):
    """``model_type`` + ``model_args`` → config, as the JAX package's
    factory. ``kwargs`` may carry ``model_type`` itself (checkpoint
    round-trip); it then wins over the positional argument."""
    model_type = str(kwargs.pop("model_type", model_type)).lower()
    if model_type == "transformer":
        return TransformerModelConfig.from_dict(
            {**kwargs, "model_type": "transformer"}
        )
    if model_type == "cnn":
        return CNNModelConfig.from_dict({**kwargs, "model_type": "cnn"})
    raise ValueError(f"Unsupported model type: {model_type}")

"""Shared pieces of the stage-1 parity tests: tiny weight files in the
upstream formats (a YOLO11n-pose state_dict from the torch replica, an HF
``save_pretrained`` DepthPro directory at a tiny config), seeded images,
and the JAX package's stage-1 variables as numpy."""

import numpy as np
import pytest
import torch

from yolo11_torch_replica import YOLO11PoseTorch, randomize_bn_stats

# HF DepthProConfig at a tiny size (the JAX package's own port test uses it)
TINY_VIT = dict(model_type="dinov2", hidden_size=32, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=128, patch_size=4,
                image_size=16)
TINY_DEPTHPRO = dict(
    fusion_hidden_size=16, patch_size=16, intermediate_hook_ids=[1, 0],
    intermediate_feature_dims=[16, 16],
    scaled_images_ratios=[0.25, 0.5, 1.0],
    scaled_images_overlap_ratios=[0.0, 0.5, 0.25],
    scaled_images_feature_dims=[32, 32, 16], merge_padding_value=3,
    use_fov_model=True, num_fov_head_layers=2,
    image_model_config=TINY_VIT, patch_model_config=TINY_VIT,
    fov_model_config=TINY_VIT)
DEPTH_S = 64      # the tiny DepthPro's input size
YOLO_S = 64       # YOLO11n's input size in these tests


def yolo_replica(seed: int = 0, scale: str = "n"):
    torch.manual_seed(seed)
    return randomize_bn_stats(YOLO11PoseTorch(scale=scale).eval(), seed=seed)


def write_yolo(path, seed: int = 0):
    """A plain upstream-named YOLO11n-pose state_dict ``.pt``; returns the
    replica."""
    model = yolo_replica(seed)
    torch.save(model.state_dict(), path)
    return model


def write_depthpro(directory, seed: int = 0):
    """HF ``save_pretrained`` of a tiny DepthProForDepthEstimation
    (``model.safetensors`` + ``config.json``). The last biases of the depth
    head (+200) and the FOV head (60°) are set so that the outputs are
    positive, as a trained model's are: otherwise the ReLU'd canonical
    depth and a negative angle clip most of the metric depth to one
    constant. Returns the HF model."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    model = transformers.DepthProForDepthEstimation(
        transformers.DepthProConfig(**TINY_DEPTHPRO)).eval()
    with torch.no_grad():
        model.head.layers[4].bias.fill_(200.0)
        model.fov_model.head.layers[4].bias.fill_(60.0)
    model.save_pretrained(directory)
    return model


def images(seed: int, sizes, dtype=np.uint8):
    """Seeded RGB images of the given (h, w) sizes: smooth gradients plus
    noise, so that resizing is not all noise."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w in sizes:
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx / w, yy / h, (xx + yy) / (h + w)], -1) * 180
        im = base + rng.uniform(0, 75, size=(h, w, 3))
        out.append(np.clip(im, 0, 255).astype(dtype))
    return out


def to_np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)

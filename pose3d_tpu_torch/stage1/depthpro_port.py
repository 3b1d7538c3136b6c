"""HF DepthPro checkpoints → :class:`DepthProDepthEstimator` (counterpart
of ``pose3d_tpu/stage1/depthpro_port.py``).

``apple/DepthPro-hf`` weights (``.safetensors``, read by the port's own
reader, or a torch ``.pth`` / ``.bin`` state_dict) load strictly into the
port's module, whose paths are HF's, after the keys the forward never
reads are dropped (``_DEAD_KEY_PATTERNS``). The architecture comes from a
sibling ``config.json`` where there is one, else from the tensor shapes,
with apple/DepthPro-hf's values for the few fields shapes do not show.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import Dict, Optional

import torch

from pose3d_tpu_torch.stage1.depthpro import (
    DepthProArch,
    DepthProDepthEstimator,
    ViTArch,
)
from pose3d_tpu_torch.stage1.port import load_torch_state_dict, resolve_device
from pose3d_tpu_torch.stage1.yolo11 import cast_for_inference

logger = logging.getLogger("pose3d_tpu_torch.stage1.depthpro_port")

# keys of HF checkpoints that have no effect on the forward
_DEAD_KEY_PATTERNS = (
    re.compile(r"\.mask_token$"),
    # the first fusion layer gets no skip input: HF creates its
    # residual_layer1 and never runs it
    re.compile(r"^fusion_stage\.intermediate\.0\.residual_layer1\."),
    re.compile(r"\.num_batches_tracked$"),
)


def load_state_dict(path) -> Dict[str, torch.Tensor]:
    """A DepthPro weight file → ``{key: fp32 CPU tensor}`` (all keys)."""
    return load_torch_state_dict(path)


def live_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``sd`` without the keys the forward never reads."""
    return {k: v for k, v in sd.items()
            if not any(p.search(k) for p in _DEAD_KEY_PATTERNS)}


def arch_from_state_dict(sd: Dict[str, torch.Tensor],
                         config: Optional[dict] = None,
                         image_size: int = 1536) -> DepthProArch:
    """DepthProArch from the checkpoint's shapes, with an HF
    ``config.json`` dict (optional) for the fields shapes do not show."""
    config = config or {}
    vit_cfg = config.get("image_model_config", {}) or {}
    enc = "depth_pro.encoder.image_encoder.model."
    hidden = sd[enc + "embeddings.cls_token"].shape[-1]
    vit_patch = sd[enc + "embeddings.patch_embeddings.projection.weight"
                   ].shape[-1]
    n_pos = sd[enc + "embeddings.position_embeddings"].shape[1] - 1
    layer_ids = {int(m.group(1)) for k in sd
                 if (m := re.search(r"encoder\.layer\.(\d+)\.norm1\.weight$",
                                    k))}
    vit = ViTArch(
        hidden_size=hidden, num_layers=max(layer_ids) + 1,
        num_heads=vit_cfg.get("num_attention_heads") or max(hidden // 64, 1),
        patch_size=vit_patch,
        image_size=vit_patch * int(round(n_pos ** 0.5)),
        mlp_ratio=sd[enc + "encoder.layer.0.mlp.fc1.weight"].shape[0]
        // hidden)
    up = "depth_pro.neck.feature_upsample."
    scaled_dims, inter_dims = [], []
    for i in range(8):
        k = up + f"scaled_images.{i}.layers.0.weight"
        if k not in sd:
            break
        scaled_dims.append(sd[k].shape[0])
    for i in range(8):
        # layers.1 is the first transposed conv: weight [in, out, k, k]
        k = up + f"intermediate.{i}.layers.1.weight"
        if k not in sd:
            break
        inter_dims.append(sd[k].shape[1])
    use_fov = any(k.startswith("fov_model.") for k in sd)
    n_fov_layers = (len({k for k in sd
                         if k.startswith("fov_model.head.layers")
                         and k.endswith(".weight")}) - 1) if use_fov else 2
    return DepthProArch(
        fusion_hidden_size=sd["head.layers.0.weight"].shape[1],
        patch_size=vit.image_size,
        intermediate_hook_ids=tuple(config.get("intermediate_hook_ids",
                                               (11, 5)))[:len(inter_dims)],
        intermediate_feature_dims=tuple(inter_dims),
        scaled_images_ratios=tuple(config.get("scaled_images_ratios",
                                              (0.25, 0.5, 1.0))),
        scaled_images_overlap_ratios=tuple(config.get(
            "scaled_images_overlap_ratios", (0.0, 0.5, 0.25))),
        scaled_images_feature_dims=tuple(scaled_dims),
        merge_padding_value=config.get("merge_padding_value", 3),
        use_fov_model=use_fov,
        num_fov_head_layers=n_fov_layers,
        image_size=image_size,
        vit=vit,
    )


def load_depth_pro(path, dtype: torch.dtype = torch.float32,
                   image_size: int = 1536, device="cuda"
                   ) -> DepthProDepthEstimator:
    """Load a DepthPro checkpoint → the module on ``device`` in eval mode,
    weights in ``dtype`` (the heads' last convolutions fp32), attention the
    plain version (``set_attention_backend`` switches it):
    ``model(pixels [B, 3, S, S])`` → (canonical inverse depth, fov_deg).
    ``device`` defaults to the card and raises without CUDA unless the
    caller asks for the CPU."""
    device = resolve_device(device)
    sd = load_state_dict(path)
    cfg_path = Path(path).parent / "config.json"
    config = None
    if cfg_path.exists():
        with open(cfg_path) as f:
            config = json.load(f)
    arch = arch_from_state_dict(sd, config, image_size=image_size)
    logger.info("loading DepthPro: %s", arch)
    with torch.device("meta"):      # no init: every tensor is loaded
        model = DepthProDepthEstimator(arch)
    model.load_state_dict(live_state_dict(sd), strict=True, assign=True)
    return cast_for_inference(model, dtype).to(device)

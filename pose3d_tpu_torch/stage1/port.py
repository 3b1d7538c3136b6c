"""Weight files → the port's modules (counterpart of
``pose3d_tpu/stage1/port.py``).

* :func:`load_torch_state_dict` reads a ``.pth`` / ``.pt`` / ``.bin`` /
  ``.safetensors`` file into ``{name: fp32 CPU tensor}``;
  :func:`read_safetensors` is its own ``.safetensors`` reader (an 8-byte
  little-endian header length, the JSON header, then the raw tensors), so
  no ``safetensors`` package is needed.
* :func:`port_vit_backbone` maps a timm ViT state_dict
  (``vit_base_patch16_384`` family) onto the transformer lifter's
  ``vit_backbone`` (``models/transformer.py``'s ``ViTBackbone``, whose
  names are timm's), with the two adaptations the reference makes when it
  wraps timm: the patch embedding inflated from 3 to ``in_channels``
  channels (the RGB kernels copied, each extra channel the mean over RGB)
  and the position-embedding grid resized bicubically (cv2) to the
  configured image size.
* :func:`fold_torch_path` / :func:`unfold_flax_path` turn a torch module
  path into the JAX package's flax path and back
  (``model.23.cv3.0.0.0`` ↔ ``model_23/cv3_0_0_0``): the weight bridge from
  the JAX package's variables (``compat.py``) uses them.
"""

from __future__ import annotations

import json
import logging
import re
from typing import Dict, List

import numpy as np
import torch

logger = logging.getLogger("pose3d_tpu_torch.port")

# safetensors dtype names → torch dtypes
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a ``.safetensors`` file, each in its stored
    dtype on the CPU. Raises ValueError on a malformed header or a dtype
    outside ``_ST_DTYPES``."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    n = int.from_bytes(data[:8], "little")
    if n > len(data) - 8:
        raise ValueError(f"{path}: header length {n} exceeds the file")
    header = json.loads(data[8:8 + n])
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; "
                             f"read: {sorted(_ST_DTYPES)}")
        lo, hi = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if hi - lo != count * itemsize or hi > len(body):
            raise ValueError(f"{path}: {name} spans {hi - lo} bytes, its "
                             f"shape {shape} needs {count * itemsize}")
        # a copy of the bytes: aligned for the dtype and writable
        raw = bytearray(body[lo:hi])
        t = (torch.frombuffer(raw, dtype=dtype, count=count) if count
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape)
    return out


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; the card, asked for and absent,
    raises (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available (pass device='cpu')")
    return device


def _as_fp32(sd) -> Dict[str, torch.Tensor]:
    """Tensors only, fp32 on the CPU: a half-precision checkpoint must not
    leak half-precision parameters into the model (parameters are fp32)."""
    return {k: v.detach().float().cpu() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def load_torch_state_dict(path) -> Dict[str, torch.Tensor]:
    """A checkpoint file → ``{name: fp32 CPU tensor}``.

    ``.safetensors`` through :func:`read_safetensors`; otherwise
    ``torch.load`` with ``weights_only=True`` first and, when that fails or
    finds no tensors, a logged fallback to full unpickling, which runs code
    from the file: for trusted files only (prefer ``.safetensors``). A
    ``state_dict`` entry, or a ``model`` object with a ``state_dict()``, is
    taken in place of the top level."""
    path = str(path)
    if path.endswith(".safetensors"):
        return _as_fp32(read_safetensors(path))

    def _extract(obj):
        if isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
        if isinstance(obj, dict) and "model" in obj and hasattr(
                obj["model"], "state_dict"):
            obj = obj["model"].state_dict()
        return _as_fp32(obj) if isinstance(obj, dict) else {}

    try:
        sd = _extract(torch.load(path, map_location="cpu",
                                 weights_only=True))
        if sd:
            return sd
        logger.warning("no tensors under weights_only=True in %s", path)
    except Exception:
        logger.warning(
            "%s is not loadable with weights_only=True; falling back to "
            "unpickling (trusted-source file assumed — prefer "
            ".safetensors)", path)
    return _extract(torch.load(path, map_location="cpu", weights_only=False))


def _interpolate_pos_embed(pos: torch.Tensor, n_new: int) -> torch.Tensor:
    """Resize the grid part of a ``[1, 1+N, D]`` position embedding to
    ``1+n_new`` tokens (square grids), bicubic in cv2, as the JAX package
    does; the class token's row is kept."""
    import cv2

    n_old = pos.shape[1] - 1
    if n_old == n_new:
        return pos
    d = pos.shape[2]
    g_old = int(round(n_old ** 0.5))
    g_new = int(round(n_new ** 0.5))
    grid = pos[0, 1:].reshape(g_old, g_old, d).numpy().astype(np.float32)
    grid = cv2.resize(grid, (g_new, g_new), interpolation=cv2.INTER_CUBIC)
    return torch.cat([pos[:, :1],
                      torch.from_numpy(grid).reshape(1, g_new * g_new, d)],
                     dim=1)


def _inflate_patch_embed(weight: torch.Tensor, in_channels: int
                         ) -> torch.Tensor:
    """``[D, 3, P, P]`` patch conv → ``[D, in_channels, P, P]``: the first
    channels copied, each extra channel the mean over the original ones."""
    d, c_orig, p, _ = weight.shape
    if in_channels == c_orig:
        return weight
    out = torch.zeros((d, in_channels, p, p), dtype=weight.dtype)
    n = min(in_channels, c_orig)
    out[:, :n] = weight[:, :n]
    if in_channels > c_orig:
        out[:, c_orig:] = weight.mean(dim=1, keepdim=True)
    return out


def port_vit_backbone(torch_sd: Dict[str, torch.Tensor], depth: int,
                      in_channels: int = 4, num_patches: int = 1024,
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """A timm ViT state_dict → the state_dict of the lifter's
    ``vit_backbone`` (``cls_token``, ``pos_embed``, ``patch_embed.proj``,
    ``blocks.<i>.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``,
    ``norm``): timm's names and packed ``qkv`` rows are the port's, so the
    blocks copy over; the patch embedding is inflated to ``in_channels``
    and the position grid resized to ``num_patches``."""
    g = lambda k: torch_sd[prefix + k]  # noqa: E731
    out = {
        "cls_token": g("cls_token"),
        "pos_embed": _interpolate_pos_embed(g("pos_embed"), num_patches),
        "patch_embed.proj.weight": _inflate_patch_embed(
            g("patch_embed.proj.weight"), in_channels),
        "patch_embed.proj.bias": g("patch_embed.proj.bias"),
        "norm.weight": g("norm.weight"),
        "norm.bias": g("norm.bias"),
    }
    for i in range(depth):
        for name in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1",
                     "mlp.fc2"):
            for leaf in ("weight", "bias"):
                key = f"blocks.{i}.{name}.{leaf}"
                out[key] = g(key)
    return out


def fold_torch_path(key: str) -> List[str]:
    """torch module path → flax path segments: a numeric segment joins the
    one before it with ``_`` (``model.23.cv3.0.0.0`` →
    ``["model_23", "cv3_0_0_0"]``)."""
    out: List[str] = []
    for s in key.split("."):
        if s.isdigit() and out:
            out[-1] = out[-1] + "_" + s
        else:
            out.append(s)
    return out


_TRAILING_INDEX = re.compile(r"^(.*?)((?:_\d+)+)$")


def unfold_flax_path(segments) -> str:
    """The inverse of :func:`fold_torch_path`: ``["model_23",
    "cv3_0_0_0"]`` → ``model.23.cv3.0.0.0``. Only trailing ``_<digits>``
    groups split off, so ``fuse_image_with_low_res`` stays whole."""
    out = []
    for s in segments:
        m = _TRAILING_INDEX.match(s)
        if m and m.group(1):
            out.append(m.group(1))
            out.extend(m.group(2).lstrip("_").split("_"))
        else:
            out.append(s)
    return ".".join(out)

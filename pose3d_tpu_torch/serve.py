"""Serving: the inference closure, and the export of the lifter to one
self-contained program file (counterpart of ``pose3d_tpu/serve.py``).

Where the JAX package lowers the lifter to StableHLO with ``jax.export``,
the port traces it with ``torch.export``: the eval forward with the
weights carried inside the program, optionally with a symbolic batch
dimension, written as ``model.pt2`` beside a ``meta.json`` sidecar. The
artifact

  * loads with nothing but ``torch`` (``torch.export.load``) when it was
    exported with the plain attention (``attention_impl="reference"``, the
    CLI's ``--attention-backend xla``, the default);
  * holds the custom operator ``pose3d_torch::flash_attention_fwd`` when
    it was exported with the kernel (``attention_impl="auto"``,
    ``--attention-backend pallas``): loading it needs the operator
    registered, which importing this module does (through
    ``models.transformer``), as the JAX package's Pallas artifact runs on
    a TPU only; the sidecar's ``custom_ops`` names it;
  * keeps its weights on the device it was exported on;
  * with ``quantize="int8"`` carries every large kernel as int8 with fp32
    scales and dequantises them inside the program.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
from collections import OrderedDict
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from pose3d_tpu_torch.models.transformer import (
    MultiHeadAttention,
    TimmAttention,
)

logger = logging.getLogger("pose3d_tpu_torch.serve")

FORMAT = "pose3d_tpu_torch/export/v1"
_SIDECAR = "meta.json"
_PAYLOAD = "model.pt2"


def make_serving_fn(model: nn.Module):
    """``(image, depth, keypoints_2d)`` numpy arrays → joints [B, J, 3]
    numpy fp32, computed on the device of ``model``'s weights (a model, or
    the module of an exported program).

    The closure may run on any thread: it enters ``inference_mode`` and
    the model's CUDA device itself (both are thread-local), and the
    device→host copy of the result is the synchronisation point."""
    device = next(itertools.chain(model.parameters(), model.buffers())).device

    def fn(image, depth, keypoints_2d) -> np.ndarray:
        on_device = (torch.cuda.device(device) if device.type == "cuda"
                     else contextlib.nullcontext())
        with torch.inference_mode(), on_device:
            args = [torch.from_numpy(np.ascontiguousarray(a, np.float32))
                    .to(device) for a in (image, depth, keypoints_2d)]
            return model(*args).float().cpu().numpy()

    return fn


# -- weight-only int8 ---------------------------------------------------------

class Int8Weight(NamedTuple):
    """A weight-only int8 kernel: ``q.float() * scale`` rebuilds the fp32
    weight. ``q`` has the torch weight's shape; ``scale`` (fp32)
    broadcasts against it, one value per output channel of the flax
    kernel the weight stands for."""

    q: torch.Tensor
    scale: torch.Tensor


def _kernels(model: nn.Module):
    """(state_dict name, weight, heads) of every weight that is a ``kernel``
    leaf in the JAX package's variables: Linear and convolution weights,
    and the packed q/k/v projections (``heads`` set), which flax holds as
    three ``DenseGeneral`` kernels ``[D, H, hd]``."""
    packed = {}
    for name, mod in model.named_modules():
        prefix = name + "." if name else ""
        if isinstance(mod, MultiHeadAttention):
            packed[prefix + "in_proj_weight"] = mod.heads
        elif isinstance(mod, TimmAttention):
            packed[prefix + "qkv.weight"] = mod.heads
    for name, mod in model.named_modules():
        prefix = name + "." if name else ""
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            key = prefix + "weight"
            yield key, mod.weight, packed.get(key)
        elif isinstance(mod, MultiHeadAttention):
            key = prefix + "in_proj_weight"
            yield key, mod.in_proj_weight, packed[key]


def _quantize(w: torch.Tensor, heads: Optional[int]) -> Int8Weight:
    """Symmetric per-output-channel int8 over the flax kernel's layout:
    ``amax / 127`` (1 where the channel is all zero) and ``round`` half to
    even, as ``jnp.round``. A Linear or convolution weight ``[O, ...]`` has
    one scale per O. A packed ``[3·D, D]`` q/k/v weight (rows h·hd + j of
    each projection) stands for three ``[D, H, hd]`` kernels that JAX
    reduces over axes (0, 1): one scale per projection and within-head
    index j, shared by every head."""
    w = w.detach().float()
    if heads is None:
        amax = w.abs().amax(dim=tuple(range(1, w.dim())), keepdim=True)
    else:
        D = w.shape[1]
        hd = D // heads
        amax = w.view(3, heads, hd, D).abs().amax(dim=(1, 3), keepdim=True)
        amax = amax.expand(3, heads, hd, 1).reshape(3 * D, 1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return Int8Weight(q, scale)


def quantize_variables(model: nn.Module, min_size: int = 4096
                       ) -> "OrderedDict[str, object]":
    """Weight-only int8 PTQ of ``model``'s state_dict: every fp32 weight
    whose flax kernel has at least ``min_size`` elements (for a packed q/k/v
    weight, each of its three ``[D, D]`` kernels) becomes an
    :class:`Int8Weight`; biases, norms, embeddings and running statistics
    stay as they are. ``q`` and ``scale`` equal the JAX package's
    ``quantize_variables`` carried across to the torch layout."""
    out = OrderedDict((k, v.detach()) for k, v in model.state_dict().items())
    for name, w, heads in _kernels(model):
        size = w.numel() // (3 if heads else 1)
        if size >= min_size and w.dtype == torch.float32:
            out[name] = _quantize(w, heads)
    return out


def dequantize_variables(variables: Dict[str, object]
                         ) -> "OrderedDict[str, torch.Tensor]":
    """Inverse of :func:`quantize_variables` (lossy): fp32 weights from the
    :class:`Int8Weight` entries."""
    return OrderedDict(
        (k, v.q.float() * v.scale if isinstance(v, Int8Weight) else v)
        for k, v in variables.items())


class DequantizedLifter(nn.Module):
    """The lifter over ``variables`` (:func:`quantize_variables`): the int8
    weights and their scales are this module's buffers and are dequantised
    inside ``forward``, so a program exported from it carries them as int8
    (the JAX package's ``make_serving_fn`` over quantised variables)."""

    def __init__(self, model: nn.Module, variables: Dict[str, object]):
        super().__init__()
        self._model = [model]       # a list: not a submodule, its own
        self._slots = []            # weights do not enter the program
        for i, (name, v) in enumerate(variables.items()):
            key = f"w{i}_" + name.replace(".", "_")
            if isinstance(v, Int8Weight):
                self.register_buffer(key + "_q", v.q)
                self.register_buffer(key + "_scale", v.scale)
            else:
                self.register_buffer(key, v)
            self._slots.append((name, key, isinstance(v, Int8Weight)))

    def forward(self, image, depth, keypoints_2d):
        tensors = {
            name: (getattr(self, key + "_q").float()
                   * getattr(self, key + "_scale") if quant
                   else getattr(self, key))
            for name, key, quant in self._slots}
        return torch.func.functional_call(
            self._model[0], tensors, (image, depth, keypoints_2d))


# -- export ---------------------------------------------------------------------

def export_lifter(model: nn.Module, batch_size: Optional[int] = None,
                  quantize: Optional[str] = None, min_size: int = 4096
                  ) -> torch.export.ExportedProgram:
    """Trace ``model``'s eval forward (image ``[b, H, W, 3]``, depth
    ``[b, H, W, 1]``, keypoints ``[b, J, 2]``, fp32, on the model's device)
    into a ``torch.export.ExportedProgram`` that holds the weights.

    ``batch_size=None`` gives a symbolic batch: one program takes any
    batch. It is traced at a batch of 2, since PyTorch specialises a
    dimension traced at size 1. ``quantize="int8"`` carries the kernels of
    at least ``min_size`` elements as int8 (:func:`quantize_variables`)."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if model.training:
        raise ValueError("export_lifter: the model must be in eval mode")
    cfg = model.config
    h, w = cfg.image_size
    device = next(model.parameters()).device
    n = batch_size or 2
    args = (torch.zeros(n, h, w, 3, device=device),
            torch.ones(n, h, w, 1, device=device),
            torch.full((n, cfg.num_joints, 2), 0.5, device=device))
    module = (DequantizedLifter(model, quantize_variables(model, min_size))
              if quantize else model)
    dynamic = None
    if batch_size is None:
        b = torch.export.Dim("batch", min=1)
        dynamic = ({0: b}, {0: b}, {0: b})
    with torch.no_grad():
        return torch.export.export(module, args, dynamic_shapes=dynamic)


def _avals(nodes) -> list:
    """``dtype[d0,d1,...]`` of each node's value, symbolic sizes by name."""
    out = []
    for node in nodes:
        v = node.meta["val"]
        dims = ",".join(str(d) for d in v.shape)
        out.append(f"{str(v.dtype).removeprefix('torch.')}[{dims}]")
    return out


def custom_ops(exported: torch.export.ExportedProgram) -> list:
    """The custom operators (outside ``aten`` and ``prims``) the program's
    graph calls, as ``namespace::name``."""
    ops = set()
    for node in exported.graph.nodes:
        t = node.target
        if node.op == "call_function" and isinstance(
                t, torch._ops.OpOverload) and t.namespace not in (
                    "aten", "prims"):
            ops.add(t.name())
    return sorted(ops)


def save_exported(exported: torch.export.ExportedProgram, path,
                  extra_meta: Optional[dict] = None) -> Path:
    """Write ``<path>/model.pt2`` and the ``meta.json`` sidecar: the JAX
    sidecar's keys (``format`` this package's own, ``platforms`` the device
    type the weights are on) and ``custom_ops``, the operators of this
    package the program calls (empty for a program of plain operators)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    payload = path / _PAYLOAD
    torch.export.save(exported, payload)
    user = [n for n in exported.graph.nodes if n.op == "placeholder"
            and n.name in exported.graph_signature.user_inputs]
    out_node = next(n for n in exported.graph.nodes if n.op == "output")
    ops = custom_ops(exported)
    devices = sorted({t.device.type for t in itertools.chain(
        exported.state_dict.values(), exported.constants.values())
        if isinstance(t, torch.Tensor)})
    meta = {
        "format": FORMAT,
        "fn_name": "forward",
        "platforms": devices,
        "inputs": _avals(user),
        "outputs": _avals(out_node.args[0]),
        "payload_bytes": payload.stat().st_size,
        "custom_ops": ops,
        "framework": f"torch {torch.__version__}",
    }
    meta.update(extra_meta or {})
    (path / _SIDECAR).write_text(json.dumps(meta, indent=2))
    logger.info("Exported %s (%.1f MB) for %s", path,
                meta["payload_bytes"] / 1e6, meta["platforms"])
    return path


def load_exported_meta(path) -> dict:
    return json.loads((Path(path) / _SIDECAR).read_text())


def load_exported(path) -> torch.export.ExportedProgram:
    """Load an artifact directory (or a bare ``model.pt2``); its
    ``.module()(image, depth, keypoints_2d)`` runs the lifter."""
    path = Path(path)
    if path.is_dir():
        path = path / _PAYLOAD
    return torch.export.load(path)

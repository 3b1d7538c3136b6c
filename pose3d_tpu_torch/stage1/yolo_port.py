"""ultralytics YOLO11-pose checkpoints → :class:`YOLO11Pose` (counterpart
of ``pose3d_tpu/stage1/yolo_port.py``).

The port's module paths are the checkpoint's, so loading is a strict
``load_state_dict`` after two kinds of keys are dropped: BatchNorm's
``num_batches_tracked`` and the DFL's fixed ``arange(16)`` convolution
(:func:`decode_pose` computes the expectation itself; a checkpoint whose
DFL weights are not that arange is logged).

ultralytics ``.pt`` files pickle whole ``DetectionModel`` objects, so
unpickling them normally needs the ultralytics package. When it is absent,
:func:`load_ultralytics_state_dict` puts stub modules in place of every
``ultralytics.*`` import for the duration of the load: unpickling restores
each object's ``__dict__`` without calling ``__init__``, and
``nn.Module.state_dict`` needs only ``_modules``, ``_parameters`` and
``_buffers``. That unpickling runs code from the file: load weights from
trusted sources only, or convert them to ``.safetensors`` first. Plain
state_dict ``.pt`` files and ``.safetensors`` exports load directly.
"""

from __future__ import annotations

import importlib.abc
import importlib.machinery
import logging
import sys
import types
from typing import Dict, Tuple

import torch

from pose3d_tpu_torch.stage1.port import read_safetensors, resolve_device
from pose3d_tpu_torch.stage1.yolo11 import YOLO11Pose, cast_for_inference

logger = logging.getLogger("pose3d_tpu_torch.stage1.yolo_port")


class _StubModule(types.ModuleType):
    """A module that makes ``torch.nn.Module`` subclasses on attribute
    access, so that pickled ultralytics class references resolve."""

    def __getattr__(self, name):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        cls = type(name, (torch.nn.Module,), {"__module__": self.__name__})
        setattr(self, name, cls)
        return cls


class _StubFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def __init__(self, prefixes=("ultralytics",)):
        self.prefixes = prefixes

    def find_spec(self, fullname, path=None, target=None):
        if any(fullname == p or fullname.startswith(p + ".")
               for p in self.prefixes):
            if fullname in sys.modules:
                return None
            return importlib.machinery.ModuleSpec(fullname, self)
        return None

    def create_module(self, spec):
        return _StubModule(spec.name)

    def exec_module(self, module):  # nothing to execute
        module.__path__ = []  # a package, so that submodules import


def _strip(key: str) -> str:
    for p in ("module.", "ema."):
        if key.startswith(p):
            key = key[len(p):]
    return key


def _extract_state_dict(obj) -> Dict[str, torch.Tensor]:
    if isinstance(obj, dict) and "model" in obj and hasattr(
            obj["model"], "state_dict"):
        obj = obj["model"].state_dict()
    elif isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    elif hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if not isinstance(obj, dict):
        return {}
    return {_strip(k): v.detach().float().cpu() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def load_ultralytics_state_dict(path) -> Dict[str, torch.Tensor]:
    """A YOLO checkpoint → ``{torch key: fp32 CPU tensor}``: an
    ultralytics-pickled ``.pt`` (``{"model": DetectionModel, ...}``), a
    bare or nested state_dict ``.pt`` / ``.pth``, or ``.safetensors``.
    ``module.`` and ``ema.`` prefixes are stripped."""
    path = str(path)
    if path.endswith(".safetensors"):
        return {_strip(k): v.float()
                for k, v in read_safetensors(path).items()}
    try:
        sd = _extract_state_dict(torch.load(path, map_location="cpu",
                                            weights_only=True))
        if sd:
            return sd
        logger.warning("no tensors under weights_only=True in %s", path)
    except Exception:
        logger.warning(
            "%s is not loadable with weights_only=True; falling back to "
            "unpickling (trusted-source .pt assumed — prefer .safetensors)",
            path)
    finder = _StubFinder()
    sys.meta_path.insert(0, finder)
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    finally:
        sys.meta_path.remove(finder)
        for name in [m for m in sys.modules
                     if isinstance(sys.modules[m], _StubModule)]:
            del sys.modules[name]
    return _extract_state_dict(obj)


def infer_architecture(sd: Dict[str, torch.Tensor]) -> Tuple[str, int, Tuple]:
    """(scale, nc, kpt_shape) from the checkpoint's tensor shapes."""
    w0 = sd["model.0.conv.weight"].shape[0]
    if w0 == 16:
        scale = "n"
    elif w0 == 32:
        scale = "s"
    elif w0 == 96:
        scale = "x"
    elif w0 == 64:
        # m and l share widths; l (depth 1.0) has a second C3k2 module
        scale = "l" if any(k.startswith("model.2.m.1.") for k in sd) else "m"
    else:
        raise ValueError(f"unrecognized YOLO11 width: stem={w0}")
    nc = sd["model.23.cv3.0.2.weight"].shape[0]
    nk = sd["model.23.cv4.0.2.weight"].shape[0]
    if nk % 3 == 0:
        kpt_shape = (nk // 3, 3)
    elif nk % 2 == 0:
        kpt_shape = (nk // 2, 2)
    else:
        raise ValueError(f"cannot factor keypoint channels {nk}")
    return scale, nc, kpt_shape


def model_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The checkpoint's keys that the port's module holds: without
    ``num_batches_tracked`` and the DFL convolution, whose weights are
    checked against ``arange`` first."""
    out = {}
    for key, val in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        if ".dfl." in key:
            if key.endswith("weight") and not torch.allclose(
                    val.reshape(-1), torch.arange(val.numel(),
                                                  dtype=torch.float32)):
                logger.warning("checkpoint DFL weights differ from arange "
                               "— decode assumes the standard fixed DFL")
            continue
        out[key] = val
    return out


def load_yolo11_pose(path, dtype: torch.dtype = torch.float32,
                     device="cuda") -> YOLO11Pose:
    """Load a YOLO11-pose checkpoint → the module on ``device`` in eval
    mode, its weights in ``dtype`` (the heads' last convolutions fp32),
    its attention the plain version (``set_attention_backend`` switches
    it). ``device`` defaults to the card and raises without CUDA unless
    the caller asks for the CPU."""
    device = resolve_device(device)
    sd = load_ultralytics_state_dict(path)
    scale, nc, kpt_shape = infer_architecture(sd)
    logger.info("loading YOLO11%s-pose: nc=%d kpt_shape=%s", scale, nc,
                kpt_shape)
    with torch.device("meta"):      # no init: every tensor is loaded
        model = YOLO11Pose(scale, nc, kpt_shape)
    model.load_state_dict(model_state_dict(sd), strict=True, assign=True)
    return cast_for_inference(model, dtype).to(device)

"""Loading the lifter from either checkpoint form, and the
reference-schema ``.pth`` (counterpart of the loaders in
``pose3d_tpu/cli/infer.py`` and ``pose3d_tpu/cli/convert.py``).

:func:`load_pose_model` reads a training checkpoint directory of the port
(:mod:`pose3d_tpu_torch.train.checkpoint`, optionally its EMA weights) or
a ``.pth`` in the reference project's schema:
``{"model_state_dict", "model_type", "model_args", ...}``, the form
``pose3d-convert --to-torch`` writes. A bare state_dict and ``module.``
(DDP) key prefixes are accepted too, as the reference's own loader does.
Where the file does not name its ``model_type``, the caller's hint
(``model_type=``, the CLIs' ``--model-type``) names it, else "cnn", the
reference's default model, as the JAX package's ``convert`` has it.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Tuple

import torch
from torch import nn

from pose3d_tpu_torch.core.config import make_model_config
from pose3d_tpu_torch.models.factory import build_model

logger = logging.getLogger("pose3d_tpu_torch")


def _read(path, model_type=None) -> Tuple[dict, str, dict]:
    """→ (state_dict, model_type, model_args); raises ValueError with the
    reason when the file is not a checkpoint this loader reads.
    ``model_type`` is the hint for a file that does not name its own."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"checkpoint not found: {path}")
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # torch raises several types for a bad file
        raise ValueError(
            f"cannot read {path} as a weights-only torch checkpoint "
            f"({type(e).__name__}: {e}). Reference model_args may hold "
            "non-tensor objects: re-export it with pose3d-convert --to-torch"
        ) from e
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: expected a dict checkpoint, got "
                         f"{type(ckpt).__name__}")
    if "model_state_dict" in ckpt:
        sd = ckpt["model_state_dict"]
        model_type = ckpt.get("model_type", model_type or "cnn")
        model_args = dict(ckpt.get("model_args") or {})
    elif ckpt and all(isinstance(v, torch.Tensor) for v in ckpt.values()):
        sd, model_type, model_args = ckpt, model_type or "cnn", {}
    else:
        raise ValueError(
            f"{path}: neither a reference checkpoint (no 'model_state_dict') "
            "nor a bare state_dict"
        )
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    return sd, model_type, model_args


def load_pose_model(path, device="cuda", *, dtype=torch.bfloat16,
                    model_type=None, ema: bool = False,
                    **build_kw) -> Tuple[nn.Module, object]:
    """Rebuild the architecture and strict-load its weights, and for the
    CNN its BatchNorm running statistics, onto ``device`` (``build_kw``:
    further keywords of ``build_model``). Returns (model, config).

    ``path`` is a training checkpoint directory of the port (``ema``: its
    EMA parameters and, where it averaged them, BatchNorm statistics; see
    :func:`pose3d_tpu_torch.train.state.ema_slots`) or a ``.pth`` whose
    architecture ("transformer" or "cnn") is its ``model_type``, else the
    ``model_type`` hint, else "cnn", built from its ``model_args``. As in
    the JAX package's loader, ``ema`` exits for a checkpoint without EMA
    weights."""
    if Path(path).is_dir():
        return _load_dir(Path(path), device, dtype, ema, build_kw)
    if ema:
        raise SystemExit("--ema needs a training checkpoint directory; a "
                         ".pth holds one set of weights")
    sd, model_type, model_args = _read(path, model_type)
    cfg = make_model_config(model_type, **model_args)
    model = build_model(cfg, device=device, dtype=dtype, **build_kw)
    try:
        model.load_state_dict(sd, strict=True)
    except RuntimeError as e:
        raise ValueError(f"{path}: weights do not fit the "
                         f"{model_type} described by model_args: {e}") from e
    return model, cfg


def _load_dir(path: Path, device, dtype, ema: bool, build_kw):
    from pose3d_tpu_torch.train.checkpoint import load_checkpoint
    from pose3d_tpu_torch.train.state import ema_slots

    tree, meta = load_checkpoint(path)
    if ema and "ema_params" not in tree:
        raise SystemExit(f"--ema: checkpoint {path} carries no EMA weights "
                         "(train with --ema-decay to record them)")
    cfg = make_model_config(meta["model_type"], **meta.get("model_args", {}))
    model = build_model(cfg, device=device, dtype=dtype, **build_kw)
    model.load_state_dict(tree["model"], strict=True)
    if ema:
        with torch.no_grad():
            for t, e in ema_slots(model, tree["ema_params"],
                                  tree.get("ema_batch_stats"),
                                  stacklevel=3).values():
                t.copy_(e)
        logger.info("Using EMA weights")
    return model, cfg


def checkpoint_step(path) -> int:
    """The step either checkpoint form records (0 for a bare state_dict);
    a ``.pth`` is memory-mapped, no tensor is read."""
    path = Path(path)
    if path.is_dir():
        from pose3d_tpu_torch.train.checkpoint import load_checkpoint_meta

        return int(load_checkpoint_meta(path).get("step", 0))
    ckpt = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return int(ckpt.get("step", 0)) if "model_state_dict" in ckpt else 0


def save_pose_model(model: nn.Module, path, step: int = 0, cfg=None) -> str:
    """Write ``model`` (either lifter) in the reference schema (CPU
    tensors); ``cfg`` defaults to the model's own config."""
    cfg = cfg or model.config
    model_args = cfg.to_dict()
    model_type = model_args.pop("model_type")
    torch.save({
        "step": step,
        "global_step": step,
        "model_state_dict": {k: v.detach().cpu()
                             for k, v in model.state_dict().items()},
        "model_args": model_args,
        "model_type": model_type,
    }, path)
    return str(path)

"""The system under test as the benchmark builds it: the port's lifter
from a configuration file, on the device, without weights (the benchmark
fills them), and what a result line says of the device."""

from __future__ import annotations

from typing import List, Tuple


def reference_config(cfg: dict) -> dict:
    """The configuration as the reference and the work counters read it:
    the model's arguments and the architecture's published constants the
    program keeps in code (the pyramid's dilations)."""
    return {**cfg["model_args"], **cfg.get("architecture", {})}


def build(cfg: dict, device, train: bool):
    """(model, compute dtype): the lifter of ``cfg`` with uninitialised
    fp32 parameters on ``device``, in train or eval mode."""
    import torch

    from pose3d_tpu_torch.core.config import make_model_config
    from pose3d_tpu_torch.models import (
        CNNPoseEstimation,
        TransformerPoseEstimation,
    )

    dtype = getattr(torch, cfg["precision"]["compute"])
    mcfg = make_model_config(**cfg["model_args"])
    cls = (CNNPoseEstimation if mcfg.model_type == "cnn"
           else TransformerPoseEstimation)
    with torch.device("meta"):
        model = cls(mcfg, dtype=dtype)
    model = model.to_empty(device=device)
    return model.train(train).requires_grad_(train), dtype


def leaves(model) -> List[Tuple[str, tuple, object]]:
    """(name, shape, dtype) of every entry of the model's state_dict."""
    return [(n, tuple(t.shape), t.dtype)
            for n, t in model.state_dict().items()]


def device_info(device, peak_bytes: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak_bytes}

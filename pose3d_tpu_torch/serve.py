"""Inference closure for serving (counterpart of
``pose3d_tpu/serve.py::make_serving_fn``; StableHLO export and int8 PTQ
are not ported yet)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn


def make_serving_fn(model: nn.Module):
    """``(image, depth, keypoints_2d)`` numpy arrays → joints [B, J, 3]
    numpy fp32, computed on the model's device.

    The closure may run on any thread: it enters ``inference_mode`` and
    the model's CUDA device itself (both are thread-local), and the
    device→host copy of the result is the synchronisation point."""
    device = next(model.parameters()).device

    def fn(image, depth, keypoints_2d) -> np.ndarray:
        on_device = (torch.cuda.device(device) if device.type == "cuda"
                     else contextlib.nullcontext())
        with torch.inference_mode(), on_device:
            args = [torch.from_numpy(np.ascontiguousarray(a, np.float32))
                    .to(device) for a in (image, depth, keypoints_2d)]
            return model(*args).cpu().numpy()

    return fn

"""TensorBoard writer (counterpart of ``pose3d_tpu/train/tb.py``): scalars,
images and text over ``torch.utils.tensorboard``, or ``tensorboardX``
where that is what is installed. The package is imported when a writer is
made, never at import time; with neither installed, making a
``SummaryWriter`` raises and says so (``NullWriter`` is the explicit way
to log nothing)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


class SummaryWriter:
    def __init__(self, log_dir):
        try:
            from torch.utils.tensorboard import SummaryWriter as _Writer
        except ImportError as e:
            try:
                from tensorboardX import SummaryWriter as _Writer
            except ImportError:
                raise ImportError(
                    "TensorBoard logging needs the tensorboard package "
                    "(torch.utils.tensorboard) or tensorboardX, and neither "
                    f"imports ({e}); run without TensorBoard "
                    "(--no-tensorboard, or NullWriter)") from e
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        self._writer = _Writer(str(log_dir))

    def add_scalar(self, tag: str, value, step: int):
        self._writer.add_scalar(tag, float(value), int(step))

    def add_image(self, tag: str, image_hwc: np.ndarray, step: int):
        """image_hwc: [H, W, C] uint8, or float in [0, 1]."""
        img = np.asarray(image_hwc)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        self._writer.add_image(tag, img, int(step), dataformats="HWC")

    def add_text(self, tag: str, text: str, step: int = 0):
        self._writer.add_text(tag, text, int(step))

    def flush(self):
        self._writer.flush()

    def close(self):
        self._writer.close()


class NullWriter:
    """Writer with the ``SummaryWriter`` interface that records nothing."""

    def add_scalar(self, *a, **k):
        pass

    def add_image(self, *a, **k):
        pass

    def add_text(self, *a, **k):
        pass

    def flush(self):
        pass

    def close(self):
        pass

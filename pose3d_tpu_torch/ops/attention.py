"""Multi-head attention core (counterpart of ``pose3d_tpu/ops/attention.py``).

``impl="auto"`` sends a CUDA tensor to the hand-written kernel and a CPU
tensor to its plain version; it never silently degrades a CUDA tensor to
the plain path. ``impl="reference"`` forces the plain version on any device
(the on-card comparison in ``chip_smoke.py``); no serving path sets it.
"""

from __future__ import annotations

import torch

from pose3d_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_fwd,
    flash_attention_fwd_reference,
)

IMPLS = ("auto", "reference")


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, impl: str = "auto") -> torch.Tensor:
    """Attention over [B, T, H, D] tensors (heads on axis 2); returns
    [B, Tq, H, D] in the input dtype, with the softmax in fp32."""
    if impl == "reference" or (impl == "auto" and q.device.type == "cpu"):
        return flash_attention_fwd_reference(q, k, v)[0]
    if impl != "auto":
        raise ValueError(f"attention impl {impl!r} not in {IMPLS}")
    return flash_attention_fwd(q, k, v)[0]

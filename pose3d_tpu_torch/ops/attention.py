"""Multi-head attention core (counterpart of ``pose3d_tpu/ops/attention.py``).

Every call goes through the autograd Function
:class:`~pose3d_tpu_torch.ops.kernels.flash_attention.FlashAttention`, so
the output is differentiable on every device. ``impl="auto"`` sends a CUDA
tensor to the hand-written forward and backward kernels and a CPU tensor to
their plain versions, the forward through the custom operator
``pose3d_torch::flash_attention_fwd`` on either device (an exported program
holds the operator); it never silently degrades a CUDA tensor to the plain
path. ``impl="reference"`` forces the plain pair on any device (the on-card
comparisons in ``chip_smoke.py``, and the ``xla`` attention backend of the
CLIs, whose exported programs hold plain tensor operations only).
"""

from __future__ import annotations

import torch

from pose3d_tpu_torch.ops.kernels.flash_attention import FlashAttention

IMPLS = ("auto", "reference")


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, impl: str = "auto") -> torch.Tensor:
    """Attention over [B, T, H, D] tensors (heads on axis 2); returns
    [B, Tq, H, D] in the input dtype, with the softmax in fp32."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r} not in {IMPLS}")
    return FlashAttention.apply(q, k, v, impl == "auto")

"""pose3d_tpu_torch kernels on an NVIDIA card, against their plain
versions, and gradients through them. They skip without CUDA. This file imports no JAX, so it also runs
on a machine without it:

    python -m pytest tests/test_torch_port_card.py -m cuda --noconftest
"""

import pytest
import torch

from pose3d_tpu_torch.core.config import TransformerModelConfig
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.ops.attention import dot_product_attention
from pose3d_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)

# (B, Tq, Tk, H, D): the full-width lifter's attentions and ragged edges
SHAPES = [
    (2, 1025, 1025, 12, 64),
    (2, 1024, 16, 16, 48),
    (2, 16, 1024, 16, 48),
    (2, 1041, 1041, 16, 48),
    (1, 1, 1, 2, 64),
    (2, 17, 130, 3, 32),
    (1, 130, 17, 2, 128),
]
# bf16: o is rounded to bf16 and P to bf16 against a running row max;
# fp32: summation order only
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel is CUDA-only)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_matches_plain_version(dtype):
    _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, Tq, Tk, H, D in SHAPES:
        q = torch.randn(B, Tq, H, D, generator=g, device="cuda").to(dt)
        k = torch.randn(B, Tk, H, D, generator=g, device="cuda").to(dt)
        v = torch.randn(B, Tk, H, D, generator=g, device="cuda").to(dt)
        before = flash_attention_fwd.launches
        o, lse = flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        assert flash_attention_fwd.launches == before + 1
        ro, rlse = flash_attention_fwd_reference(q, k, v)
        assert o.shape == ro.shape and lse.shape == (B, H, Tq)
        assert o.dtype == dt and lse.dtype == torch.float32
        assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
        assert (lse - rlse).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_flash_attention_reads_strided_views():
    """q/k/v as the model hands them over: views of one [B,T,3,H,hd]
    projection, read in place; and an unaligned view, which is copied."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(2, 130, 3, 4, 48, generator=g, device="cuda")
    q, k, v = qkv.bfloat16().unbind(2)
    o, lse = flash_attention_fwd(q, k, v)
    ro, rlse = flash_attention_fwd_reference(q, k, v)
    assert (o.float() - ro.float()).abs().max().item() <= TOL["bfloat16"]
    x = torch.randn(2, 33, 2, 65, generator=g, device="cuda")[..., 1:]
    o, _ = flash_attention_fwd(x, x, x)
    ro, _ = flash_attention_fwd_reference(x, x, x)
    assert (o - ro).abs().max().item() <= TOL["float32"]


@pytest.mark.cuda
def test_auto_attention_on_cuda_runs_the_kernel():
    _cuda()
    q = torch.randn(1, 20, 2, 64, device="cuda", dtype=torch.bfloat16)
    before = flash_attention_fwd.launches
    dot_product_attention(q, q, q)
    assert flash_attention_fwd.launches == before + 1
    dot_product_attention(q, q, q, impl="reference")
    assert flash_attention_fwd.launches == before + 1
    with pytest.raises(ValueError, match="head dim"):
        dot_product_attention(q[..., :40], q[..., :40], q[..., :40])


# backward: max |Δ| relative to max(1, max|ref|); bf16 rounds P and dS
# before their products, fp32 differs by summation order (dQ atomics)
TOL_GRAD = {"bfloat16": 3e-2, "float32": 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_backward_matches_plain_version(dtype):
    _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(2)
    for B, Tq, Tk, H, D in SHAPES:
        q, do = (torch.randn(B, Tq, H, D, generator=g, device="cuda").to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, Tk, H, D, generator=g, device="cuda").to(dt)
                for _ in range(2))
        o, lse = flash_attention_fwd(q, k, v)
        before = flash_attention_bwd.launches
        got = flash_attention_bwd(q, k, v, o, do, lse)
        torch.cuda.synchronize()
        assert flash_attention_bwd.launches == before + 1
        for x, r in zip(got, flash_attention_bwd_reference(q, k, v, o, do,
                                                           lse)):
            assert x.shape == r.shape and x.dtype == dt
            scale = max(1.0, r.float().abs().max().item())
            assert (x.float() - r.float()).abs().max().item() \
                <= TOL_GRAD[dtype] * scale


@pytest.mark.cuda
def test_cuda_backward_reaches_the_patch_embedding():
    """The repaired fault: a loss.backward() on the card gives gradients
    to everything upstream of the attention kernels, down to the ViT's
    patch embedding, and they agree with the plain pair's."""
    _cuda()
    # width 128 over 4 heads: head dim 32, the smallest the kernels take
    cfg = TransformerModelConfig(
        image_size=(64, 64), heatmap_size=32, transformer_embed_dim=128,
        transformer_heads=4, vit_depth=2, vit_heads=4, final_encoder_depth=1,
        num_cross_modal_layers=1, regression_hidden_dims=(32, 16),
        transformer_dropout_rate=0.0, regression_dropout=0.0)
    g = torch.Generator(device="cuda").manual_seed(3)
    args = (torch.rand(2, 64, 64, 3, generator=g, device="cuda"),
            torch.rand(2, 64, 64, 1, generator=g, device="cuda"),
            torch.rand(2, 17, 2, generator=g, device="cuda"))
    grads = {}
    for impl in ("auto", "reference"):
        model = build_model(cfg, device="cuda", dtype=torch.float32,
                            attention_impl=impl, train=True)
        before = flash_attention_bwd.launches
        model(*args).square().sum().backward()
        launched = flash_attention_bwd.launches - before
        assert launched == (5 if impl == "auto" else 0)  # 2 ViT, 2 fusion, 1 final
        grads[impl] = model.vit_backbone.patch_embed.proj.weight.grad
    assert grads["auto"] is not None and grads["auto"].abs().sum() > 0
    assert torch.allclose(grads["auto"], grads["reference"], rtol=1e-3,
                          atol=1e-5)

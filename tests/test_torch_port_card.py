"""pose3d_tpu_torch kernels on an NVIDIA card, against their plain
versions, gradients through them, and the device augmentor on them. They skip without CUDA. This file imports no JAX, so it also runs
on a machine without it:

    python -m pytest tests/test_torch_port_card.py -m cuda --noconftest
"""

import pytest
import torch

from pose3d_tpu_torch.core.config import CNNModelConfig, TransformerModelConfig
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.ops import augment_device
from pose3d_tpu_torch.ops.attention import dot_product_attention
from pose3d_tpu_torch.ops.kernels.bn_stats import (
    BnStats,
    bn_stats,
    bn_stats_reference,
)
from pose3d_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
from pose3d_tpu_torch.ops.kernels import bn_stats as bn
from pose3d_tpu_torch.ops.kernels import flash_attention as fa
from pose3d_tpu_torch.ops.kernels.lane_resample import (
    lane_resample,
    lane_resample_reference,
)
from pose3d_tpu_torch.ops.kernels import layer_norm as ln
from pose3d_tpu_torch.ops.kernels import mlp_block as mb

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
    torch.backends.cudnn.allow_tf32 = False


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
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("T,H,D", [(130, 2, 48), (130, 2, 64), (257, 4, 48),
                                   (17, 4, 16)])
def test_backward_rows_of_very_negative_scores(T, H, D, dtype):
    """Every score about -110, so each row's lse is below -100 (rows a
    trained lifter gives some tokens): the backward's dq, dk, dv stay finite
    and match the plain version. Keys past Tk, zero rows in the last block,
    once gave the wgmma backward P = exp2(-lse·log2 e) = inf and NaN in
    dQ."""
    _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(T + D)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    e = rnd(1, 1, H, D)
    e = e / e.norm(dim=-1, keepdim=True)
    c = (110.0 * D ** 0.5) ** 0.5
    q = (c * e + 0.05 * rnd(2, T, H, D)).to(dt)
    k = (-c * e + 0.05 * rnd(2, T, H, D)).to(dt)
    v, do = rnd(2, T, H, D).to(dt), rnd(2, T, H, D).to(dt)
    o, lse = flash_attention_fwd(q, k, v)
    assert lse.max().item() < -100
    got = flash_attention_bwd(q, k, v, o, do, lse)
    want = flash_attention_bwd_reference(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    for x, r in zip(got, want):
        assert torch.isfinite(x).all()
        tol = (3e-2 if dtype == "bfloat16" else 1e-4) * max(
            1.0, r.float().abs().max().item())
        assert (x.float() - r.float()).abs().max().item() <= tol


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


# (B, Tq, Tk, H, D, Dv) off the built pairs: run on the smallest built pair
# that holds them (padded_pair), the widest (256, 256) among them
PADDED_SHAPES = [(2, 70, 33, 4, 96, 96), (1, 33, 70, 2, 200, 200),
                 (2, 65, 129, 2, 48, 96), (2, 17, 17, 4, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_takes_every_depth_up_to_256(dtype):
    """Depths off the built pairs, against the plain pair at the true
    depths: one launch of each kernel a call, o, lse, dk, dv bitwise on a
    repeat; past 256 (once refused) D = Dv = 264 runs on the deep
    instance, one launch, against the plain version."""
    _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(16)
    for B, Tq, Tk, H, D, Dv in PADDED_SHAPES:
        q = torch.randn(B, Tq, H, D, generator=g, device="cuda").to(dt)
        k = torch.randn(B, Tk, H, D, generator=g, device="cuda").to(dt)
        v = torch.randn(B, Tk, H, Dv, generator=g, device="cuda").to(dt)
        dy = torch.randn(B, Tq, H, Dv, generator=g, device="cuda").to(dt)
        before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
        o, lse = flash_attention_fwd(q, k, v)
        grads = flash_attention_bwd(q, k, v, o, dy, lse)
        torch.cuda.synchronize()
        assert (flash_attention_fwd.launches, flash_attention_bwd.launches) \
            == (before[0] + 1, before[1] + 1)
        ro, rlse = flash_attention_fwd_reference(q, k, v)
        assert o.shape == (B, Tq, H, Dv) and o.dtype == dt
        assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
        assert (lse - rlse).abs().max().item() <= 1e-3
        assert torch.equal(o, flash_attention_fwd(q, k, v)[0])
        again = flash_attention_bwd(q, k, v, o, dy, lse)
        refs = flash_attention_bwd_reference(q, k, v, o, dy, lse)
        for x, y, r in zip(grads, again, refs):
            assert x.shape == r.shape
            tol = 1.5 * TOL[dtype] * max(1.0, r.float().abs().max().item())
            assert (x.float() - r.float()).abs().max().item() <= tol
        assert torch.equal(grads[1], again[1]) and torch.equal(grads[2],
                                                               again[2])
    deep = torch.randn(1, 4, 1, 264, generator=g, device="cuda").to(dt)
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(deep, deep, deep)
    assert flash_attention_fwd.launches == before + 1
    ro, rlse = flash_attention_fwd_reference(deep, deep, deep)
    assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
    assert (lse - rlse).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_transformer_heads_8_backward_reaches_the_patch_embedding():
    """A lifter whose fusion and final blocks run head depth 8 (embed 64
    over 8 heads: off the built pairs, padded to (16, 16)) trains through
    the kernels on the card: 3 backward launches (2 fusion, 1 final), the
    patch embedding's gradient as the plain pair's."""
    _cuda()
    cfg = TransformerModelConfig(
        image_size=(64, 64), heatmap_size=32, transformer_embed_dim=64,
        transformer_heads=8, vit_depth=1, vit_heads=4, final_encoder_depth=1,
        num_cross_modal_layers=1, regression_hidden_dims=(32, 16),
        transformer_dropout_rate=0.0, regression_dropout=0.0)
    g = torch.Generator(device="cuda").manual_seed(8)
    args = (torch.rand(2, 64, 64, 3, generator=g, device="cuda"),
            torch.rand(2, 64, 64, 1, generator=g, device="cuda"),
            torch.rand(2, 17, 2, generator=g, device="cuda"))
    grads = {}
    for impl in ("auto", "reference"):
        model = build_model(cfg, device="cuda", dtype=torch.float32,
                            attention_impl=impl, train=True,
                            generator=torch.Generator("cuda").manual_seed(0))
        before = flash_attention_bwd.launches
        model(*args).square().sum().backward()
        launched = flash_attention_bwd.launches - before
        assert launched == (4 if impl == "auto" else 0)  # + 1 ViT block
        grads[impl] = model.vit_backbone.patch_embed.proj.weight.grad
    assert grads["auto"] is not None and grads["auto"].abs().sum() > 0
    assert torch.allclose(grads["auto"], grads["reference"], rtol=1e-3,
                          atol=1e-5)


# (B, Tq, Tk, H, D, Dv) past depth 256: the deep instance (D and Dv padded
# to multiples of 64, o's columns in slices of 128)
DEEP_SHAPES = [(2, 130, 67, 2, 384, 384), (1, 67, 130, 1, 768, 768),
               (2, 65, 33, 2, 384, 768), (2, 70, 33, 2, 300, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_deep_instance_matches_plain_version(dtype):
    """Depths past 256 against the plain pair at the true depths: one
    launch of each kernel a call, the plan the library reports equal to
    ``launch_config``'s, o, lse, dk, dv bitwise on a repeat (every slice
    computes the same P)."""
    _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(19)
    for B, Tq, Tk, H, D, Dv in DEEP_SHAPES:
        Dp, Dvp = fa.padded_pair(D, Dv)
        assert fa.is_deep(Dp, Dvp)
        assert fa.library_config(B, Tq, Tk, H, Dp, Dvp, dt.itemsize) \
            == fa.launch_config(B, Tq, Tk, H, Dp, Dvp, dt.itemsize)
        q = torch.randn(B, Tq, H, D, generator=g, device="cuda").to(dt)
        k = torch.randn(B, Tk, H, D, generator=g, device="cuda").to(dt)
        v = torch.randn(B, Tk, H, Dv, generator=g, device="cuda").to(dt)
        dy = torch.randn(B, Tq, H, Dv, generator=g, device="cuda").to(dt)
        before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
        o, lse = flash_attention_fwd(q, k, v)
        grads = flash_attention_bwd(q, k, v, o, dy, lse)
        torch.cuda.synchronize()
        assert (flash_attention_fwd.launches, flash_attention_bwd.launches) \
            == (before[0] + 1, before[1] + 1)
        ro, rlse = flash_attention_fwd_reference(q, k, v)
        assert o.shape == (B, Tq, H, Dv) and o.dtype == dt
        assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
        assert (lse - rlse).abs().max().item() <= 1e-3
        o2, lse2 = flash_attention_fwd(q, k, v)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        again = flash_attention_bwd(q, k, v, o, dy, lse)
        refs = flash_attention_bwd_reference(q, k, v, o, dy, lse)
        for x, y, r in zip(grads, again, refs):
            assert x.shape == r.shape and torch.isfinite(x).all()
            tol = 1.5 * TOL[dtype] * max(1.0, r.float().abs().max().item())
            assert (x.float() - r.float()).abs().max().item() <= tol
        assert torch.equal(grads[1], again[1]) and torch.equal(grads[2],
                                                               again[2])


@pytest.mark.cuda
def test_transformer_heads_1_backward_reaches_the_patch_embedding():
    """A lifter whose fusion and final blocks attend at head depth 384
    (embed 384 over one head: the deep instance) trains through the
    kernels on the card: 3 backward launches on the deep instance (2
    fusion, 1 final) beside the ViT block's, the patch embedding's
    gradient as the plain pair's."""
    _cuda()
    cfg = TransformerModelConfig(
        image_size=(64, 64), heatmap_size=32, transformer_embed_dim=384,
        transformer_heads=1, vit_depth=1, vit_heads=6, final_encoder_depth=1,
        num_cross_modal_layers=1, regression_hidden_dims=(32, 16),
        transformer_dropout_rate=0.0, regression_dropout=0.0)
    g = torch.Generator(device="cuda").manual_seed(9)
    args = (torch.rand(2, 64, 64, 3, generator=g, device="cuda"),
            torch.rand(2, 64, 64, 1, generator=g, device="cuda"),
            torch.rand(2, 17, 2, generator=g, device="cuda"))
    grads = {}
    for impl in ("auto", "reference"):
        model = build_model(cfg, device="cuda", dtype=torch.float32,
                            attention_impl=impl, train=True,
                            generator=torch.Generator("cuda").manual_seed(0))
        before = flash_attention_bwd.launches
        model(*args).square().sum().backward()
        launched = flash_attention_bwd.launches - before
        assert launched == (4 if impl == "auto" else 0)  # + 1 ViT block
        grads[impl] = model.vit_backbone.patch_embed.proj.weight.grad
    assert grads["auto"] is not None and grads["auto"].abs().sum() > 0
    assert torch.allclose(grads["auto"], grads["reference"], rtol=1e-3,
                          atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mlp_block_streams_d_2048_in_chunks(dtype):
    """D 2,048 (two chunks of 1,024 streamed through shared memory, three
    column slices) against the plain version, forward and the five
    gradients, one launch a call, repeats bitwise, the plan the library
    reports equal to ``launch_config``'s."""
    _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(20)
    x, w1, b1, w2, b2, dy = _mlp_inputs((70,), 2048, 2048, dt, g)
    cfg = mb.launch_config(70, 2048, 2048, dt.itemsize)
    assert cfg["chunks"] == (2, 1024) and cfg["slices"] == 3
    assert mb.library_config(70, 2048, 2048, dt.itemsize) == cfg
    before = (mb.mlp_block_fwd.launches, mb.mlp_block_bwd.launches)
    out = mb.mlp_block_fwd(x, w1, b1, w2, b2)
    grads = mb.mlp_block_bwd(x, w1, b1, w2, b2, dy)
    torch.cuda.synchronize()
    assert (mb.mlp_block_fwd.launches, mb.mlp_block_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    assert _rel_err(out, mb.mlp_block_fwd_reference(x, w1, b1, w2, b2)) \
        <= TOL_MLP[dtype]
    assert torch.equal(out, mb.mlp_block_fwd(x, w1, b1, w2, b2))
    refs = mb.mlp_block_bwd_reference(x, w1.float(), b1, w2.float(), b2, dy)
    again = mb.mlp_block_bwd(x, w1, b1, w2, b2, dy)
    for a, b, r in zip(grads, again, refs):
        assert a.shape == r.shape and torch.equal(a, b)
        assert _rel_err(a, r) <= TOL_MLP[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("order", [0, 1])
def test_lane_resample_bf16_matches_plain_version(order):
    """bf16 rows, fp32 positions: kernel and plain version round each
    operation alike, so they agree bit for bit in both orders."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(18 + order)
    for n, w in LR_SHAPES:
        x, a, o = lane_resample_inputs(n, w, g)
        x = x.bfloat16()
        got = lane_resample(x, a, o, order)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == (n, w)
        assert torch.equal(got, lane_resample_reference(x, a, o, order))
        assert torch.equal(got, lane_resample(x, a, o, order))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mlp_block_takes_every_width_up_to_1280(dtype):
    """ViT-H's D 1,280 (two column slices) and odd widths (zero-padded)
    against the plain version, one launch a call, repeats bitwise; past
    1,280 (once refused) D 1,296 runs streamed in two chunks."""
    _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(17)
    for lead, D, H in (((70,), 1280, 5120), ((33,), 40, 100),
                       ((9,), 776, 3104)):
        x, w1, b1, w2, b2, dy = _mlp_inputs(lead, D, H, dt, g)
        before = (mb.mlp_block_fwd.launches, mb.mlp_block_bwd.launches)
        out = mb.mlp_block_fwd(x, w1, b1, w2, b2)
        grads = mb.mlp_block_bwd(x, w1, b1, w2, b2, dy)
        torch.cuda.synchronize()
        assert (mb.mlp_block_fwd.launches, mb.mlp_block_bwd.launches) \
            == (before[0] + 1, before[1] + 1)
        assert out.shape == x.shape
        assert _rel_err(out, mb.mlp_block_fwd_reference(x, w1, b1, w2, b2)) \
            <= TOL_MLP[dtype]
        assert torch.equal(out, mb.mlp_block_fwd(x, w1, b1, w2, b2))
        refs = mb.mlp_block_bwd_reference(x, w1.float(), b1, w2.float(), b2,
                                          dy)
        for a, r in zip(grads, refs):
            assert a.shape == r.shape
            assert _rel_err(a, r) <= TOL_MLP[dtype]
    x, w1, b1, w2, b2, _ = _mlp_inputs((4,), 1296, 64, dt, g)
    assert _rel_err(mb.mlp_block_fwd(x, w1, b1, w2, b2),
                    mb.mlp_block_fwd_reference(x, w1, b1, w2, b2)) \
        <= TOL_MLP[dtype]


# (Tq, Tk, H, D): the edges of the wgmma kernels' tiles (64 query rows a
# warpgroup, 128 a forward block, 128 keys a tile and a backward block, 64
# query rows a backward tile) at the lifter's depths, and query against key
# lengths across them
WGMMA_EDGES = ([(t, t, 3, d) for t in (1, 16, 63, 64, 65, 127, 128, 129)
                for d in (48, 64)]
               + [(1, 130, 2, 64), (129, 130, 2, 64), (130, 1, 2, 48),
                  (130, 63, 2, 48)])


def _bitwise_and_close(q, k, v, dtype):
    """The kernel pair against the plain pair on q, k, v: o and lse (o
    absolute, lse 1e-3), dq, dk, dv relative to max(1, |ref|); o, lse, dk,
    dv of a repeat bitwise equal (dq is summed by atomics)."""
    o, lse = flash_attention_fwd(q, k, v)
    o2, lse2 = flash_attention_fwd(q, k, v)
    ro, rlse = flash_attention_fwd_reference(q, k, v)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
    assert (lse - rlse).abs().max().item() <= 1e-3
    g = torch.Generator(device="cuda").manual_seed(q.shape[1] + k.shape[1])
    do = torch.randn(o.shape, generator=g, device="cuda").to(o.dtype)
    got = flash_attention_bwd(q, k, v, o, do, lse)
    again = flash_attention_bwd(q, k, v, o, do, lse)
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    for x, r in zip(got, flash_attention_bwd_reference(q, k, v, o, do, lse)):
        assert x.shape == r.shape and x.dtype == r.dtype
        scale = max(1.0, r.float().abs().max().item())
        assert (x.float() - r.float()).abs().max().item() \
            <= TOL_GRAD[dtype] * scale


@pytest.mark.cuda
def test_flash_attention_wgmma_path_at_its_tile_edges():
    """bf16 at D 48 and 64 takes the wgmma kernels (asserted from
    launch_config and the built libraries) and agrees with the plain pair
    at every tile edge, forward and backward."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(12)
    for Tq, Tk, H, D in WGMMA_EDGES:
        cfg = fa.launch_config(2, Tq, Tk, H, D, D, 2)
        assert cfg["path"] == "wgmma"
        assert fa.library_config(2, Tq, Tk, H, D, D, 2) == cfg
        q = torch.randn(2, Tq, H, D, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(2, Tk, H, D, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        _bitwise_and_close(q, k, v, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_packed_views_and_value_depth(dtype):
    """Packed self-attention views of one [B, T, 3, H, D] projection and a
    cross attention's [B, Tk, 2, H, D] k/v are read in place, forward and
    backward; YOLO11x's PSA pair (D 32, Dv 64) runs on the WMMA or scalar
    kernels, as the TPU kernel takes it."""
    _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(13)
    for T, H, D in ((130, 4, 48), (257, 12, 64)):
        qkv = torch.randn(2, T, 3, H, D, generator=g, device="cuda").to(dt)
        q, k, v = qkv.unbind(2)
        assert all(fa._aligned(x) is x for x in (q, k, v))
        _bitwise_and_close(q, k, v, dtype)
        kv = torch.randn(2, 16, 2, H, D, generator=g, device="cuda").to(dt)
        _bitwise_and_close(q, *kv.unbind(2), dtype)
    q, k = (torch.randn(2, 400, 6, 32, generator=g, device="cuda").to(dt)
            for _ in range(2))
    v = torch.randn(2, 400, 6, 64, generator=g, device="cuda").to(dt)
    assert fa.launch_config(2, 400, 400, 6, 32, 64, dt.itemsize)["path"] \
        == ("wmma" if dtype == "bfloat16" else "scalar")
    _bitwise_and_close(q, k, v, dtype)


@pytest.mark.cuda
def test_cuda_bf16_backward_through_the_wgmma_kernels():
    """At head dim 64 in bf16 the model's attentions take the wgmma
    kernels: a loss.backward() launches the backward once per attention and
    the gradient reaches the patch embedding, finite and within the bf16
    whole-gradient bound of chip_smoke.py (relative L2 1e-1) of the plain
    pair's."""
    _cuda()
    cfg = TransformerModelConfig(
        image_size=(64, 64), heatmap_size=32, transformer_embed_dim=256,
        transformer_heads=4, vit_depth=2, vit_heads=4, final_encoder_depth=1,
        num_cross_modal_layers=1, regression_hidden_dims=(32, 16),
        transformer_dropout_rate=0.0, regression_dropout=0.0)
    g = torch.Generator(device="cuda").manual_seed(14)
    args = (torch.rand(2, 64, 64, 3, generator=g, device="cuda"),
            torch.rand(2, 64, 64, 1, generator=g, device="cuda"),
            torch.rand(2, 17, 2, generator=g, device="cuda"))
    grads = {}
    for impl in ("auto", "reference"):
        torch.manual_seed(0)
        model = build_model(cfg, device="cuda", dtype=torch.bfloat16,
                            attention_impl=impl, train=True)
        before = flash_attention_bwd.launches
        model(*args).float().square().sum().backward()
        assert flash_attention_bwd.launches - before == (
            5 if impl == "auto" else 0)
        grads[impl] = model.vit_backbone.patch_embed.proj.weight.grad.float()
    assert torch.isfinite(grads["auto"]).all()
    assert grads["auto"].abs().sum() > 0
    rel = (grads["auto"] - grads["reference"]).norm() / grads["reference"].norm()
    assert rel.item() <= 1e-1


# (n, C): the CNN's BatchNorm inputs at microbatch 10 and ragged ones
BN_SHAPES = [(625000, 64), (156250, 128), (39690, 768), (10240, 3072),
             (640, 1024), (10, 512), (1, 3), (7, 64), (1025, 3)]
# max |Δ| relative to max(1, max|ref|): fp32 sums in another order
TOL_BN = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bn_stats_matches_plain_version(dtype):
    """The kernel against the plain version, forward and through the
    Function's backward, and the same sums from run to run (no atomics)."""
    _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(4)
    for n, C in BN_SHAPES:
        x = (torch.randn(n, C, generator=g, device="cuda") * 1.5 + 0.3).to(dt)
        before = bn_stats.launches
        s1, s2 = bn_stats(x)
        torch.cuda.synchronize()
        assert bn_stats.launches == before + 1
        again = bn_stats(x)
        assert torch.equal(s1, again[0]) and torch.equal(s2, again[1])
        for got, ref in zip((s1, s2), bn_stats_reference(x)):
            assert got.shape == (C,) and got.dtype == torch.float32
            scale = max(1.0, ref.abs().max().item())
            assert (got - ref).abs().max().item() <= TOL_BN * scale, (n, C)
        xk = x.clone().requires_grad_()
        xr = x.clone().requires_grad_()
        w = torch.randn(2, C, generator=g, device="cuda")
        for leaf, use_kernel in ((xk, True), (xr, False)):
            a, b = BnStats.apply(leaf, use_kernel)
            ((a * w[0]).sum() + (b * w[1]).sum()).backward()
        assert xk.grad.dtype == dt and torch.equal(xk.grad, xr.grad)


@pytest.mark.cuda
def test_bn_stats_reads_rows_by_stride_and_refuses_strided_channels():
    """A channel slice of a wider activation (row stride > C, unaligned
    base) is read in place; channels that are not contiguous raise, and no
    launch is counted for them."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    wide = torch.randn(1000, 96, generator=g, device="cuda").bfloat16()
    for view in (wide[:, :64], wide[:, 3:67], wide[::2, 8:72]):
        for got, ref in zip(bn_stats(view), bn_stats_reference(view)):
            scale = max(1.0, ref.abs().max().item())
            assert (got - ref).abs().max().item() <= TOL_BN * scale
    before = bn_stats.launches
    with pytest.raises(ValueError, match="contiguous"):
        bn_stats(wide.t())
    with pytest.raises(ValueError, match="contiguous"):
        bn_stats(wide[:, ::2])
    assert bn_stats.launches == before


# The small CNN's fp32 train forward with the bn_stats kernel against the
# plain statistics, relative L2 of the output at 16 samples. On an NVIDIA
# H100 80GB HBM3 (700 W) the kernel reads 1.9e-6; the plain sums taken in
# fp64, another summation order as the kernel's is, read 2.0e-6; one sum
# of one channel of one layer 1% wrong reads 1.1e-3. The bound is ten
# times the first two readings.
TOL_CNN_FWD = 2e-5


@pytest.mark.cuda
def test_cnn_train_forward_launches_bn_stats_once_per_batchnorm(monkeypatch):
    """A small batch_pallas CNN on the card: one launch per ConvBnAct in a
    train forward, none in eval, none with stats_impl="reference"; every
    BatchNorm is handed a dense NHWC tensor by its conv (checked here; the
    module's view() would raise otherwise, there is no copy to hide it);
    the fp32 output with the kernel agrees with the plain statistics to
    summation order, which a wrong statistic in one small layer does not."""
    import pose3d_tpu_torch.ops.kernels.bn_stats as bn_mod

    _cuda()
    cfg = CNNModelConfig(
        image_size=(50, 50), heatmap_size=50, initial_channels=8,
        stage_channels=(16, 32, 64), stage_depths=(1, 3, 3),
        global_pool_size=2, global_feature_dim=32, regression_dims=(32, 16),
        regression_dropout=0.0, normalization="batch_pallas")
    # 16 samples: BatchNorm over 2 to 4 is ill-conditioned in fp32
    g = torch.Generator(device="cuda").manual_seed(6)
    args = (torch.rand(16, 50, 50, 3, generator=g, device="cuda"),
            torch.rand(16, 50, 50, 1, generator=g, device="cuda"),
            torch.rand(16, 17, 2, generator=g, device="cuda"))

    def forward(impl, dt):
        model = build_model(cfg, device="cuda", dtype=dt,
                            stats_impl=impl, train=True)
        norms = [m for m in model.modules()
                 if type(m).__name__ in ("BatchNorm", "DotStatsBatchNorm")]
        n_bn = sum(type(m).__name__ == "DotStatsBatchNorm" for m in norms)
        dense = []
        hooks = [m.register_forward_pre_hook(
            lambda _m, a: dense.append(a[0].is_contiguous())) for m in norms]
        before = bn_stats.launches
        out = model(*args)
        out.square().sum().backward()
        assert len(dense) == len(norms) > n_bn > 0 and all(dense)
        assert bn_stats.launches - before == (n_bn if impl == "auto" else 0)
        for h in hooks:
            h.remove()
        model.eval()
        with torch.no_grad():
            model(*args)
        assert bn_stats.launches - before == (n_bn if impl == "auto" else 0)
        return out.detach().double()

    outs = {(impl, dt): forward(impl, dt)
            for impl in ("auto", "reference")
            for dt in (torch.float32, torch.bfloat16)}
    plain = outs["reference", torch.float32]

    def rel(x):
        return ((x - plain).norm() / plain.norm()).item()

    # two yardsticks through the same model: the plain sums taken in fp64
    # (another summation order, as the kernel's is), and a fault: the
    # 32-channel layer's first variance sum 1% too large
    def in_fp64(x):
        xd = x.double()
        return xd.sum(0).float(), (xd * xd).sum(0).float()

    def one_wrong(x):
        s1, s2 = bn_stats_reference(x)
        if x.shape == (64, 32):     # the global-features BatchNorm
            s2 = s2.clone()
            s2[0] *= 1.01
        return s1, s2

    readings = {"kernel": rel(outs["auto", torch.float32])}
    for name, fn in (("fp64 sums", in_fp64), ("one wrong sum", one_wrong)):
        monkeypatch.setattr(bn_mod, "bn_stats_reference", fn)
        readings[name] = rel(forward("reference", torch.float32))
    monkeypatch.undo()
    print("rel L2 of the fp32 output against the plain statistics:", readings)
    assert readings["kernel"] <= TOL_CNN_FWD, readings
    assert readings["one wrong sum"] > TOL_CNN_FWD, readings


# (N, W): the two-pass warp's calls for the CNN at 10 x 10 (grouped and
# scan; image rows, depth rows), the transformer's grouped ones, ragged ones
LR_SHAPES = [(150000, 500), (50000, 500), (15000, 500), (5000, 500),
             (153600, 512), (51200, 512)] \
    + [(n, w) for n in (1, 13) for w in (1, 50, 129, 200)]


def lane_resample_inputs(n, w, generator):
    """x in [0, 1], a in [-1.3, 1.3], o in ±0.3·W (from W−1 for the rows
    read right to left), on the generator's device."""
    def rand(*shape):
        return torch.rand(*shape, generator=generator,
                          device=generator.device)
    x = rand(n, w)
    a = rand(n) * 2.6 - 1.3
    o = (rand(n) * 0.6 - 0.3) * w + torch.where(a < 0, float(w - 1), 0.0)
    return x, a, o


@pytest.mark.cuda
@pytest.mark.parametrize("order", [0, 1])
def test_lane_resample_matches_plain_version(order):
    """Kernel and plain version round every operation on its own, so they
    see the same positions: order 0 picks the same pixels (equal), order 1
    is held to 1e-6 on inputs in [0, 1]; repeats are bitwise equal."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(7 + order)
    for n, w in LR_SHAPES:
        x, a, o = lane_resample_inputs(n, w, g)
        before = lane_resample.launches
        got = lane_resample(x, a, o, order)
        torch.cuda.synchronize()
        assert lane_resample.launches == before + 1
        assert torch.equal(got, lane_resample(x, a, o, order))
        ref = lane_resample_reference(x, a, o, order)
        assert got.shape == (n, w) and got.dtype == torch.float32
        if n * w > 1000:      # both directions and both edges were read
            assert (got != 0).float().mean() > 0.3
        if order == 0:
            assert torch.equal(got, ref), (n, w)
        else:
            assert (got - ref).abs().max().item() <= 1e-6, (n, w)
    before = lane_resample.launches
    with pytest.raises(ValueError, match="not contiguous"):
        lane_resample(x[:, ::2], a, o, order)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lane_resample(x.half(), a, o, order)
    with pytest.raises(ValueError, match="CUDA"):
        lane_resample(x, a.cpu(), o, order)
    assert lane_resample.launches == before


@pytest.mark.cuda
def test_augment_on_cuda_runs_the_kernel():
    """With rotation on, one augmentation of a CUDA batch is four launches
    (two passes each for image and depth), and equals the same warp on the
    plain version (``resample_impl="reference"``, no launch); with rotation
    off the separable warp launches nothing."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(9)
    batch = {"image": torch.rand(3, 50, 70, 3, generator=g, device="cuda"),
             "depth": torch.rand(3, 50, 70, 1, generator=g, device="cuda") * 7
             + 1,
             "keypoints_2d": torch.rand(3, 17, 2, generator=g, device="cuda"),
             "joints_3d": torch.randn(3, 17, 3, generator=g, device="cuda")}
    cfg = augment_device.DeviceAugmentConfig()
    params = augment_device.draw_params(cfg, 3, g)
    before = lane_resample.launches
    kern = augment_device.apply_params(cfg, batch, params)
    assert lane_resample.launches == before + 4
    plain = augment_device.apply_params(cfg, batch, params,
                                        resample_impl="reference")
    off = augment_device.make_device_augment(
        augment_device.DeviceAugmentConfig(enable_rotation=False))(batch, g)
    assert lane_resample.launches == before + 4
    assert torch.equal(kern["depth"], plain["depth"])
    assert (kern["image"] - plain["image"]).abs().max().item() <= 1e-6
    for k in ("keypoints_2d", "joints_3d"):
        assert torch.equal(kern[k], plain[k])
    assert all(torch.isfinite(v).all() for v in off.values())
    # one sample, one channel: every broadcast of a and o is materialised
    one = {k: v[:1] for k, v in batch.items()}
    got = augment_device.make_device_augment(cfg)(one, g)
    assert lane_resample.launches == before + 8
    assert all(torch.isfinite(v).all() for v in got.values())


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [False, True])
def test_separable_warp_on_cuda_is_full_fp32(tf32):
    """With rotation off the depth equals the single-pass oracle bit for
    bit on the card whether or not the process allows TF32 products, and
    the warp leaves that setting alone; ``draw_params`` without a generator
    or a device draws on the card."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(10)
    batch = {"image": torch.rand(3, 50, 70, 3, generator=g, device="cuda"),
             "depth": torch.rand(3, 50, 70, 1, generator=g, device="cuda") * 7
             + 1,
             "keypoints_2d": torch.rand(3, 17, 2, generator=g, device="cuda"),
             "joints_3d": torch.randn(3, 17, 3, generator=g, device="cuda")}
    fast = augment_device.DeviceAugmentConfig(enable_rotation=False)
    slow = augment_device.DeviceAugmentConfig(enable_rotation=False,
                                              resample="gather")
    params = augment_device.draw_params(fast, 3)
    assert all(v.is_cuda for v in params.values())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        a = augment_device.apply_params(fast, batch, params)
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    b = augment_device.apply_params(slow, batch, params)
    assert torch.equal(a["depth"], b["depth"])
    assert (a["image"] - b["image"]).abs().max().item() <= 1e-5


def _rel_err(got, ref):
    """max |Δ| relative to max(1, max|ref|), in fp32."""
    scale = max(1.0, ref.float().abs().max().item())
    return (got.float() - ref.float()).abs().max().item() / scale


# layer_norm, kernel against plain version, relative to max(1, max|ref|).
# fp32: the sums are taken in another order (1e-5). bf16: y and dx are
# rounded to bf16 from fp32 values that differ in the last bits, so an
# output may land on the neighbouring bf16 value: one bf16 step, 2^-8
# relative (8e-3 at |y| near 4, held to 1.6e-2); mean, rstd, dscale and
# dbias are fp32 in both dtypes.
TOL_LN = {"bfloat16": 1.6e-2, "float32": 1e-5}
TOL_LN_STATS = 1e-5
# dx cancels (at C = 3 two of a row's three degrees of freedom are
# projected out while rstd reaches 1/√eps): a last-bit difference in rstd
# shows 1.4e-5 of the largest gradient, so both backward versions take the
# plain forward's statistics and dx is held to y's bound
# (rows..., C): the lifter's tokens, its 8-row norm_out, ragged ones (a C
# that allows no 16-byte reads, one wider than a lane keeps in registers)
LN_SHAPES = [(8, 1025, 768), (8, 768), (513, 100), (7, 3), (1, 640),
             (130, 2056)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layer_norm_kernels_match_plain_version(dtype):
    _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(11)
    for shape in LN_SHAPES:
        C = shape[-1]
        x = (torch.randn(*shape, generator=g, device="cuda") * 1.5
             + 0.3).to(dt)
        scale = torch.randn(C, generator=g, device="cuda") * 0.1 + 1.0
        bias = torch.randn(C, generator=g, device="cuda") * 0.1
        dy = torch.randn(*shape, generator=g, device="cuda").to(dt)
        before = ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches
        y, mean, rstd = ln.layer_norm_fwd(x, scale, bias, 1e-6)
        ry, rmean, rrstd = ln.layer_norm_fwd_reference(x, scale, bias, 1e-6)
        # both backward versions take the plain forward's statistics
        grads = ln.layer_norm_bwd(x, scale, rmean, rrstd, dy)
        torch.cuda.synchronize()
        assert (ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches) \
            == (before[0] + 1, before[1] + 1)
        rows = x.numel() // C
        assert y.shape == x.shape and y.dtype == dt
        assert mean.shape == rstd.shape == (rows,)
        assert mean.dtype == rstd.dtype == torch.float32
        assert _rel_err(y, ry) <= TOL_LN[dtype], shape
        assert _rel_err(mean, rmean) <= TOL_LN_STATS, shape
        assert _rel_err(rstd, rrstd) <= TOL_LN_STATS, shape
        refs = ln.layer_norm_bwd_reference(x, scale, rmean, rrstd, dy)
        again = ln.layer_norm_bwd(x, scale, rmean, rrstd, dy)
        for name, a, b, r in zip(("dx", "dscale", "dbias"), grads, again,
                                 refs):
            assert a.shape == r.shape and a.dtype == r.dtype, name
            assert torch.equal(a, b), (shape, name)      # no atomics
            tol = TOL_LN[dtype] if name == "dx" else TOL_LN_STATS
            assert _rel_err(a, r) <= tol, (shape, name)
    before = ln.layer_norm_fwd.launches
    with pytest.raises(ValueError, match="contiguous"):
        ln.layer_norm_fwd(x[:, ::2], scale[::2].contiguous(),
                          bias[::2].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        ln.layer_norm_fwd(x.cpu(), scale.cpu(), bias.cpu())
    assert ln.layer_norm_fwd.launches == before
    # a row-strided 2-D view is read in place
    wide = torch.randn(64, 96, generator=g, device="cuda").to(dt)
    y, _, _ = ln.layer_norm_fwd(wide[:, 8:72], scale[:64].contiguous(),
                                bias[:64].contiguous())
    ry, _, _ = ln.layer_norm_fwd_reference(wide[:, 8:72], scale[:64],
                                           bias[:64])
    assert _rel_err(y, ry) <= TOL_LN[dtype]


def _kernel_launches(fn, calls=3):
    """{kernel name: launches per call} that torch.profiler records over
    ``calls`` calls of ``fn``, after one call outside the trace. The trace
    starts with a short sleep kernel, left out (a trace can miss the first
    kernel after it starts); a trace without it is taken again."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        keys = [(e.key, e.count) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")]
        if any("spin" in k or "sleep" in k for k, _ in keys):
            break
    return {k: c / calls for k, c in keys
            if "spin" not in k and "sleep" not in k}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_row_reduce_kernels_launch_once_and_repeat_bitwise(dtype):
    """bn_stats and the layer_norm backward add their partial rows across
    blocks inside their one launch: torch.profiler sees one kernel a call,
    the sums repeat bitwise, and the plan the Python mirror computes is the
    built library's; a row-strided view (unaligned base) is read in
    place."""
    _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(12)
    wide = torch.randn(1000, 96, generator=g, device="cuda").to(dt)
    for x in [torch.randn(n, C, generator=g, device="cuda").to(dt)
              for n, C in ((625000, 64), (10240, 512), (7, 3))] + [
            wide[::2, 8:72], wide[:, 3:67]]:
        n, C = x.shape
        seen = _kernel_launches(lambda: bn_stats(x))
        assert list(seen.values()) == [1] and "bn_stats" in next(iter(seen))
        a, b = bn_stats(x), bn_stats(x)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for got, ref in zip(a, bn_stats_reference(x)):
            scale = max(1.0, ref.abs().max().item())
            assert (got - ref).abs().max().item() <= TOL_BN * scale
        ld = x.stride(0)
        al = x.data_ptr() % 16 == 0 and ld * x.element_size() % 16 == 0
        assert (bn.launch_config(n, C, x.element_size(), al)
                == bn.library_config(n, C, x.element_size(), al))
    for rows, C, view in ((8200, 768, False), (513, 100, False),
                          (64, 64, True)):
        base = torch.randn(rows, 96 if view else C, generator=g,
                           device="cuda").to(dt)
        x = base[:, 8:72] if view else base
        scale = torch.randn(C, generator=g, device="cuda") * 0.1 + 1.0
        _, mean, rstd = ln.layer_norm_fwd_reference(x, scale, scale * 0)
        dy = torch.randn(rows, C, generator=g, device="cuda").to(dt)

        def bwd():
            return ln.layer_norm_bwd(x, scale, mean, rstd, dy)
        seen = _kernel_launches(bwd)
        assert list(seen.values()) == [1] and "layer_norm_bwd" in next(
            iter(seen))
        a, b = bwd(), bwd()
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        refs = ln.layer_norm_bwd_reference(x, scale, mean, rstd, dy)
        assert _rel_err(a[0], refs[0]) <= TOL_LN[dtype]
        assert _rel_err(a[1], refs[1]) <= TOL_LN_STATS
        assert _rel_err(a[2], refs[2]) <= TOL_LN_STATS
        for al in (True, False):
            assert (ln.launch_config(rows, C, x.element_size(), al)
                    == ln.library_config(rows, C, x.element_size(), al))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layer_norm_fwd_launches_once_on_its_plan(dtype):
    """The forward is one launch of a persistent grid: torch.profiler sees
    one kernel a call, outputs repeat bitwise, and the plan the Python
    mirror computes is the built library's, on the TMA ring (aligned rows of
    at most 1,024 columns) and on the row loop (a wide row, an unaligned
    view)."""
    _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(13)
    wide = torch.randn(64, 96, generator=g, device="cuda").to(dt)
    for x in [torch.randn(n, C, generator=g, device="cuda").to(dt)
              for n, C in ((8200, 768), (513, 640), (130, 2056))] + [
            wide[:, 3:67]]:
        rows, C = x.shape
        scale = torch.randn(C, generator=g, device="cuda") * 0.1 + 1.0
        bias = torch.randn(C, generator=g, device="cuda") * 0.1
        seen = _kernel_launches(lambda: ln.layer_norm_fwd(x, scale, bias))
        assert list(seen.values()) == [1] and "layer_norm_fwd" in next(
            iter(seen))
        a, b = (ln.layer_norm_fwd(x, scale, bias) for _ in range(2))
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        ref = ln.layer_norm_fwd_reference(x, scale, bias)
        assert _rel_err(a[0], ref[0]) <= TOL_LN[dtype]
        for al in (True, False):
            assert (ln.fwd_launch_config(rows, C, x.element_size(), al)
                    == ln.fwd_library_config(rows, C, x.element_size(), al))


# fused MLP, kernel against plain version, relative to max(1, max|ref|).
# fp32: summation order only (sums of 768 to 8,200 terms), 1e-4. bf16: both
# sides round gelu(a) and da to bf16 from fp32 values that differ in the
# last bits (a neighbouring bf16 value, 2^-8 relative, on a few elements),
# and out and dx are bf16 themselves: 2e-2; dW1, db1, dW2 are fp32 sums of
# such products over the rows.
TOL_MLP = {"bfloat16": 2e-2, "float32": 1e-4}
# (rows..., D, H): the lifter's MLP and ragged ones
MLP_SHAPES = [((8, 1025), 768, 3072), ((513,), 128, 512), ((7,), 48, 80),
              ((1,), 16, 16)]


def _mlp_inputs(lead, D, H, dt, g):
    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    return (rand(*lead, D).to(dt), (rand(D, H) * D ** -0.5).to(dt),
            rand(H) * 0.1, (rand(H, D) * H ** -0.5).to(dt), rand(D) * 0.1,
            rand(*lead, D).to(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mlp_block_kernels_match_plain_version(dtype):
    _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(12)
    for lead, D, H in MLP_SHAPES:
        x, w1, b1, w2, b2, dy = _mlp_inputs(lead, D, H, dt, g)
        before = mb.mlp_block_fwd.launches, mb.mlp_block_bwd.launches
        out = mb.mlp_block_fwd(x, w1, b1, w2, b2)
        grads = mb.mlp_block_bwd(x, w1, b1, w2, b2, dy)
        torch.cuda.synchronize()
        assert (mb.mlp_block_fwd.launches, mb.mlp_block_bwd.launches) \
            == (before[0] + 1, before[1] + 1)
        ref = mb.mlp_block_fwd_reference(x, w1, b1, w2, b2)
        assert out.shape == x.shape and out.dtype == dt
        assert torch.isfinite(out).all()
        assert _rel_err(out, ref) <= TOL_MLP[dtype], (lead, D, H)
        assert torch.equal(out, mb.mlp_block_fwd(x, w1, b1, w2, b2))
        # the plain version hands the parameters' gradients back in the
        # parameters' dtype; the launcher in fp32
        refs = mb.mlp_block_bwd_reference(x, w1.float(), b1, w2.float(), b2,
                                          dy)
        again = mb.mlp_block_bwd(x, w1, b1, w2, b2, dy)
        for name, a, b, r in zip(("dx", "dw1", "db1", "dw2", "db2"), grads,
                                 again, refs):
            assert a.shape == r.shape, name
            assert a.dtype == (dt if name == "dx" else torch.float32), name
            assert torch.equal(a, b), (lead, D, H, name)     # no atomics
            assert _rel_err(a, r) <= TOL_MLP[dtype], (lead, D, H, name)
    # a width that is no multiple of 16 runs zero-padded to one (one
    # launch), against the plain version at the true width; past 1,280
    # (once refused) it runs streamed in chunks
    narrow = (x[..., :8].contiguous(), w1[:8].contiguous(), b1,
              w2[:, :8].contiguous(), b2[:8].contiguous())
    before = mb.mlp_block_fwd.launches
    out = mb.mlp_block_fwd(*narrow)
    assert mb.mlp_block_fwd.launches == before + 1 and out.shape[-1] == 8
    assert _rel_err(out, mb.mlp_block_fwd_reference(*narrow)) \
        <= TOL_MLP[dtype]
    wide = _mlp_inputs((4,), 1296, 64, dt, g)
    assert _rel_err(mb.mlp_block_fwd(*wide[:5]),
                    mb.mlp_block_fwd_reference(*wide[:5])) <= TOL_MLP[dtype]
    before = mb.mlp_block_fwd.launches
    with pytest.raises(ValueError, match="not contiguous"):
        mb.mlp_block_fwd(x, w2.t(), b1, w2, b2)
    with pytest.raises(ValueError, match="CUDA"):
        mb.mlp_block_fwd(x, w1, b1.cpu(), w2, b2)
    assert mb.mlp_block_fwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_row_ops_on_cuda_run_the_kernels(dtype, monkeypatch):
    """``layer_norm`` and ``fused_mlp`` with ``impl="auto"`` on CUDA
    tensors launch the four kernels, once each for a forward and a
    backward pass, and never reach a plain version; their gradients agree
    with the plain pair's (``impl="reference"``, no launch), in each
    parameter's own dtype."""
    _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(13)
    D, H = 128, 512
    x, w1, b1, w2, b2, dy = _mlp_inputs((3, 70), D, H, torch.float32, g)
    x, dy, b2 = x.to(dt), dy.to(dt), b2.to(dt)     # fp32 weights, as a model
    scale = torch.randn(D, generator=g, device="cuda") * 0.1 + 1.0
    bias = torch.randn(D, generator=g, device="cuda") * 0.1
    fns = (ln.layer_norm_fwd, ln.layer_norm_bwd, mb.mlp_block_fwd,
           mb.mlp_block_bwd)

    def run(impl):
        leaves = [t.clone().requires_grad_()
                  for t in (x, scale, bias, w1, b1, w2, b2)]
        xx, s, b, *mlp = leaves
        out = mb.fused_mlp(ln.layer_norm(xx, s, b, impl=impl), *mlp,
                           impl=impl)
        out.backward(dy)
        return out.detach(), [t.grad for t in leaves]

    plain_out, plain = run("reference")

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the impl='auto' path")

    for mod, name in ((ln, "layer_norm_fwd_reference"),
                      (ln, "layer_norm_bwd_reference"),
                      (mb, "mlp_block_fwd_reference"),
                      (mb, "mlp_block_bwd_reference")):
        monkeypatch.setattr(mod, name, refuse)
    before = [f.launches for f in fns]
    out, grads = run("auto")
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [n + 1 for n in before]
    assert out.dtype == dt and _rel_err(out, plain_out) <= TOL_MLP[dtype]
    leaves = (x, scale, bias, w1, b1, w2, b2)
    for a, r, leaf in zip(grads, plain, leaves):
        assert a.dtype == leaf.dtype and a.shape == leaf.shape
        assert _rel_err(a, r) <= TOL_MLP[dtype]
    with pytest.raises(RuntimeError, match="requires grad"):
        ln.layer_norm_fwd(x.clone().requires_grad_(), scale, bias)
    with pytest.raises(RuntimeError, match="requires grad"):
        mb.mlp_block_fwd(x, w1.to(dt).requires_grad_(), b1, w2.to(dt),
                         b2.float())


# The edges of the wgmma tiling (64-row blocks, 128-row tiles of the dW
# kernel and its row groups, hidden chunks of 64 and dW blocks of 32, D an
# odd multiple of 64) and shapes that stay on the WMMA kernels.
MLP_EDGE_SHAPES = [(63, 768, 3072, "wgmma"), (64, 768, 3072, "wgmma"),
                   (65, 768, 3072, "wgmma"), (129 * 64 - 1, 768, 3072, "wgmma"),
                   (511, 768, 3072, "wgmma"), (513, 768, 3072, "wgmma"),
                   (65, 768, 96, "wgmma"), (130, 768, 3056, "wgmma"),
                   (70, 192, 80, "wgmma"), (33, 720, 160, "wmma")]


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,H,path", MLP_EDGE_SHAPES)
def test_mlp_block_tiling_edges_match_plain_version(N, D, H, path):
    """bf16 at the edges of the tiling: the path the built libraries report
    is ``launch_config``'s and the expected one, outputs agree with the
    plain version, and a repeat is bitwise equal (no atomics)."""
    _cuda()
    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(N + D + H)
    x, w1, b1, w2, b2, dy = _mlp_inputs((N,), D, H, dt, g)
    cfg = mb.launch_config(N, D, H, 2)
    assert cfg == mb.library_config(N, D, H, 2) and cfg["path"] == path
    out = mb.mlp_block_fwd(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _rel_err(out, mb.mlp_block_fwd_reference(x, w1, b1, w2, b2)) \
        <= TOL_MLP["bfloat16"]
    assert torch.equal(out, mb.mlp_block_fwd(x, w1, b1, w2, b2))
    grads = mb.mlp_block_bwd(x, w1, b1, w2, b2, dy)
    again = mb.mlp_block_bwd(x, w1, b1, w2, b2, dy)
    refs = mb.mlp_block_bwd_reference(x, w1.float(), b1, w2.float(), b2, dy)
    for name, a, b, r in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, again,
                             refs):
        assert a.shape == r.shape and torch.isfinite(a).all(), name
        assert torch.equal(a, b), name
        assert _rel_err(a, r) <= TOL_MLP["bfloat16"], name


@pytest.mark.cuda
def test_fused_mlp_on_the_wgmma_path_reaches_every_gradient():
    """``fused_mlp`` on bf16 tokens of the lifter's width (the wgmma path)
    with fp32 parameters: one launch of each kernel, and x and all four
    parameters receive a finite gradient in their own dtype that agrees
    with ``impl="reference"``."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(21)
    x, w1, b1, w2, b2, dy = _mlp_inputs((2, 130), 768, 3072, torch.float32, g)
    x, dy = x.bfloat16(), dy.bfloat16()
    assert mb.launch_config(260, 768, 3072, 2)["path"] == "wgmma"

    def run(impl):
        leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
        mb.fused_mlp(*leaves, impl=impl).backward(dy)
        return leaves

    before = mb.mlp_block_fwd.launches, mb.mlp_block_bwd.launches
    got = run("auto")
    torch.cuda.synchronize()
    assert (mb.mlp_block_fwd.launches, mb.mlp_block_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    for a, r in zip(got, run("reference")):
        assert a.grad is not None and a.grad.dtype == a.dtype
        assert torch.isfinite(a.grad).all()
        assert _rel_err(a.grad, r.grad) <= TOL_MLP["bfloat16"]

"""pose3d_tpu_torch transformer lifter against the JAX model: the JAX
variables cross through ``state_dict_from_jax`` (the reference-schema
exporter) into a strict load, and the same numpy inputs give the same
joints — fp32 to 1e-4, bf16 to 3e-2 relative L2."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_helpers import (
    TINY_KW,
    inputs,
    jax_forward,
    jax_model,
    rel_l2,
)

from pose3d_tpu.compat_export import export_reference_transformer
from pose3d_tpu_torch.compat import state_dict_from_jax
from pose3d_tpu_torch.core.config import TransformerModelConfig
from pose3d_tpu_torch.models import build_model, dummy_inputs
from pose3d_tpu_torch.models.transformer import PatchEmbedding

CFG = TransformerModelConfig(**TINY_KW)


@pytest.fixture(scope="module")
def jax_fp32():
    _, model, variables = jax_model(seed=0)
    return model, variables


def _port(variables, dtype):
    model = build_model(CFG, device="cpu", dtype=dtype)
    model.load_state_dict(state_dict_from_jax(variables, CFG), strict=True)
    return model


def _run(model, args):
    with torch.inference_mode():
        return model(*[torch.from_numpy(a) for a in args]).numpy()


def test_state_dict_keys_and_order_match_exporter(jax_fp32):
    _, variables = jax_fp32
    want = export_reference_transformer(variables, CFG).sd
    got = build_model(CFG, device="cpu").state_dict()
    assert list(got) == list(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert got[k].dtype == torch.float32, k
    # the reference layout's landmarks
    for key in ("vit_backbone.blocks.1.attn.qkv.weight",
                "vit_backbone.blocks.0.mlp.fc2.bias",
                "cross_modal_fusion_layers.0.cross_attn_img_to_hm."
                "in_proj_weight",
                "cross_modal_fusion_layers.0.mlp_img.3.weight",
                "final_encoder.0.attn.out_proj.weight",
                "pose_head.decoder.6.weight",
                "heatmap_generator.x_grid"):
        assert key in got


@pytest.mark.parametrize("seed,batch", [(1, 2), (2, 3)])
def test_forward_fp32_matches_jax(jax_fp32, seed, batch):
    jmodel, variables = jax_fp32
    args = inputs(seed, batch)
    want = jax_forward(jmodel, variables, args)
    got = _run(_port(variables, torch.float32), args)
    assert got.shape == (batch, 17, 3) and got.dtype == np.float32
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_forward_bf16_matches_jax_bf16():
    _, jmodel, variables = jax_model(seed=0, dtype="bfloat16")
    args = inputs(4, 2)
    want = jax_forward(jmodel, variables, args)
    got = _run(_port(variables, torch.bfloat16), args)
    assert got.dtype == np.float32  # the head's last Linear runs in fp32
    assert rel_l2(got, want) <= 3e-2


def test_heatmap_grid_buffers_match_exporter(jax_fp32):
    _, variables = jax_fp32
    sd = state_dict_from_jax(variables, CFG)
    model = build_model(CFG, device="cpu")
    for name in ("x_grid", "y_grid"):
        assert torch.equal(getattr(model.heatmap_generator, name),
                           sd[f"heatmap_generator.{name}"])


def test_patch_embedding_equals_strided_conv():
    g = torch.Generator().manual_seed(0)
    pe = PatchEmbedding(4, 24, 16)
    with torch.no_grad():
        pe.proj.weight.copy_(torch.randn(pe.proj.weight.shape, generator=g))
        pe.proj.bias.copy_(torch.randn(24, generator=g))
    x = torch.randn(2, 64, 48, 4, generator=g)
    want = F.conv2d(x.permute(0, 3, 1, 2), pe.proj.weight, pe.proj.bias,
                    stride=16).flatten(2).transpose(1, 2)
    # 1024-term fp32 sums of O(1) products, |y| ~ 30, in another order
    torch.testing.assert_close(pe(x, torch.float32), want,
                               rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="divisible"):
        pe(torch.zeros(1, 40, 48, 4), torch.float32)


def test_build_model_is_seeded_and_ready_to_serve():
    def params(seed):
        m = build_model(CFG, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
        assert not m.training
        assert all(not p.requires_grad and p.dtype == torch.float32
                   for p in m.parameters())
        return m.state_dict()

    a, b, c = params(3), params(3), params(4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["vit_backbone.blocks.0.attn.qkv.weight"],
                           c["vit_backbone.blocks.0.attn.qkv.weight"])
    with pytest.raises(ValueError, match="Unsupported"):
        build_model("rnn")


@pytest.mark.parametrize("model_type", ["transformer", "cnn"])
def test_build_model_defaults_to_the_card(model_type):
    """``build_model`` and ``dummy_inputs`` run on the card unless the
    caller asks for the CPU: with no card they raise, they do not fall
    back (and so never train with the plain BatchNorm statistics by
    default)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(model_type, train=True)
    with pytest.raises((RuntimeError, AssertionError)):
        dummy_inputs(CFG)


def test_state_dict_from_jax_rejects_cnn():
    """The CNN bridge takes the normalisations the port builds and refuses
    any other name (the JAX factory's fallthrough to BatchNorm), whose
    variables it cannot name."""
    from pose3d_tpu.core.config import CNNModelConfig

    with pytest.raises(ValueError, match="batch_pallas"):
        state_dict_from_jax({"params": {}, "batch_stats": {}},
                            CNNModelConfig(normalization="switchable"))

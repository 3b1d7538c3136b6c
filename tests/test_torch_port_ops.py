"""pose3d_tpu_torch leaf modules against the JAX package on the same numpy
inputs: config, activations, heatmaps, and the plain attention against the
Pallas flash-attention forward (interpret mode), and the kernel wrapper's
input checks. The hand-written kernel itself runs only on a card
(tests/test_torch_port_card.py)."""

import dataclasses
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (caps torch threads)

from pose3d_tpu.core import config as jcfg
from pose3d_tpu.ops.activations import get_activation as jax_activation
from pose3d_tpu.ops.heatmap import gaussian_heatmaps as jax_heatmaps
from pose3d_tpu.ops.pallas.flash_attention import _fwd_impl as pallas_fwd

from pose3d_tpu_torch.core import config as tcfg
from pose3d_tpu_torch.ops.activations import get_activation
from pose3d_tpu_torch.ops.attention import dot_product_attention
from pose3d_tpu_torch.ops.heatmap import gaussian_heatmaps
from pose3d_tpu_torch.ops.kernels import _build
from pose3d_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_fwd,
    flash_attention_fwd_reference,
)


def test_config_defaults_match_jax():
    ours = dataclasses.fields(tcfg.TransformerModelConfig)
    theirs = dataclasses.fields(jcfg.TransformerModelConfig)
    assert [f.name for f in ours] == [f.name for f in theirs]
    assert (tcfg.TransformerModelConfig().to_dict()
            == jcfg.TransformerModelConfig().to_dict())


def test_config_from_checkpoint_args():
    args = {"image_size": [64, 64], "regression_hidden_dims": [32],
            "heatmap_size": 32, "unknown_key": 1}
    ours = tcfg.make_model_config("transformer", **args)
    theirs = jcfg.make_model_config("transformer", **args)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.image_size == (64, 64)
    assert tcfg.make_model_config(model_type="transformer") \
        == tcfg.TransformerModelConfig()
    cnn_args = {"image_size": [64, 64], "heatmap_size": 64,
                "stage_channels": [16, 32, 64], "normalization":
                "batch_pallas", "unknown_key": 1}
    assert tcfg.make_model_config("cnn", **cnn_args).to_dict() \
        == jcfg.make_model_config("cnn", **cnn_args).to_dict()
    assert tcfg.CNNModelConfig().to_dict() == jcfg.CNNModelConfig().to_dict()
    with pytest.raises(ValueError, match="heatmap_size must equal"):
        tcfg.make_model_config("cnn", heatmap_size=64)
    with pytest.raises(ValueError, match="Unsupported"):
        tcfg.make_model_config("rnn")


@pytest.mark.parametrize("bad", [
    {"image_size": (500, 512)},
    {"heatmap_size": 60},
    {"transformer_embed_dim": 770},
    {"heatmap_in_channels": 16},
])
def test_config_checks_match_jax(bad):
    with pytest.raises(ValueError) as theirs:
        jcfg.TransformerModelConfig(**bad)
    with pytest.raises(ValueError) as ours:
        tcfg.TransformerModelConfig(**bad)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("name", ["relu", "silu", "gelu", "leaky_relu",
                                  "mish", "no_such_activation"])
def test_activation_parity(name):
    x = np.random.default_rng(0).normal(scale=3.0, size=(257,)).astype(
        np.float32)
    want = np.asarray(jax_activation(name)(jnp.asarray(x)))
    got = get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size,sigma", [(32, 2.0), (64, 2.0), (17, 3.5)])
def test_heatmap_parity(size, sigma):
    rng = np.random.default_rng(size)
    kpt = rng.uniform(0.0, 1.0, size=(3, 17, 2)).astype(np.float32)
    kpt[0, 2, 0] = 0.0      # x <= 0 → whole map zero
    kpt[1, 4, 1] = -0.3     # y <= 0 → whole map zero
    want = np.asarray(jax_heatmaps(jnp.asarray(kpt), size, sigma))
    got = gaussian_heatmaps(torch.from_numpy(kpt), size, sigma).numpy()
    assert got.shape == (3, size, size, 17)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got[0, :, :, 2].any() and not got[1, :, :, 4].any()


# (B, Tq, Tk, H, D): self-attention, the cross pairs, ragged T=1 and T=130
# (across the TPU kernel's 128 pad), and D=48.
ATTN_SHAPES = [
    (2, 17, 17, 2, 64),
    (2, 16, 4, 2, 64),
    (2, 4, 16, 2, 64),
    (1, 1, 1, 2, 64),
    (1, 130, 130, 2, 64),
    (2, 17, 17, 3, 48),
    (1, 130, 17, 2, 48),
]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_plain_attention_matches_pallas_forward(shape):
    B, Tq, Tk, H, D = shape
    rng = np.random.default_rng(sum(shape))
    q = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Tk, H, D)).astype(np.float32)
    v = rng.normal(size=(B, Tk, H, D)).astype(np.float32)
    jo, jlse = pallas_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          True)
    o, lse = flash_attention_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert o.shape == (B, Tq, H, D) and lse.shape == (B, H, Tq)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., :Tq],
                               rtol=0, atol=1e-5)


def test_attention_dispatch_on_cpu():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 9, 2, 48, generator=g) for _ in range(3))
    want = flash_attention_fwd_reference(q, k, v)[0]
    assert torch.equal(dot_product_attention(q, k, v), want)
    assert torch.equal(dot_product_attention(q, k, v, impl="reference"), want)
    with pytest.raises(ValueError, match="impl"):
        dot_product_attention(q, k, v, impl="sdpa")


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args,match", [
    ((_t(1, 4, 2, 64),) * 3, "CUDA"),
    ((_t(1, 4, 2, 64, dtype=torch.float16),) * 3, "float16"),
    # depths off the built pairs run padded, past 256 on the deep
    # instance: these two pass every depth check and are refused only for
    # lying on the CPU (the cases keep the names of the refusals they were)
    pytest.param((_t(1, 4, 2, 264),) * 3, "CUDA", id="args2-head dim"),
    pytest.param((_t(1, 4, 2, 64), _t(1, 5, 2, 64), _t(1, 5, 2, 300)),
                 "CUDA", id="args3-value depth"),
    ((_t(1, 4, 2, 64), _t(1, 0, 2, 64), _t(1, 0, 2, 64)), "empty"),
    ((_t(4, 2, 64),) * 3, r"\[B, T, H, D\]"),
])
def test_kernel_wrapper_rejects(args, match):
    before = flash_attention_fwd.launches
    with pytest.raises(ValueError, match=match):
        flash_attention_fwd(*args)
    assert flash_attention_fwd.launches == before


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_libs", {})
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("the toolkit is installed at its default path")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_attention_fwd")


def test_library_name_tracks_source_and_flags(monkeypatch):
    a = _build.library_path("flash_attention_fwd")
    assert a.parent == _build.BUILD_DIR
    assert a.name.startswith("libflash_attention_fwd-") and a.suffix == ".so"
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("flash_attention_fwd") != a

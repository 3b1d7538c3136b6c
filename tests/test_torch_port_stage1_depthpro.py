"""pose3d_tpu_torch's DepthPro against the JAX package's and against HF
``DepthProForDepthEstimation``, at a tiny config (the JAX package's own
port test's; input 64²): the architecture read from an HF
``save_pretrained`` directory and from shapes alone, the forward from the
file against HF's and against the JAX model with its variables carried
across by ``compat.stage1_state_dict_from_jax`` (which flips the
transposed-conv kernels back), FOV to 1e-4 and canonical and metric depth
to 1e-3; the patch split / merge and the bilinear resize against the JAX
functions."""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from torch_port_stage1_helpers import DEPTH_S, to_np, write_depthpro  # noqa: E402

from pose3d_tpu.stage1 import depthpro as jdp  # noqa: E402
from pose3d_tpu.stage1 import depthpro_port as jdp_port  # noqa: E402

from pose3d_tpu_torch.compat import stage1_state_dict_from_jax  # noqa: E402
from pose3d_tpu_torch.stage1 import depthpro, depthpro_port  # noqa: E402


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("depthpro")
    hf = write_depthpro(d, seed=0)
    return d, hf


@pytest.fixture(scope="module")
def pixels():
    rng = np.random.default_rng(0)
    return rng.uniform(-1, 1, size=(2, DEPTH_S, DEPTH_S, 3)).astype(
        np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_arch_matches_jax(saved, tmp_path):
    """With the directory's config.json and from the shapes alone (a copy
    of the weights without it): the JAX loader's architecture."""
    d, _ = saved
    import json

    sd = depthpro_port.load_state_dict(d / "model.safetensors")
    jsd = jdp_port.load_state_dict(d / "model.safetensors")
    config = json.loads((d / "config.json").read_text())
    for cfg in (config, None):
        a = depthpro_port.arch_from_state_dict(sd, cfg, image_size=DEPTH_S)
        b = jdp_port.arch_from_state_dict(jsd, cfg, image_size=DEPTH_S)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.vit.num_layers == 2 and a.intermediate_feature_dims == (16, 16)


def test_dead_keys_are_dropped(saved):
    d, hf = saved
    sd = depthpro_port.load_state_dict(d / "model.safetensors")
    live = depthpro_port.live_state_dict(sd)
    dropped = set(sd) - set(live)
    assert dropped and all(
        k.endswith("mask_token")
        or k.startswith("fusion_stage.intermediate.0.residual_layer1.")
        for k in dropped)
    model = depthpro.DepthProDepthEstimator(
        depthpro_port.arch_from_state_dict(sd, image_size=DEPTH_S))
    assert set(model.state_dict()) == set(live)


def _assert_metric_close(got, want, inverse):
    """Metric depth is 1 / (calibrated inverse depth), and the inverse is
    the canonical depth times a FOV factor near 1: held at the canonical
    depth's bound (rtol 1e-3, atol 1e-3) in the inverse domain, and the
    metric depth itself at rtol 1e-3 wherever that atol does not dominate
    (inverse >= 1; most of the map at these weights)."""
    live = np.asarray(inverse) >= 1.0
    assert live.mean() > 0.5
    np.testing.assert_allclose(1 / got, 1 / want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-3, atol=0)


def test_forward_matches_hf(saved, pixels):
    """The file through the port's loader against HF's own forward:
    canonical depth 1e-3, FOV 1e-4, and metric depth (HF's
    post-processing) 1e-3 (:func:`_assert_metric_close`)."""
    d, hf = saved
    model = depthpro_port.load_depth_pro(d / "model.safetensors",
                                         image_size=DEPTH_S, device="cpu")
    x = _nchw(pixels)
    with torch.no_grad():
        want = hf(x)
        depth, fov = model(x)
    np.testing.assert_allclose(fov.numpy(), want.field_of_view.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(depth.numpy(), want.predicted_depth.numpy(),
                               rtol=1e-3, atol=1e-3)
    metric = depthpro.postprocess_depth(depth, fov, width=DEPTH_S)
    focal = 0.5 * DEPTH_S / torch.tan(0.5 * torch.deg2rad(
        want.field_of_view))
    inverse = want.predicted_depth * DEPTH_S / focal[:, None, None]
    hf_metric = 1.0 / torch.clamp(inverse, 1e-4, 1e4)
    _assert_metric_close(metric.numpy(), hf_metric.numpy(), inverse)


@pytest.fixture(scope="module")
def jax_ref(saved, pixels):
    d, _ = saved
    model, variables = jdp_port.load_depth_pro(d / "model.safetensors",
                                               image_size=DEPTH_S)
    variables = to_np(variables)
    depth, fov = jax.jit(lambda v, x: model.apply(v, x))(variables, pixels)
    return model, variables, np.asarray(depth), np.asarray(fov)


def test_forward_matches_jax_through_the_bridge(jax_ref, pixels):
    """The JAX variables (transposed-conv kernels flipped by its loader)
    carried across strictly: canonical depth 1e-3, FOV 1e-4, metric depth
    1e-3 (:func:`_assert_metric_close`)."""
    model, variables, jdepth, jfov = jax_ref
    port = depthpro.DepthProDepthEstimator(model.arch)
    port.load_state_dict(stage1_state_dict_from_jax(variables, "depthpro"),
                         strict=True)
    port.eval()
    with torch.no_grad():
        depth, fov = port(_nchw(pixels))
    np.testing.assert_allclose(fov.numpy(), jfov, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(depth.numpy(), jdepth, rtol=1e-3, atol=1e-3)
    want = np.asarray(jdp.postprocess_depth(jnp.asarray(jdepth),
                                            jnp.asarray(jfov)))
    _assert_metric_close(
        depthpro.postprocess_depth(depth, fov).numpy(), want,
        jdp.fov_scaled_inverse_depth(jnp.asarray(jdepth), jnp.asarray(jfov)))


def test_bridge_flips_the_transposed_kernels(jax_ref, saved):
    """Every transposed-conv weight the bridge gives equals the file's
    (the JAX loader flipped it, the bridge flips it back); every other
    weight too."""
    _, variables, _, _ = jax_ref
    d, _ = saved
    sd = depthpro_port.live_state_dict(
        depthpro_port.load_state_dict(d / "model.safetensors"))
    got = stage1_state_dict_from_jax(variables, "depthpro")
    assert set(got) == set(sd)
    deconvs = [k for k in sd if sd[k].ndim == 4 and (
        ".deconv." in k or "image_block" in k or k == "head.layers.1.weight"
        or (".layers." in k and "feature_upsample" in k
            and not k.endswith("layers.0.weight")))]
    assert len(deconvs) >= 8
    for k in sd:
        torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0, msg=k)


def test_a_pth_loads_like_the_safetensors(saved, pixels, tmp_path):
    """The same state_dict as a torch ``.pth`` (beside the same
    config.json: the tiny config's hooks are not the shape-invisible
    defaults) gives the same forward as the ``.safetensors``."""
    d, _ = saved
    for name in ("model.safetensors", "config.json"):
        shutil.copy(d / name, tmp_path / name)
    torch.save(depthpro_port.load_state_dict(d / "model.safetensors"),
               tmp_path / "model.pth")
    x = _nchw(pixels)
    outs = []
    for name in ("model.safetensors", "model.pth"):
        m = depthpro_port.load_depth_pro(tmp_path / name, image_size=DEPTH_S,
                                         device="cpu")
        with torch.no_grad():
            outs.append(m(x))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S,P,overlap", [(64, 16, 0.25), (32, 16, 0.5),
                                         (16, 16, 0.0)])
def test_split_and_merge_match_jax(S, P, overlap):
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, S, 3)).astype(np.float32)
    jp, jL = jdp.split_to_patches(jnp.asarray(x), P, overlap)
    tp, tL = depthpro.split_to_patches(_nchw(x), P, overlap)
    assert jL == tL
    np.testing.assert_array_equal(tp.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jp))
    feats = rng.normal(size=(tL * 2, 8, 8, 5)).astype(np.float32)
    jm = jdp.merge_patches(jnp.asarray(feats), 2, 3)
    tm = depthpro.merge_patches(_nchw(feats), 2, 3)
    np.testing.assert_array_equal(tm.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jm))


@pytest.mark.parametrize("hw,out", [((24, 24), (96, 96)),
                                    ((96, 96), (24, 24)),
                                    ((64, 64), (48, 40))])
def test_bilinear_resize_matches_jax(hw, out):
    """``F.interpolate`` (bilinear, align_corners=False, no antialiasing)
    against the JAX package's matrix form, up and down."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(jdp._resize_bilinear(jnp.asarray(x), out))
    got = depthpro.resize_bilinear(_nchw(x), out).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

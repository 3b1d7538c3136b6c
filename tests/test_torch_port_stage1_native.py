"""pose3d_tpu_torch's untrained stage-1 nets, the four backends and the
provider against the JAX package's: ``KeypointNet`` (heads, the best
person, multi-person decode with equal indices) and ``DepthNet`` in fp32
with the JAX variables carried across (1e-4); each backend's ``predict``
(square resize, letterbox and back, the box-confidence zeroing, padding
to the micro-batch, resize-then-invert) and the provider's
``predict_batch`` (the keypoint confidence threshold) on the same images
and weight files (keypoints 1e-4, depth rtol 1e-3); ``mesh=`` refused;
the untrained provider seeded from a ``torch.Generator``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_stage1_helpers import (
    DEPTH_S,
    YOLO_S,
    images,
    to_np,
    write_depthpro,
    write_yolo,
)

from pose3d_tpu.stage1 import models as jmodels

from pose3d_tpu_torch.compat import stage1_state_dict_from_jax
from pose3d_tpu_torch.stage1 import get_stage1_provider, models

SIZES = ((50, 70), (64, 64), (81, 40))


def _jax_net(cls, seed, x):
    """A JAX native net in fp32 and its variables (statistics moved off
    (0, 1) so that the bridge's running statistics matter)."""
    net = cls(dtype=jnp.float32)
    v = to_np(jax.jit(lambda x: net.init(jax.random.PRNGKey(seed), x,
                                         train=False))(x))
    rng = np.random.default_rng(seed)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.1, 0.4, a.shape)).astype(np.float32),
        v["batch_stats"])
    return net, v


@pytest.fixture(scope="module")
def keypoint_net():
    x = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(
        np.float32)
    net, v = _jax_net(jmodels.KeypointNet, 1, x)
    port = models.KeypointNet(dtype=torch.float32)
    port.load_state_dict(stage1_state_dict_from_jax(v, "keypoint_net"),
                         strict=True)
    return net, v, port.eval(), x


@pytest.fixture(scope="module")
def depth_net():
    x = np.random.default_rng(2).uniform(size=(2, 64, 64, 3)).astype(
        np.float32)
    net, v = _jax_net(jmodels.DepthNet, 2, x)
    port = models.DepthNet(dtype=torch.float32)
    port.load_state_dict(stage1_state_dict_from_jax(v, "depth_net"),
                         strict=True)
    return net, v, port.eval(), x


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_keypoint_net_matches_jax(keypoint_net):
    net, v, port, x = keypoint_net
    jk, jheads = jax.jit(lambda v, x: net.apply(v, x, train=False))(v, x)
    with torch.no_grad():
        tk, theads = port(_nchw(x))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4)
    for (jo, jkp), (to, tkp) in zip(jheads, theads):
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4)
        np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), atol=1e-4)
    jp, jc = jmodels.decode_persons(jheads, max_persons=4,
                                    conf_threshold=0.0, nms_radius=0.2)
    tp, tc = models.decode_persons(theads, max_persons=4,
                                   conf_threshold=0.0, nms_radius=0.2)
    obj_j = np.asarray(jmodels._flatten_heads(jheads)[0])
    obj_t = models._flatten_heads(theads)[0].numpy()
    assert np.array_equal(np.argsort(-obj_j, kind="stable")[:, :16],
                          np.argsort(-obj_t, kind="stable")[:, :16])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)


def test_decode_persons_ties_go_to_the_lower_index():
    """Equal objectness everywhere: the candidates and the survivors are
    the lowest indices, as ``jax.lax.top_k`` orders them."""
    rng = np.random.default_rng(3)
    heads = [(np.zeros((1, s, s), np.float32),
              rng.normal(size=(1, s, s, 17, 3)).astype(np.float32))
             for s in (8, 4, 2)]
    jp, jc = jmodels.decode_persons([tuple(map(jnp.asarray, h))
                                     for h in heads], conf_threshold=0.0)
    tp, tc = models.decode_persons([tuple(map(torch.from_numpy, h))
                                    for h in heads], conf_threshold=0.0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)


def test_depth_net_matches_jax(depth_net):
    net, v, port, x = depth_net
    want = np.asarray(jax.jit(lambda v, x: net.apply(v, x, train=False))(
        v, x))
    with torch.no_grad():
        got = port(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _fp32_jax_backend(backend, cls):
    """A JAX native backend with its network in fp32 (its own default is
    bf16): the model is swapped before the first predict traces it."""
    backend.model = cls(dtype=jnp.float32) if cls is jmodels.DepthNet \
        else cls(num_joints=17, dtype=jnp.float32)
    return backend


def test_native_backends_match_jax(keypoint_net, depth_net):
    """The square resize, forward and (depth) the resize back to each
    image's size, in fp32 on both sides."""
    imgs = images(4, SIZES)
    _, kv, kport, _ = keypoint_net
    _, dv, dport, _ = depth_net
    jk = _fp32_jax_backend(jmodels.NativeKeypointBackend(
        17, 64, params=kv), jmodels.KeypointNet).predict(imgs)
    tk = models.NativeKeypointBackend(
        17, 64, params=kport.state_dict(), device="cpu",
        dtype=torch.float32).predict(imgs)
    np.testing.assert_allclose(tk, jk, atol=1e-4)
    jd = _fp32_jax_backend(jmodels.NativeDepthBackend(64, params=dv),
                           jmodels.DepthNet).predict(imgs)
    td = models.NativeDepthBackend(64, params=dport.state_dict(),
                                   device="cpu",
                                   dtype=torch.float32).predict(imgs)
    for a, b, (h, w) in zip(td, jd, SIZES):
        assert a.shape == (h, w)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("stage1_weights")
    write_yolo(d / "yolo.pt", seed=8)
    write_depthpro(d / "depthpro", seed=9)
    return d / "yolo.pt", d / "depthpro" / "model.safetensors"


def test_yolo_backend_matches_jax(weight_files):
    """Letterbox (fill 114/255), the best person and back to each image's
    frame, for images of three shapes, uint8 and float; the threshold set
    between the images' best confidences so that two are zeroed."""
    yolo, _ = weight_files
    imgs = images(5, SIZES)
    imgs[1] = imgs[1].astype(np.float32) / 255.0
    jb = jmodels.YoloKeypointBackend(str(yolo), input_size=YOLO_S)
    tb = models.YoloKeypointBackend(yolo, input_size=YOLO_S, device="cpu")
    confs = []
    forward = tb._forward
    tb._forward = lambda batch: confs.append(forward(batch)[1]) or \
        forward(batch)
    tb.box_conf_threshold = 0.0
    tb.predict(imgs)
    tb._forward = forward
    thr = float(np.sort(confs[0])[1]) + 1e-6  # two below, one above
    for b in (jb, tb):
        b.box_conf_threshold = thr
    want, got = jb.predict(imgs), tb.predict(imgs)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert (got.reshape(len(imgs), -1) == 0).all(1).any()


def test_depthpro_backend_matches_jax(weight_files):
    """Resize to the network, (x − 0.5)/0.5, three images in micro-batches
    of two (the second padded), inverse depth resized to each image then
    inverted: rtol 1e-3 (atol 1e-3 on the inverse, where the metric depth
    is its reciprocal)."""
    _, depth = weight_files
    imgs = images(6, SIZES)
    want = jmodels.DepthProBackend(str(depth), input_size=DEPTH_S,
                                   max_batch=2).predict(imgs)
    got = models.DepthProBackend(depth, input_size=DEPTH_S, max_batch=2,
                                 device="cpu").predict(imgs)
    for a, b, (h, w) in zip(got, want, SIZES):
        assert a.shape == (h, w)
        np.testing.assert_allclose(1 / a, 1 / b, rtol=1e-3, atol=1e-3)


def test_provider_predict_batch_matches_jax(weight_files):
    """``predict_batch`` with both weight files and a keypoint confidence
    threshold (0.5: some keypoints zeroed): keypoints 1e-4, depth and its
    range rtol 1e-3; ``get_stage1_provider("jax", ...)`` builds it."""
    yolo, depth = weight_files
    imgs = images(7, SIZES)
    kw = dict(kp_weights=str(yolo), depth_weights=str(depth),
              kp_input_size=YOLO_S, depth_input_size=DEPTH_S,
              confidence_threshold=0.5)
    want = jmodels.JaxStage1(**kw).predict_batch(imgs)
    provider = get_stage1_provider("jax", device="cpu", **kw)
    assert isinstance(provider, models.TorchStage1)
    got = provider.predict_batch(imgs)
    zeroed = 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.keypoints, b.keypoints, atol=1e-4)
        np.testing.assert_allclose(1 / a.depth, 1 / b.depth, rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose([a.depth_min, a.depth_max],
                                   [b.depth_min, b.depth_max], rtol=1e-3)
        zeroed += int((a.keypoints[:, 2] == 0).sum())
    assert 0 < zeroed < 17 * len(imgs)


def test_provider_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        models.TorchStage1(mesh=object(), device="cpu")


def test_untrained_provider_is_seeded():
    """The native nets from an explicit generator: the same seed gives the
    same outputs (bf16, their default), another seed others; finite
    keypoints in [0, 1] and positive depth at each image's size."""
    imgs = images(8, SIZES)

    def run(seed):
        p = models.TorchStage1(input_size=64, device="cpu",
                               generator=torch.Generator().manual_seed(seed))
        assert p.kp_model.dtype == torch.bfloat16
        return p.predict_batch(imgs)

    a, b, c = run(0), run(0), run(1)
    for x, y, z, (h, w) in zip(a, b, c, SIZES):
        np.testing.assert_array_equal(x.keypoints, y.keypoints)
        np.testing.assert_array_equal(x.depth, y.depth)
        assert not np.array_equal(x.depth, z.depth)
        assert x.depth.shape == (h, w) and (x.depth > 0).all()
        assert np.isfinite(x.keypoints).all()
        assert (x.keypoints[:, :2] >= -1).all()

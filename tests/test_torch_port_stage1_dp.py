"""Data-parallel stage 1 (``TorchStage1(mesh=[devices])``) on the CPU with
two replicas: the batches each network sees are padded as the JAX
data-parallel provider pads them (the keypoint nets' rows to a multiple
of the replicas: the letterbox fill for YOLO, the last image repeated for
the native nets; DepthPro's micro-batch aligned to the replicas) and split
in order; the outputs equal the one-device provider's (1e-6) and the JAX
data-parallel provider's on a 2-device mesh (keypoints 1e-4, depth rtol
1e-3, as ``test_torch_port_stage1_native.py`` holds the plain ones)."""

import jax
import numpy as np
import pytest
import torch

from torch_port_stage1_helpers import (
    DEPTH_S,
    YOLO_S,
    images,
    write_depthpro,
    write_yolo,
)

from pose3d_tpu.core.mesh import make_mesh
from pose3d_tpu.stage1 import models as jmodels

from pose3d_tpu_torch.stage1 import models

SIZES = ((50, 70), (64, 64), (81, 40))


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("stage1_dp_weights")
    write_yolo(d / "yolo.pt", seed=8)
    write_depthpro(d / "depthpro", seed=9)
    return d / "yolo.pt", d / "depthpro" / "model.safetensors"


def _spy_batches(monkeypatch):
    seen = []
    run = models._Replicas.run

    def spy(self, batch, fn):
        seen.append((len(self), batch.copy()))
        return run(self, batch, fn)

    monkeypatch.setattr(models._Replicas, "run", spy)
    return seen


def _assert_same(got, want, kp_atol, depth_rtol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.keypoints, b.keypoints, atol=kp_atol)
        np.testing.assert_allclose(1 / a.depth, 1 / b.depth,
                                   rtol=depth_rtol, atol=depth_rtol)


def test_pretrained_provider_pads_orders_and_matches(weight_files,
                                                     monkeypatch):
    yolo, depth = weight_files
    imgs = images(11, SIZES)
    kw = dict(kp_weights=str(yolo), depth_weights=str(depth),
              kp_input_size=YOLO_S, depth_input_size=DEPTH_S,
              depth_max_batch=1)
    plain = models.TorchStage1(device="cpu", **kw).predict_batch(imgs)
    seen = _spy_batches(monkeypatch)
    dp = models.TorchStage1(mesh=["cpu", "cpu"], **kw)
    assert len(dp._kp.replicas) == len(dp._depth.replicas) == 2
    # the replicas are copies: the second holds the first's weights
    a, b = (dict(m.named_parameters()) for m in dp._kp.replicas.models)
    assert all(torch.equal(a[n], b[n]) for n in a) and a.keys() == b.keys()
    got = dp.predict_batch(imgs)
    (n_kp, kp_batch), *depth_calls = seen
    assert n_kp == 2 and kp_batch.shape[0] == 4
    np.testing.assert_array_equal(kp_batch[3], np.float32(114 / 255.0))
    # max_batch 1 aligned up to the two replicas: chunks of 2, the second
    # padded with its last image
    assert dp._depth.max_batch == 2
    assert [c[1].shape[0] for c in depth_calls] == [2, 2]
    np.testing.assert_array_equal(depth_calls[1][1][0], depth_calls[1][1][1])
    _assert_same(got, plain, 1e-6, 1e-6)
    mesh = make_mesh((2,), ("data",), devices=jax.devices()[:2])
    want = jmodels.JaxStage1(mesh=mesh, **kw).predict_batch(imgs)
    _assert_same(got, want, 1e-4, 1e-3)


def test_untrained_provider_pads_orders_and_matches(monkeypatch):
    imgs = images(12, SIZES)

    def provider(mesh):
        return models.TorchStage1(
            input_size=64, mesh=mesh, device="cpu",
            generator=torch.Generator().manual_seed(3))

    plain = provider(None).predict_batch(imgs)
    seen = _spy_batches(monkeypatch)
    got = provider(["cpu", "cpu"]).predict_batch(imgs)
    assert [(n, b.shape[0]) for n, b in seen] == [(2, 4), (2, 4)]
    for _, b in seen:
        want = jmodels._pad_rows(
            jmodels._square_resize_batch(imgs, 64), 2)
        np.testing.assert_array_equal(b, want)
    _assert_same(got, plain, 1e-6, 1e-6)

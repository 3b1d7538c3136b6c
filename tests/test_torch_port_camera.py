"""pose3d_tpu_torch.geometry.camera against pose3d_tpu.geometry.camera on
seeded fp32 inputs with batch axes: every function, to 1e-6 relative
(fp32 rounding of a 3-term dot product and one division), and the numpy
world→camera of both chunkers against it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose3d_tpu.data.chunker import world_to_camera_np as jax_w2c_np
from pose3d_tpu.geometry import camera as jcam

from pose3d_tpu_torch.data.chunker import world_to_camera_np
from pose3d_tpu_torch.geometry import camera

RTOL = 1e-6


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    return (q * np.sign(np.diag(r))).astype(np.float32)


@pytest.fixture
def scene():
    rng = np.random.default_rng(0)
    return dict(
        world=(rng.normal(size=(4, 2, 17, 3)) * 500 + [0, 0, 4000]).astype(
            np.float32),
        R=_rotation(rng),
        t=rng.normal(scale=100, size=(3, 1)).astype(np.float32),
        f=np.float32([1145.0, 1143.8]),
        c=np.float32([512.5, 515.4]),
    )


def _close(got, want, scale=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def test_world_to_camera_and_projection_match_jax(scene):
    cam = camera.world_to_camera(scene["world"], scene["R"], scene["t"])
    jc = jcam.world_to_camera(scene["world"], scene["R"], scene["t"])
    assert cam.dtype == torch.float32
    _close(cam, jc)
    for np_fn in (world_to_camera_np, jax_w2c_np):
        _close(np_fn(scene["world"], scene["R"], scene["t"]), jc)
    # a few joints behind the camera exercise the guard
    pts = np.asarray(jc).copy()
    pts[..., 2] = np.abs(pts[..., 2]) + 100
    _close(camera.camera_to_pixel(pts, scene["f"], scene["c"]),
           jcam.camera_to_pixel(pts, scene["f"], scene["c"]))
    pts[0, 0, :3, 2] *= -1
    pts[1, 1, 4, 2] = 0.0
    got = camera.project_with_validity(pts, scene["f"], scene["c"])
    want = jcam.project_with_validity(pts, scene["f"], scene["c"])
    _close(got, want)
    assert (got[0, 0, :3] == -1).all() and (got[1, 1, 4] == -1).all()
    assert (camera.project_with_validity(
        pts, scene["f"], scene["c"], invalid_value=-7.0)[1, 1, 4] == -7).all()


def test_depth_normalisation_and_root_centering_match_jax(scene):
    rng = np.random.default_rng(1)
    depth = rng.uniform(1.2, 7.9, (2, 8, 6, 1)).astype(np.float32)
    dmin, dmax = np.float32(1.2), np.float32(7.9)
    d01 = camera.normalize_depth(torch.from_numpy(depth), dmin, dmax)
    _close(d01, jcam.normalize_depth(jnp.asarray(depth), dmin, dmax), 1.0)
    back = camera.denormalize_depth(d01, dmin, dmax)
    _close(back, jcam.denormalize_depth(jnp.asarray(d01.numpy()), dmin,
                                        dmax))
    _close(back, depth)
    for root in (0, 6):
        got = camera.root_center(scene["world"], root)
        _close(got, jcam.root_center(scene["world"], root))
        assert (got[..., root, :] == 0).all()


def test_camera_keeps_the_points_device():
    pts = torch.ones(2, 17, 3)
    out = camera.world_to_camera(pts, np.eye(3), [0.0, 0.0, 1.0])
    assert out.device == pts.device and torch.equal(out[..., 2],
                                                    torch.full((2, 17), 2.0))

"""pose3d_tpu_torch device augmentation against the JAX package on the same
numpy inputs: the plain ``lane_resample`` against the Pallas kernel in
interpret mode, the augmentor in its three resample modes against
``pose3d_tpu.ops.augment_device`` with JAX's own random draws, the affine
helpers, ``draw_params``, and the ``augment=`` hook of the train step and
loop. Everything runs on the CPU, where the port's two-pass warp takes the
kernel's plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import TINY_KW, inputs

from pose3d_tpu.core import config as jcfg
from pose3d_tpu.ops import augment_device as jaug
from pose3d_tpu.ops.pallas.lane_resample import lane_resample as jax_resample

from pose3d_tpu_torch.core.config import (
    SYMMETRIC_JOINTS_H36M,
    CNNModelConfig,
    TransformerModelConfig,
)
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.ops import augment_device as taug
from pose3d_tpu_torch.ops.kernels import lane_resample as lr
from pose3d_tpu_torch.train import loop, state as tstate, step as tstep

J = 17
# not square, so that a swapped H and W cannot pass; odd, so that the
# rotation centre (W/2, H/2) is no pixel: there the source coordinate is an
# integer up to rounding, and XLA's fused CPU code takes floor(p) and
# p − floor(p) from two differently rounded copies of p (a wrong pixel in
# the JAX result, not a difference of the port)
H, W = 41, 57


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --- lane_resample ------------------------------------------------------------

def _resample_case(w: int, order: int, grid: bool):
    """13 rows: 8 with a in [0.7, 1.3] and o in ±0.3·W, 2 read right to
    left (a < 0, o near W−1), one wholly out of range, one whose first
    position lies in (−1, 0) and one whose last lies in (W−1, W). With
    ``grid`` a is a multiple of 1/64, so that a·j is exact in fp32 and p
    does not depend on whether a compiler fuses the multiply-add. For
    order 0 a row is drawn again until every position is 1e-3 away from a
    half-integer, where the last bit of p would pick the pixel."""
    rng = np.random.default_rng(w * 10 + order * 2 + grid)
    j = np.arange(w, dtype=np.float64)

    def draw(i):
        if i < 8:
            return rng.uniform(0.7, 1.3), rng.uniform(-0.3 * w, 0.3 * w)
        if i < 10:
            return (rng.uniform(-1.3, -0.7),
                    w - 1 + rng.uniform(-0.3 * w, 0.3 * w))
        if i == 10:
            return rng.uniform(0.7, 1.3), 3.0 * w
        if i == 11:
            return 1.0, -rng.uniform(0.2, 0.45)
        return 1.0, rng.uniform(0.55, 0.8)

    a, o = np.zeros(13, np.float32), np.zeros(13, np.float32)
    for i in range(13):
        while True:
            a[i], o[i] = draw(i)
            if grid:
                a[i] = np.round(a[i] * 64) / 64
            p = np.float64(a[i]) * j + np.float64(o[i])
            if order == 1 or np.abs(p - np.floor(p) - 0.5).min() > 1e-3:
                break
    x = rng.uniform(size=(13, w)).astype(np.float32)
    return x, a, o


@pytest.mark.parametrize("grid", [True, False], ids=["grid_a", "free_a"])
@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("w", [50, 128, 200, 500])
def test_plain_lane_resample_matches_pallas(w, order, grid):
    """The plain version against the Pallas kernel in interpret mode.
    Order 0 picks the same pixels: exactly equal. Order 1, inputs in
    [0, 1]: within 1e-6 where a·j is exact (one rounding of a weight or a
    product). For a free a, XLA on the CPU fuses a·j + o into one
    multiply-add and the port rounds twice (as its CUDA kernel does, by
    design), so p differs by an ulp, 6e-5 at p ~ 600, times a slope of at
    most 1 per pixel: 2e-4, the bound the JAX package's own test of the
    kernel against map_coordinates states for the same reason."""
    x, a, o = _resample_case(w, order, grid)
    want = np.asarray(jax_resample(jnp.asarray(x), jnp.asarray(a),
                                   jnp.asarray(o), order=order,
                                   interpret=True))
    got = lr.lane_resample_reference(_t(x), _t(a), _t(o), order).numpy()
    assert got.shape == want.shape == (13, w) and got.dtype == np.float32
    assert not want[10].any() and not got[10].any()    # out of range
    assert want[:10].any(axis=1).all()
    if order == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 if grid else 2e-4)
        # partial edge weights: (−1, 0) blends x[0] toward 0, (W−1, W)
        # keeps x[W−1]·(1 − w), with w read off the fp32 position
        np.testing.assert_allclose(got[11, 0], x[11, 0] * (1 + o[11]),
                                   rtol=1e-6)
        wt = (np.float32(w - 1) + o[12]) - np.float32(w - 1)
        assert 0.5 < wt < 0.85
        np.testing.assert_allclose(got[12, -1], x[12, -1] * (1 - wt),
                                   rtol=1e-6)
    # what the augmentor calls takes a CPU tensor to the plain version
    assert torch.equal(lr.resample_rows(_t(x), _t(a), _t(o), order), _t(got))


def test_lane_resample_wrapper_rejects_and_plans():
    """The raw launcher raises for what the kernel does not take and counts
    no launch it did not make; the launch plan covers every row and
    column with 256-thread blocks on ``gridDim.x``."""
    x, a = torch.zeros(4, 8), torch.zeros(4)
    before = lr.lane_resample.launches
    with pytest.raises(ValueError, match="CUDA"):
        lr.lane_resample(x, a, a)
    with pytest.raises(ValueError, match=r"\[N, W\]"):
        lr.lane_resample(torch.zeros(4, 8, 2), a, a)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lr.lane_resample(x.half(), a, a)
    with pytest.raises(ValueError, match="order"):
        lr.lane_resample(x, a, a, order=2)
    with pytest.raises(ValueError, match="order"):
        lr.lane_resample_reference(x, a, a, order=3)
    with pytest.raises(RuntimeError, match="drop its gradient"):
        lr.lane_resample(x.clone().requires_grad_(), a, a)
    with pytest.raises(ValueError, match="impl"):
        lr.resample_rows(x, a, a, impl="triton")
    with pytest.raises(ValueError, match="not contiguous"):
        lr.lane_resample(torch.zeros(8, 4).t(), a, a)
    with pytest.raises(ValueError, match="not contiguous"):
        lr.lane_resample(x, a[:1].expand(4), a)        # zero strides
    with pytest.raises(ValueError, match=r"a and o must be \[4\]"):
        lr.lane_resample(x, torch.zeros(3), a)
    assert lr.lane_resample.launches == before
    for n, w in [(150000, 500), (50000, 500), (15000, 500), (5000, 500),
                 (153600, 512), (51200, 512), (1, 1), (13, 50), (13, 129),
                 (1, 200)]:
        tx, ty, blocks = lr.launch_config(n, w)
        assert tx * ty == 256 and tx & (tx - 1) == 0 and 32 <= tx <= 256
        assert tx >= min(w, 256) and (tx == 32 or tx // 2 < w)
        assert blocks * ty >= n > (blocks - 1) * ty and blocks < 2 ** 31


# --- the affine helpers ---------------------------------------------------------

def _affines(seed, b=5):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(b, 2, 3)).astype(np.float32)
    m[:, 0, 0] += 2.0
    m[:, 1, 1] += 2.0                      # well away from singular
    return m


def test_affine_inverse_and_compose_match_jax():
    """Both against JAX to 1e-6·max(1, |ref|), and the inverse composed
    with the matrix is the identity."""
    m1, m2 = _affines(1), _affines(2)
    for got, want in (
            (taug._affine_inverse(_t(m1)), jaug._affine_inverse(m1)),
            (taug._compose(_t(m2), _t(m1)), jaug._compose(m2, m1))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(want).max()))
    ident = taug._compose(taug._affine_inverse(_t(m1)), _t(m1)).numpy()
    np.testing.assert_allclose(
        ident, np.broadcast_to(np.float32([[1, 0, 0], [0, 1, 0]]), (5, 2, 3)),
        atol=1e-5)


@pytest.mark.parametrize("order", [0, 1])
def test_axis_weights_match_jax(order):
    """The interpolation matrices are equal bit for bit: the same fp32
    subtraction, floor and comparison. Columns of positions outside the
    range carry no weight."""
    rng = np.random.default_rng(3 + order)
    pos = rng.uniform(-4, 16, size=(3, 9)).astype(np.float32)
    pos[0, :3] = [-0.5, 11.5, 4.5]          # half-integers, and the edges
    got = taug._axis_weights(_t(pos), 12, order).numpy()
    want = np.asarray(jaug._axis_weights(jnp.asarray(pos), 12, order))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 12, 9)
    assert not got[:, :, None].any(axis=1)[pos[:, None] > 12].any()


# --- the augmentor against JAX ------------------------------------------------

def _batch(seed, b=3):
    """Smooth low-frequency images and a planar depth (as the JAX
    package's augmentation tests use) with random keypoints and joints."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    imgs, depths = [], []
    for s in range(b):
        img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (xx / W + 0.3 * k + s))
                        * np.cos(2 * np.pi * (yy / H - 0.2 * k))
                        for k in range(3)], -1)
        imgs.append(np.clip(img + rng.normal(scale=0.01, size=img.shape),
                            0, 1))
        depths.append((2.0 + 3.0 * (xx / W) + 1.5 * (yy / H) + 0.1 * s)
                      [..., None])
    return {
        "image": np.stack(imgs).astype(np.float32),
        "depth": np.stack(depths).astype(np.float32),
        "keypoints_2d": rng.uniform(0.15, 0.85, (b, J, 2)).astype(np.float32),
        "joints_3d": (rng.normal(size=(b, J, 3)) * 120).astype(np.float32),
    }


def _jax_draws(cfg, key, b):
    """The draws of the JAX ``augment(batch, key)``, repeated call for
    call, in the form ``apply_params`` takes."""
    kf, ka, ks, kt, kb, kc = jax.random.split(key, 6)

    def uni(k, shape, r):
        return np.array(jax.random.uniform(k, shape, minval=r[0],
                                           maxval=r[1]))
    p = {}
    if cfg.enable_flip:
        p["flip"] = np.array(jax.random.bernoulli(kf, cfg.flip_prob, (b,)))
    if cfg.enable_rotation:
        p["angle"] = uni(ka, (b,), cfg.rotation_range)
    if cfg.enable_scale:
        p["scale"] = uni(ks, (b,), cfg.scale_range)
    if cfg.enable_translate:
        p["translate"] = uni(kt, (b, 2), cfg.translate_range)
    if cfg.enable_color:
        p["brightness"] = uni(kb, (b,), cfg.brightness_range)
        p["contrast"] = uni(kc, (b,), cfg.contrast_range)
    return p


STAGES = ["flip", "rotation", "scale", "translate", "color"]


def _stage_kw(stages):
    on = STAGES if stages == "all" else [] if stages == "none" else [stages]
    return {f"enable_{s}": s in on for s in STAGES}


@pytest.mark.parametrize("stages", ["all", "none"] + STAGES)
@pytest.mark.parametrize("resample", ["separable", "kernel", "gather"])
def test_apply_params_matches_jax(resample, stages):
    """``apply_params`` with JAX's own draws against the JAX
    ``augment(batch, key)``, every stage alone, all together and none:
    keypoints within 1e-6, joints within 1e-6·max|ref|, image and depth
    within 1e-5 (the depth under rotation: but for 1 nearest pick in
    1000). The separable mode takes no rotation, as in JAX."""
    kw = _stage_kw(stages)
    if resample == "separable" and kw["enable_rotation"]:
        if stages == "rotation":
            for mod in (taug, jaug):
                cfg = mod.DeviceAugmentConfig(resample="separable", **kw)
                with pytest.raises(ValueError, match="separable"):
                    mod.make_device_augment(cfg)(
                        {k: (_t if mod is taug else jnp.asarray)(v)
                         for k, v in _batch(0).items()},
                        (torch.Generator() if mod is taug
                         else jax.random.PRNGKey(0)))
            return
        kw["enable_rotation"] = False      # "all" the separable mode takes
    tcfg = taug.DeviceAugmentConfig(resample=resample, flip_prob=0.6, **kw)
    jcfg_ = jaug.DeviceAugmentConfig(resample=resample, flip_prob=0.6, **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg_)
    batch = _batch(7)
    batch["extra"] = np.arange(3)
    key = jax.random.PRNGKey(5)
    want = jax.device_get(jax.jit(jaug.make_device_augment(jcfg_))(
        {k: jnp.asarray(v) for k, v in batch.items()}, key))
    params = _jax_draws(jcfg_, key, 3)
    if stages in ("all", "flip"):
        assert params["flip"].any() and not params["flip"].all()
    got = taug.apply_params(tcfg, {k: _t(v) for k, v in batch.items()},
                            params)
    assert set(got) == set(want)
    assert torch.equal(got["extra"], _t(batch["extra"]))
    np.testing.assert_allclose(got["keypoints_2d"].numpy(),
                               want["keypoints_2d"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        got["joints_3d"].numpy(), want["joints_3d"], rtol=0,
        atol=1e-6 * np.abs(want["joints_3d"]).max())
    for k in ("image", "depth"):
        assert got[k].dtype == torch.float32
    np.testing.assert_allclose(got["image"].numpy(), want["image"], rtol=0,
                               atol=1e-5)
    d = np.abs(got["depth"].numpy() - want["depth"])
    if kw["enable_rotation"]:
        # a nearest pick flips where a position lies within rounding of a
        # half-integer: cos and sin differ in their last bit between XLA
        # and PyTorch, and XLA fuses a·j + o. At most 1 pixel in 1000 may
        # take the neighbouring pixel, one step of the depth plane away.
        assert (d > 1e-5).mean() <= 1e-3, (d > 1e-5).sum()
        assert d.max() <= 3.0 / W + 1.5 / H + 1e-5
    else:
        assert d.max() <= 1e-5
    if stages == "none":
        for k, v in batch.items():
            assert torch.equal(got[k], _t(v)), k


def test_augment_keeps_dtypes_and_auto_picks_the_mode():
    """bf16 pixels go through the fp32 warp and come back bf16; "auto" is
    the separable mode without rotation and the two-pass mode with it."""
    batch = {k: _t(v) for k, v in _batch(9).items()}
    batch["image"] = batch["image"].bfloat16()
    for rotation in (False, True):
        cfg = taug.DeviceAugmentConfig(enable_rotation=rotation)
        params = taug.draw_params(cfg, 3, torch.Generator().manual_seed(0))
        got = taug.apply_params(cfg, batch, params)
        assert got["image"].dtype == torch.bfloat16
        assert got["depth"].dtype == torch.float32
        explicit = dataclasses.replace(
            cfg, resample="kernel" if rotation else "separable")
        same = taug.apply_params(explicit, batch, params,
                                 resample_impl="reference")
        for k in got:
            assert torch.equal(got[k], same[k]), (rotation, k)
    with pytest.raises(ValueError, match="resample"):
        taug.make_device_augment(taug.DeviceAugmentConfig(resample="xla"))
    with pytest.raises(ValueError, match="impl"):
        taug.make_device_augment(resample_impl="pallas")


def test_separable_depth_equals_the_oracle_exactly():
    """The order-0 weights are one-hot, so the separable products pick
    pixels: with rotation off the depth equals the single-pass oracle bit
    for bit (and the image to 1e-5), also when the process has set TF32."""
    batch = {k: _t(v) for k, v in _batch(11).items()}
    kw = dict(enable_rotation=False, scale_range=(0.82, 1.17),
              translate_range=(-0.07, 0.07))
    fast = taug.DeviceAugmentConfig(**kw)
    slow = taug.DeviceAugmentConfig(resample="gather", **kw)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for seed in range(3):
            params = taug.draw_params(fast, 3,
                                      torch.Generator().manual_seed(seed))
            a = taug.apply_params(fast, batch, params)
            b = taug.apply_params(slow, batch, params)
            assert torch.equal(a["depth"], b["depth"])
            assert (a["image"] - b["image"]).abs().max() <= 1e-5
            assert torch.equal(a["keypoints_2d"], b["keypoints_2d"])
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def test_twopass_close_to_the_oracle_and_blob_follows_keypoint():
    """The two-pass warp against the exact single-pass one with the bounds
    of the JAX package's own test (geometry identical, pixels differ by
    the sub-pixel shear approximation on smooth images); and with every
    geometric stage on, a bright blob painted at a keypoint lands within
    2 px of the transformed keypoint."""
    batch = {k: _t(v) for k, v in _batch(13).items()}
    kw = dict(enable_color=False, rotation_range=(-28.0, -28.0),
              scale_range=(1.1, 1.1), translate_range=(0.04, 0.04),
              flip_prob=1.0)
    cfg = taug.DeviceAugmentConfig(**kw)
    params = taug.draw_params(cfg, 3, torch.Generator().manual_seed(1))
    a = taug.apply_params(cfg, batch, params)
    b = taug.apply_params(dataclasses.replace(cfg, resample="gather"), batch,
                          params)
    assert (a["keypoints_2d"] - b["keypoints_2d"]).abs().max() <= 1e-6
    assert (a["joints_3d"] - b["joints_3d"]).abs().max() <= 1e-4
    d = (a["image"] - b["image"]).abs()
    assert d.mean() < 0.01 and d.max() < 0.2, (d.mean(), d.max())

    kp = np.float32([0.4, 0.6])
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    blob = np.exp(-((xx - kp[0] * W) ** 2 + (yy - kp[1] * H) ** 2)
                  / (2 * 1.5 ** 2))
    one = {k: v[:1].clone() for k, v in batch.items()}
    one["keypoints_2d"][0, 0] = _t(kp)
    one["image"] = torch.clamp(
        0.2 * one["image"] + 0.8 * _t(blob.astype(np.float32))[None, ..., None],
        0, 1)
    aug = taug.make_device_augment(taug.DeviceAugmentConfig(
        enable_color=False, rotation_range=(-25.0, 25.0),
        scale_range=(0.9, 1.1), translate_range=(-0.05, 0.05)))
    checked = 0
    for seed in range(6):
        out = aug(one, torch.Generator().manual_seed(seed))
        kp2 = out["keypoints_2d"][0, 0].numpy()
        if not (0.1 < kp2[0] < 0.9 and 0.1 < kp2[1] < 0.9):
            continue
        img = out["image"][0].sum(-1).numpy()
        py, px = np.unravel_index(np.argmax(img), img.shape)
        assert abs(px - kp2[0] * W) <= 2.0, (seed, px, kp2[0] * W)
        assert abs(py - kp2[1] * H) <= 2.0, (seed, py, kp2[1] * H)
        checked += 1
    assert checked >= 3


# --- draw_params ------------------------------------------------------------------

def test_draw_params_ranges_variety_and_determinism():
    cfg = taug.DeviceAugmentConfig()
    assert cfg.symmetric_joints == SYMMETRIC_JOINTS_H36M \
        == jcfg.SYMMETRIC_JOINTS_H36M
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    p = taug.draw_params(cfg, 64, gen)
    assert set(p) == {"flip", "angle", "scale", "translate", "brightness",
                      "contrast"}
    assert p["flip"].dtype == torch.bool and p["flip"].shape == (64,)
    assert 10 < int(p["flip"].sum()) < 54
    for name, rng, shape in (("angle", cfg.rotation_range, (64,)),
                             ("scale", cfg.scale_range, (64,)),
                             ("translate", cfg.translate_range, (64, 2)),
                             ("brightness", cfg.brightness_range, (64,)),
                             ("contrast", cfg.contrast_range, (64,))):
        v = p[name]
        assert v.shape == shape and v.dtype == torch.float32
        assert rng[0] <= v.min() and v.max() <= rng[1]
        assert v.unique().numel() == v.numel()          # per-sample variety
        assert v.max() - v.min() > 0.5 * (rng[1] - rng[0])
    # the same generator state gives the same draws; the next state others
    again = taug.draw_params(cfg, 64, gen.set_state(state))
    assert all(torch.equal(p[k], again[k]) for k in p)
    other = taug.draw_params(cfg, 64, gen)
    assert not torch.equal(p["angle"], other["angle"])


@pytest.mark.parametrize("prob", [0.0, 1.0])
def test_draw_params_flip_prob_and_disabled_stages(prob):
    cfg = taug.DeviceAugmentConfig(flip_prob=prob, enable_rotation=False,
                                   enable_color=False)
    p = taug.draw_params(cfg, 32, torch.Generator().manual_seed(0))
    assert set(p) == {"flip", "scale", "translate"}
    assert bool(p["flip"].all()) == bool(prob) == bool(p["flip"].any())
    # identical inputs, different per-sample draws, deterministic per seed
    one = {k: _t(v[:1]).expand(2, *v.shape[1:]) for k, v in _batch(5).items()}
    aug = taug.make_device_augment()
    a = aug(one, torch.Generator().manual_seed(0))
    b = aug(one, torch.Generator().manual_seed(0))
    assert torch.equal(a["image"], b["image"])
    assert (a["image"][0] - a["image"][1]).abs().max() > 0.05


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card "
                    "error of the default device")
def test_draw_params_defaults_to_the_card():
    """Without a generator and a device the draws are made on the card, and
    raise where there is none; the CPU is used only when asked for."""
    cfg = taug.DeviceAugmentConfig()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        taug.draw_params(cfg, 4)
    p = taug.draw_params(cfg, 4, device="cpu")
    assert all(v.device.type == "cpu" for v in p.values())
    q = taug.draw_params(cfg, 4, torch.Generator().manual_seed(0))
    assert all(v.device.type == "cpu" for v in q.values())


# --- the train step and loop ------------------------------------------------------

TINY_CNN = dict(
    image_size=(32, 32), heatmap_size=32, heatmap_sigma=2.0,
    stage_channels=(8, 16, 32), stage_depths=(1, 1, 1), initial_channels=8,
    global_pool_size=2, global_feature_dim=16, regression_dims=(16,),
)


def _superbatch(seed, a, b, hw):
    rng = np.random.default_rng(seed)
    batches = []
    for i in range(a):
        img, depth, kpt = inputs(seed * 10 + i, b, hw=hw)
        batches.append({
            "image": img, "depth": depth, "keypoints_2d": kpt,
            "joints_3d": rng.normal(scale=0.5, size=(b, J, 3)).astype(
                np.float32)})
    return batches, loop.to_device(next(loop._superbatches(batches, a)),
                                   "cpu")


def _cnn_state(seed=0):
    model = build_model(CNNModelConfig(**TINY_CNN), device="cpu",
                        dtype=torch.float32, train=True,
                        generator=torch.Generator().manual_seed(seed))
    return tstate.create_train_state(model)


def _after_step(step, sb, *gens):
    st = _cnn_state()
    m = step(st, sb, torch.Generator().manual_seed(1), *gens)
    return m, [p.detach().clone() for p in st.model.parameters()]


@pytest.mark.parametrize("mode", ["grouped", "scan"])
def test_train_step_with_device_augment(mode):
    """The step runs the augmentor (rotation on: the two-pass warp) in
    both accumulation modes with a finite loss that differs from the
    un-augmented one; ``augment=None`` and an augmentor with every stage
    off leave the step bit for bit as it is without the hook; the augmentor
    is called once over the flat batch (grouped) or once per microbatch
    (scan), without gradient."""
    _, sb = _superbatch(3, 2, 4, 32)
    calls = []
    inner = taug.make_device_augment()

    def aug(batch, generator):
        calls.append((batch["image"].shape[0], torch.is_grad_enabled(),
                      batch["image"].dtype))
        return inner(batch, generator)

    plain, p_plain = _after_step(tstep.make_train_step(accum_mode=mode), sb)
    none, p_none = _after_step(
        tstep.make_train_step(accum_mode=mode, augment=None), sb)
    off = taug.make_device_augment(taug.DeviceAugmentConfig(
        **_stage_kw("none")))
    noop, p_noop = _after_step(
        tstep.make_train_step(accum_mode=mode, augment=off), sb,
        torch.Generator().manual_seed(2))
    on, p_on = _after_step(
        tstep.make_train_step(accum_mode=mode, augment=aug), sb,
        torch.Generator().manual_seed(2))
    for k in plain:
        assert torch.equal(plain[k], none[k]) and torch.equal(plain[k],
                                                              noop[k])
    for a, b, c in zip(p_plain, p_none, p_noop):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert np.isfinite(on["total_loss"].item())
    assert on["total_loss"].item() != plain["total_loss"].item()
    assert all(torch.isfinite(p).all() for p in p_on)
    assert calls == ([(8, False, torch.float32)] if mode == "grouped"
                     else [(4, False, torch.float32)] * 2)
    with pytest.raises(ValueError, match="augment_generator"):
        tstep.make_train_step(accum_mode=mode, augment=aug)(
            _cnn_state(), sb, torch.Generator().manual_seed(1))


def test_dropout_masks_do_not_depend_on_augmentation():
    """Augmentation draws from its own generator: with dropout on, the
    dropout generator ends the step in the same state whether the step
    augments or not, and an augmentor with every stage off gives the very
    loss of the un-augmented step (the same masks)."""
    cfg = TransformerModelConfig(**TINY_KW)       # published dropout rates
    _, sb = _superbatch(4, 2, 2, 64)

    def run(augment):
        model = build_model(cfg, device="cpu", dtype=torch.float32,
                            train=True,
                            generator=torch.Generator().manual_seed(0))
        st = tstate.create_train_state(model)
        drop = torch.Generator().manual_seed(1)
        aug_gen = torch.Generator().manual_seed(2)
        start = aug_gen.get_state()
        m = tstep.make_train_step(augment=augment)(
            st, sb, drop, aug_gen if augment is not None else None)
        return m["total_loss"].item(), drop.get_state(), \
            not torch.equal(start, aug_gen.get_state())

    loss0, drop0, _ = run(None)
    loss1, drop1, drew1 = run(taug.make_device_augment())
    loss2, drop2, drew2 = run(taug.make_device_augment(
        taug.DeviceAugmentConfig(**_stage_kw("none"))))
    assert torch.equal(drop0, drop1) and torch.equal(drop0, drop2)
    assert drew1 and not drew2
    assert loss2 == loss0 and loss1 != loss0 and np.isfinite(loss1)


def test_train_model_passes_augment_through(tmp_path):
    """``train_model(augment=...)`` augments every step from a generator
    of its own (built when none is given, the same from run to run) and
    still writes its ``.pth``; without ``augment`` it builds none."""
    batches, _ = _superbatch(5, 4, 4, 32)
    seen = []
    inner = taug.make_device_augment()

    def aug(batch, generator):
        seen.append(generator.get_state().clone())
        return inner(batch, generator)

    def run(**kw):
        st = _cnn_state()
        st, n = loop.train_model(
            st, batches, gradient_accumulation_steps=2, max_epochs=1,
            log_interval_steps=1, eval_interval_steps=10 ** 9,
            generator=torch.Generator().manual_seed(0),
            checkpoint_path=tmp_path / "cnn.pth", **kw)
        assert n == 2
        return [p.detach().clone() for p in st.model.parameters()]

    a = run(augment=aug)
    assert len(seen) == 2 and not torch.equal(seen[0], seen[1])
    b = run(augment=aug)
    assert torch.equal(seen[0], seen[2])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = run()
    assert len(seen) == 4
    assert any(not torch.equal(x, y) for x, y in zip(a, c))
    assert (tmp_path / "cnn.pth").is_file()

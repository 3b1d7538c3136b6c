"""pose3d_tpu_torch's host augmentation against the JAX package's:
``PoseAugmentor`` bitwise equal on the same samples and seed (each
transform alone, then the whole chain over several draws, float and uint8
samples), ``StreamingChunkedDataset(use_augmentation=True)`` giving the
JAX pipeline's batches and data positions on the committed fixture, and
``cli.main --augment`` training on the CPU. Both packages run the same cv2
and numpy in this process, so any difference is a fault of the port."""

import json

import numpy as np
import pytest

from helpers_synthetic import make_synthetic_chunk
import torch_port_helpers as helpers
from torch_port_helpers import FIXTURE_DIR

from pose3d_tpu.data import augment as jaugment, pipeline as jpipeline

from pose3d_tpu_torch.cli import main as port_main
from pose3d_tpu_torch.data import augment, pipeline

pytest.importorskip("cv2")

TRANSFORMS = ("flip", "rotation", "scale", "translate", "color")
DRAWS = 6


def _sample(seed, u8, hw=(36, 44)):
    """A decoded sample of either pixel convention, with camera params."""
    rng = np.random.default_rng(seed)
    h, w = hw
    s = {
        "joints_3d": rng.normal(scale=0.4, size=(17, 3)).astype(np.float32),
        "keypoints_2d": rng.uniform(0.05, 0.95, (17, 2)).astype(np.float32),
        "camera_params": {"R": np.eye(3).tolist(), "t": [0.0, 0.0, 0.0],
                          "f": [1145.0, 1144.0], "c": [512.5, 515.4]},
        "image_size": [w, h],
        "action": 2,
    }
    if u8:
        s["image"] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        s["depth"] = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
        s["depth_min"], s["depth_max"] = 1.5, 7.25
    else:
        s["image"] = rng.uniform(size=(h, w, 3)).astype(np.float32)
        s["depth"] = rng.uniform(1, 8, (h, w, 1)).astype(np.float32)
    return s


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k
        else:
            assert g == w, k


@pytest.mark.parametrize("u8", [False, True])
@pytest.mark.parametrize("only", TRANSFORMS + ("all",))
def test_augmentor_is_bitwise_jax(only, u8):
    """One transform alone (``enable_*`` off for the others), or the whole
    chain: ``DRAWS`` samples through each package's augmentor built with
    the same seed give identical arrays and camera params; the float input
    is left unchanged."""
    kw = {} if only == "all" else {
        f"enable_{t}": t == only for t in TRANSFORMS}
    ours = augment.PoseAugmentor(seed=11, **kw)
    ref = jaugment.PoseAugmentor(seed=11, **kw)
    for i in range(DRAWS):
        s = _sample(i, u8)
        before = s["image"].copy()
        got, want = ours(s), ref(s)
        _assert_same(got, want)
        assert got["image"].dtype == np.float32
        assert np.array_equal(s["image"], before)
    # the generators were drawn the same number of times
    assert ours.rng.random() == ref.rng.random()


def test_augmentor_options_match_jax():
    """Both constructors take the same options with the same defaults."""
    import inspect

    a = inspect.signature(augment.PoseAugmentor).parameters
    b = inspect.signature(jaugment.PoseAugmentor).parameters
    assert list(a) == list(b)
    for name in a:
        assert a[name].default == b[name].default, name


jax_on_port_library = pytest.fixture(helpers.jax_on_port_library)


def _stream(pkg, n, seed, training=True):
    ds = pkg.StreamingChunkedDataset(
        "train", str(FIXTURE_DIR), image_size=(40, 48), seed=5,
        pixel_dtype="uint8", use_augmentation=True,
        augmentation_config={"seed": seed})
    ds.training = training
    it = iter(pkg.BatchLoader(ds, 4, loop=True))
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def test_augmented_streams_match_jax(jax_on_port_library):
    """A training dataset with host augmentation over the fixture's two
    train chunks (50 samples, batches of 4, into a second epoch): the same
    float batches, camera params and ``_pos`` as the JAX pipeline; with
    ``training`` off the augmentor is not applied (uint8 batches)."""
    got = _stream(pipeline, 14, seed=3)
    want = _stream(jpipeline, 14, seed=3)
    assert [b["_pos"] for b in got] == [b["_pos"] for b in want]
    assert got[-1]["_pos"][0] == 1
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("image", "depth", "keypoints_2d", "joints_3d"):
            assert g[k].dtype == np.float32
            assert g[k].tobytes() == w[k].tobytes(), k
        assert g["camera_params"] == w["camera_params"]
    other = _stream(pipeline, 1, seed=4)[0]
    assert other["image"].tobytes() != got[0]["image"].tobytes()
    plain = _stream(pipeline, 1, seed=3, training=False)[0]
    assert plain["image"].dtype == np.uint8


TINY_CNN = dict(
    image_size=[32, 32], heatmap_size=32, heatmap_sigma=2.0,
    stage_channels=[8, 16, 32], stage_depths=[1, 1, 1], initial_channels=8,
    global_pool_size=2, global_feature_dim=16, regression_dims=[16],
)


@pytest.fixture(scope="module")
def chunks_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("chunks")
    make_synthetic_chunk(d, 0, num_samples=8, image_hw=(40, 48), seed=2,
                         num_actions=2)
    make_synthetic_chunk(d, 1, num_samples=4, image_hw=(40, 48),
                         prefix="test", seed=3)
    return d


def _argv(chunks_dir, *extra):
    return ["--chunks-dir", str(chunks_dir), "--device", "cpu",
            "--model-type", "cnn", "--model-args", json.dumps(TINY_CNN),
            "--batch-size", "2", "--grad-accum", "2", "--num-steps", "1",
            "--eval-interval", "1", "--no-tensorboard", *extra]


def test_cli_augment_trains_on_the_cpu(chunks_dir, tmp_path, monkeypatch):
    """``cli.main --augment`` builds the training dataset with the host
    augmentor (the validation one without) and trains a step."""
    monkeypatch.chdir(tmp_path)
    made = []
    real = port_main.StreamingChunkedDataset

    def dataset(*a, **kw):
        made.append(kw.get("use_augmentation", False))
        return real(*a, **kw)

    monkeypatch.setattr(port_main, "StreamingChunkedDataset", dataset)
    assert port_main.main(_argv(chunks_dir, "--augment")) == 1
    assert made == [True, False]


def test_augment_with_augment_device_is_refused(chunks_dir, capsys,
                                                tmp_path, monkeypatch):
    """Exit 2 with the JAX CLI's message, before anything is trained."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        port_main.main(_argv(chunks_dir, "--augment", "--augment-device"))
    assert e.value.code == 2
    assert ("--augment (host) and --augment-device are mutually exclusive "
            "— pick one augmentation path") in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []
    helps = {a.dest: a.help for a in port_main.build_parser()._actions}
    from pose3d_tpu.cli import main as jax_main

    jhelps = {a.dest: a.help for a in jax_main.build_parser()._actions}
    assert helps["augment"] == jhelps["augment"]

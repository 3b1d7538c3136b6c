"""pose3d_tpu_torch's inference and conversion CLIs against the JAX
package's: ``cli.infer`` with ``--stage1 cached`` on the same folder of
preprocess artifacts and the same ``.pth`` as ``pose3d_tpu.cli.infer``
(both in fp32), its padding of a short batch, its panel and its refused
flags; ``stage1.api``'s cached provider against the JAX one; and
``cli.convert`` (``.pth`` → checkpoint directory → ``--to-torch``
``.pth``) key for key against the JAX converter's round trip."""

import functools
import json

import cv2
import numpy as np
import pytest
import torch

from torch_port_helpers import TINY_KW

from pose3d_tpu_torch.checkpoint import save_pose_model
from pose3d_tpu_torch.cli import convert as port_convert
from pose3d_tpu_torch.cli import infer as port_infer
from pose3d_tpu_torch.core.config import (
    CNNModelConfig,
    GlobalConfig,
    TransformerModelConfig,
)
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.stage1 import CachedStage1, get_stage1_provider
from pose3d_tpu_torch.train import checkpoint as ckpt

TINY_CNN = dict(
    image_size=(32, 32), heatmap_size=32, heatmap_sigma=2.0,
    stage_channels=(8, 16, 32), stage_depths=(1, 1, 1), initial_channels=8,
    global_pool_size=2, global_feature_dim=16, regression_dims=(16,),
)
MODELS = {"transformer": (TransformerModelConfig, TINY_KW),
          "cnn": (CNNModelConfig, TINY_CNN)}
# images of three sizes; "e_noart" has no stage-1 artifacts
SIZES = {"a": (60, 80), "b": (72, 72), "c": (50, 90), "d": (60, 80),
         "e_noart": (40, 40)}


def _write_folder(root, seed=0):
    """Images (PNG and JPEG) with ``<stem>_depth.png`` and ``<stem>.json``
    as the preprocess stage writes them: keypoints as a list of persons,
    one of them with fewer joints and no confidences."""
    rng = np.random.default_rng(seed)
    root.mkdir()
    for i, (stem, (h, w)) in enumerate(SIZES.items()):
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        ext = ".jpg" if i % 2 else ".png"
        cv2.imwrite(str(root / f"{stem}{ext}"), img)
        if stem.endswith("noart"):
            continue
        yy, xx = np.mgrid[0:h, 0:w]
        depth = ((xx + yy) * 255 / (h + w)).astype(np.uint8)
        cv2.imwrite(str(root / f"{stem}_depth.png"), depth)
        n = 17 if i != 1 else 12
        person = [{"x": float(rng.uniform(0, w)), "y": float(rng.uniform(0, h)),
                   **({"conf": float(rng.uniform(0.2, 1))} if i != 1 else {})}
                  for _ in range(n)]
        (root / f"{stem}.json").write_text(json.dumps({
            "image_size": [w, h], "keypoints": [person],
            "depth_min": 1.5 + i, "depth_max": 4.0 + 2 * i}))
    return root


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return _write_folder(tmp_path_factory.mktemp("infer") / "imgs")


def test_cached_stage1_matches_jax(folder):
    """Keypoints (normalised, padded to 17, confidence 1 where absent) and
    the metric depth map of each image equal the JAX provider's; an image
    without artifacts gives None in both; ``"jax"`` builds the networks'
    provider."""
    from pose3d_tpu.stage1.api import CachedStage1 as JaxCached

    paths = sorted(p for p in folder.iterdir()
                   if not p.stem.endswith("_depth") and p.suffix != ".json")
    ours = CachedStage1().predict(paths)
    theirs = JaxCached().predict(paths)
    assert [r is None for r in ours] == [r is None for r in theirs] \
        == [p.stem.endswith("noart") for p in paths]
    for a, b in zip(ours, theirs):
        if a is not None:
            np.testing.assert_array_equal(a.keypoints, b.keypoints)
            np.testing.assert_array_equal(a.depth, b.depth)
            assert (a.depth_min, a.depth_max) == (b.depth_min, b.depth_max)
    from pose3d_tpu_torch.stage1.models import TorchStage1

    assert isinstance(get_stage1_provider("jax", input_size=64,
                                          device="cpu"), TorchStage1)


@pytest.mark.parametrize("model_type", sorted(MODELS))
def test_infer_cli_matches_the_jax_cli(folder, tmp_path, monkeypatch,
                                       model_type):
    """One ``.pth`` through ``pose3d_tpu.cli.infer`` and the port's
    ``cli.infer`` at ``--batch-size 3`` (four images with artifacts: a full
    batch and one of one padded back to three), both in fp32: the same
    files, each ``<stem>_pred_joints3d.npy`` within 1e-4·max(1, |ref|)
    (the compact uint8 transfer decoded on each side, summation order);
    the image without artifacts is skipped by both."""
    from pose3d_tpu.cli import infer as jax_infer
    from pose3d_tpu.models import factory as jfactory
    import jax.numpy as jnp

    cls, kw = MODELS[model_type]
    model = build_model(cls(**kw), device="cpu", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(5))
    pth = save_pose_model(model, tmp_path / f"{model_type}.pth", step=3)
    common = ["--checkpoint_path", str(pth), "--input_folder", str(folder),
              "--batch-size", "3"]
    monkeypatch.setattr(jfactory, "build_model", functools.partial(
        jfactory.build_model, dtype=jnp.float32))
    n_jax = jax_infer.main([*common, "--output_folder",
                            str(tmp_path / "jax")])
    monkeypatch.setattr(port_infer, "GlobalConfig", functools.partial(
        GlobalConfig, compute_dtype="float32"))
    lifts = []
    real = port_infer.make_lifter

    def spy(*a, **kw):
        lift = real(*a, **kw)

        def counted(raws, s1s):
            lifts.append(len(raws))
            return lift(raws, s1s)
        return counted

    monkeypatch.setattr(port_infer, "make_lifter", spy)
    n_port = port_infer.main([*common, "--output_folder",
                              str(tmp_path / "port"), "--device", "cpu"])
    assert n_port == n_jax == 4 and lifts == [3, 3]
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(files) == 4 and not any("noart" in f for f in files)
    for f in files:
        want = np.load(tmp_path / "jax" / f)
        got = np.load(tmp_path / "port" / f)
        assert got.shape == want.shape == (17, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(want).max()))


def test_infer_cli_panel_and_ema(folder, tmp_path):
    """``--visualize`` writes the 2×2 panel (two 500×500 rows of two);
    ``--ema`` reads a checkpoint directory's EMA weights and is refused for
    a ``.pth`` and for a directory without them."""
    cfg = CNNModelConfig(**TINY_CNN)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    pth = save_pose_model(model, tmp_path / "m.pth")
    out = tmp_path / "out"
    assert port_infer.main(["--checkpoint_path", str(pth), "--input_folder",
                            str(folder), "--output_folder", str(out),
                            "--device", "cpu", "--visualize"]) == 4
    panel = cv2.imread(str(out / "a_combined_viz.png"))
    assert panel.shape == (1000, 1000, 3)
    with pytest.raises(SystemExit, match="one set of weights"):
        port_infer.main(["--checkpoint_path", str(pth), "--input_folder",
                         str(folder), "--device", "cpu", "--ema"])
    d = port_convert.convert(str(pth), str(tmp_path / "dir"))
    with pytest.raises(SystemExit, match="no EMA"):
        port_infer.main(["--checkpoint_path", d, "--input_folder",
                         str(folder), "--device", "cpu", "--ema"])


def test_load_pose_model_reads_a_directory_and_its_ema(tmp_path):
    """``checkpoint.load_pose_model`` reads a training checkpoint directory:
    the live weights, or with ``ema`` the averaged parameters and BatchNorm
    statistics; an EMA of the parameters alone (an older checkpoint) keeps
    the live statistics and warns, as ``with_ema_params`` does;
    ``checkpoint_step`` reads the step of either checkpoint form."""
    from pose3d_tpu_torch.checkpoint import checkpoint_step, load_pose_model
    from pose3d_tpu_torch.train.state import batch_stats, create_train_state

    cfg = CNNModelConfig(**TINY_CNN)
    st = create_train_state(build_model(cfg, device="cpu",
                                        dtype=torch.float32, train=True),
                            ema=True)
    st.step = 7
    gen = torch.Generator().manual_seed(5)
    for t in (*st.ema_params.values(), *st.ema_batch_stats.values()):
        t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    live = {k: v.clone() for k, v in st.model.state_dict().items()}
    full = ckpt.save_checkpoint(tmp_path / "full", st, "cnn", cfg.to_dict())
    st.ema_batch_stats = None
    old = ckpt.save_checkpoint(tmp_path / "old", st, "cnn", cfg.to_dict())

    def load(path, ema):
        model, got = load_pose_model(path, "cpu", dtype=torch.float32,
                                     ema=ema)
        assert got == cfg and not model.training
        return model.state_dict()

    assert all(torch.equal(load(full, False)[k], v) for k, v in live.items())
    got = load(full, True)
    stats = batch_stats(st.model)
    assert stats and set(st.ema_params) | set(stats) <= set(got)
    ema = {**st.ema_params, **ckpt.load_checkpoint(full)[0]["ema_batch_stats"]}
    for k, v in got.items():
        assert torch.equal(v, ema.get(k, live[k])), k
    with pytest.warns(UserWarning, match="no ema_batch_stats"):
        got = load(old, True)
    for k, v in got.items():
        assert torch.equal(v, st.ema_params.get(k, live[k])), k
    assert checkpoint_step(full) == 7
    assert checkpoint_step(save_pose_model(st.model, tmp_path / "m.pth",
                                           step=3)) == 3


@pytest.mark.parametrize("argv", [
    ["--stage1", "jax"], ["--data-parallel"], ["--kp-weights", "k.pt"],
    ["--depth-weights", "d.safetensors"], ["--yolo_model_path", "y.pt"],
    ["--allow-untrained"], ["--kp-input-size", "640"],
    ["--yolo_confidence_threshold", "0.5"],
])
def test_infer_cli_refuses_stage1_flags(folder, tmp_path, argv, capsys,
                                        monkeypatch):
    """``--data-parallel`` beside ``--stage1 cached`` is refused before
    anything is written; with ``--stage1 jax`` it reaches the provider as
    ``mesh``: the JAX CLI's over every device, the port's over every
    device of ``--device`` (the CPU: one). Each stage-1 flag, with
    ``--stage1 jax``
    (and ``--allow-untrained``, or ``--kp-weights`` for the keypoint input
    size, where the flag alone would not reach the provider), reaches the
    provider as the same keyword arguments the JAX CLI passes, captured
    under a stubbed ``get_stage1_provider`` in both (the port adds its
    device); the lifter's load is stubbed in both. A ``--yolo_model_path``
    that does not exist is an error in both."""
    from types import SimpleNamespace

    from pose3d_tpu.cli import infer as jax_infer

    import pose3d_tpu_torch.checkpoint as port_ckpt
    import pose3d_tpu_torch.stage1 as port_stage1

    base = ["--checkpoint_path", str(tmp_path / "x.pth"), "--input_folder",
            str(folder), "--output_folder", str(tmp_path / "out")]
    if argv == ["--data-parallel"]:
        with pytest.raises(SystemExit) as e:
            port_infer.main([*base, "--device", "cpu", *argv])
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert argv[0] in err and "--stage1 jax" in err
        assert not (tmp_path / "out").exists()
    monkeypatch.chdir(tmp_path)
    extra = ["--allow-untrained", *(["--kp-weights", "k.pt"]
                                    if argv[0] == "--kp-input-size" else [])]
    cmd = [*base, "--stage1", "jax",
           *(argv if argv[0] != "--stage1" else []), *extra]
    seen = []

    class Stop(Exception):
        pass

    def capture(kind, **kw):
        seen.append((kind, kw))
        raise Stop

    monkeypatch.setattr(jax_infer, "load_pose_model",
                        lambda *a, **k: (None, None, None))
    monkeypatch.setattr(jax_infer, "get_stage1_provider", capture)
    monkeypatch.setattr(port_ckpt, "load_pose_model", lambda *a, **k: (
        None, SimpleNamespace(model_type="cnn")))
    monkeypatch.setattr(port_stage1, "get_stage1_provider", capture)
    if argv[0] == "--yolo_model_path":        # a missing path is an error
        for main in (jax_infer.main, lambda a: port_infer.main(
                [*a, "--device", "cpu"])):
            with pytest.raises(SystemExit, match="does not exist"):
                main(cmd)
    (tmp_path / "y.pt").write_bytes(b"")
    with pytest.raises(Stop):
        jax_infer.main(cmd)
    with pytest.raises(Stop):
        port_infer.main([*cmd, "--device", "cpu"])
    (jkind, jkw), (pkind, pkw) = seen
    assert jkind == pkind == "jax"
    assert pkw.pop("device") == torch.device("cpu")
    if argv == ["--data-parallel"]:
        assert jkw.pop("mesh").axis_names == ("data",)
        assert pkw.pop("mesh") == [torch.device("cpu")]
    assert pkw == jkw
    flag = {"--stage1": None, "--allow-untrained": None,
            "--data-parallel": None, "--yolo_model_path": "kp_weights"}.get(
        argv[0], argv[0].lstrip("-").replace("-", "_").replace(
            "yolo_confidence_threshold", "confidence_threshold"))
    if flag is not None:
        assert flag in pkw


# --- convert -------------------------------------------------------------------

def _assert_same(a, b, where=""):
    """Nested dicts, lists and tensors equal key for key, value for value
    (tensors bitwise, with their dtypes). One representation differs: the
    JAX writer stores BatchNorm's 0-d ``num_batches_tracked`` as a
    1-element array (``np.ascontiguousarray`` of a 0-d array), the port the
    torch module's own 0-d buffer; torch loads either into the reference
    model."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        if where.endswith("num_batches_tracked"):
            assert a.shape == () and b.shape == (1,), where
            a = a.reshape(1)
        assert torch.equal(a, b), where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("model_type", sorted(MODELS))
def test_convert_round_trip_matches_jax(tmp_path, model_type):
    """A ``.pth`` → checkpoint directory → ``--to-torch`` ``.pth`` through
    the port's converter and through ``pose3d_tpu.cli.convert``: the two
    output files are equal key for key (``step``, ``global_step``, the
    model state_dict in the reference's order, the optimizer's zero
    moments and step 0 for every parameter, ``param_groups``,
    ``model_args``, ``model_type``)."""
    from pose3d_tpu.cli import convert as jax_convert

    cls, kw = MODELS[model_type]
    model = build_model(cls(**kw), device="cpu", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(6))
    pth = save_pose_model(model, tmp_path / "in.pth", step=11)
    jax_convert.main([str(pth), str(tmp_path / "jdir")])
    jax_convert.main([str(tmp_path / "jdir"), str(tmp_path / "j.pth"),
                      "--to-torch"])
    assert port_convert.main([str(pth), str(tmp_path / "tdir")]) == 0
    assert ckpt.load_checkpoint_meta(tmp_path / "tdir")["step"] == 11
    assert port_convert.main([str(tmp_path / "tdir"), str(tmp_path / "t.pth"),
                              "--to-torch"]) == 0
    want = torch.load(tmp_path / "j.pth", weights_only=True)
    got = torch.load(tmp_path / "t.pth", weights_only=True)
    assert len(got["optimizer_state_dict"]["state"]) == len(
        list(model.parameters()))
    _assert_same(got, want)


def test_convert_exports_trained_moments_and_flags(tmp_path, capsys):
    """``--to-torch`` of a trained checkpoint carries its AdamW moments and
    per-parameter step (the reference AdamW resumes from them);
    ``--no-optimizer`` writes none, ``--lr``/``--weight-decay`` set
    ``param_groups``, ``--ema`` writes the EMA weights with no moments and
    is refused without them; the ``--to-torch`` flags are refused in the
    default direction."""
    from pose3d_tpu_torch.train.state import create_train_state

    cfg = CNNModelConfig(**TINY_CNN)
    model = build_model(cfg, device="cpu", dtype=torch.float32, train=True)
    state = create_train_state(model, ema=True)
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.5)
    state.optimizer.step()
    state.step = 1
    d = ckpt.save_checkpoint(tmp_path / "d", state, "cnn", cfg.to_dict())
    out = tmp_path / "o.pth"
    port_convert.main([str(d), str(out), "--to-torch", "--lr", "0.5",
                       "--weight-decay", "0.1"])
    got = torch.load(out, weights_only=True)
    saved = state.optimizer.state_dict()["state"]
    assert set(got["optimizer_state_dict"]["state"]) == set(saved)
    for i, s in saved.items():
        g = got["optimizer_state_dict"]["state"][i]
        assert torch.equal(g["exp_avg"], s["exp_avg"])
        assert torch.equal(g["exp_avg_sq"], s["exp_avg_sq"])
        assert float(g["step"]) == 1.0
    (group,) = got["optimizer_state_dict"]["param_groups"]
    assert group["lr"] == 0.5 and group["weight_decay"] == 0.1
    assert got["step"] == got["global_step"] == 1
    port_convert.main([str(d), str(out), "--to-torch", "--no-optimizer"])
    assert torch.load(out, weights_only=True)[
        "optimizer_state_dict"]["state"] == {}
    port_convert.main([str(d), str(out), "--to-torch", "--ema"])
    got = torch.load(out, weights_only=True)
    assert got["optimizer_state_dict"]["state"] == {}
    for n, e in state.ema_params.items():
        assert torch.equal(got["model_state_dict"][n], e)
    bare = ckpt.save_checkpoint(tmp_path / "bare", create_train_state(
        build_model(cfg, device="cpu", train=True)), "cnn", cfg.to_dict())
    with pytest.raises(ValueError, match="no EMA"):
        port_convert.main([str(bare), str(out), "--to-torch", "--ema"])
    with pytest.raises(SystemExit, match="--to-torch only"):
        port_convert.main([str(out), str(tmp_path / "x"), "--lr", "1"])

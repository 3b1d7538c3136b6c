"""pose3d_tpu_torch's stage-1 entry points against the JAX package's, on
the CPU with tiny weight files (YOLO11n-pose and a tiny DepthPro, both at
64²): ``cli.preprocess`` on the same folder writes the same artifacts
(keypoints to the pixel, confidences 1e-4, depth within one 8-bit level),
skips what exists and ``finished.txt`` folders, pads a ragged batch, keeps
the untrained gate and refuses ``--data-parallel``; ``cli.infer --stage1
jax`` gives the JAX CLI's joints (1e-3, lifters in fp32);
``make_pipeline_server`` answers ``/predict_image`` as JAX's does and
``/predict`` with 404, and its batcher coalesces concurrent images;
``cli.main --vit-weights`` initialises the transformer's backbone."""

import functools
import io
import json
import threading
import urllib.error
import urllib.request

import cv2
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

from pose3d_tpu_torch.checkpoint import save_pose_model
from pose3d_tpu_torch.cli import infer as port_infer
from pose3d_tpu_torch.cli import preprocess as port_pre
from pose3d_tpu_torch.core import config as port_config
from pose3d_tpu_torch.core.config import CNNModelConfig, GlobalConfig
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.serve_http import PipelineBatcher, make_pipeline_server
from pose3d_tpu_torch.stage1 import models as port_models

TINY_CNN = dict(
    image_size=(32, 32), heatmap_size=32, heatmap_sigma=2.0,
    stage_channels=(8, 16, 32), stage_depths=(1, 1, 1), initial_channels=8,
    global_pool_size=2, global_feature_dim=16, regression_dims=(16,),
)
# two subfolders of images of several sizes (PNG and JPEG)
FOLDERS = {"s1": ((60, 80), (72, 72), (50, 90)),
           "s2": ((64, 48), (40, 40))}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    write_yolo(d / "yolo.pt", seed=11)
    write_depthpro(d / "depthpro", seed=12)
    return str(d / "yolo.pt"), str(d / "depthpro" / "model.safetensors")


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames") / "in"
    for k, (name, sizes) in enumerate(FOLDERS.items()):
        (root / name).mkdir(parents=True)
        for i, im in enumerate(images(20 + k, sizes)):
            ext = ".jpg" if i % 2 else ".png"
            cv2.imwrite(str(root / name / f"f{i}{ext}"), im[..., ::-1])
    return root


@pytest.fixture
def small_inputs(monkeypatch):
    """Both CLIs' providers at the tiny networks' 64² (their CLIs have no
    input-size flags for the ported networks)."""
    from pose3d_tpu.stage1 import models as jax_models

    sizes = dict(kp_input_size=YOLO_S, depth_input_size=DEPTH_S)
    monkeypatch.setattr(jax_models, "JaxStage1", functools.partial(
        jax_models.JaxStage1, **sizes))
    monkeypatch.setattr(port_models, "TorchStage1", functools.partial(
        port_models.TorchStage1, **sizes))


def _read(out):
    arts = {}
    for p in sorted(out.rglob("*")):
        if p.suffix == ".json":
            arts[str(p.relative_to(out))] = json.loads(p.read_text())
        elif p.name.endswith("_depth.png"):
            arts[str(p.relative_to(out))] = cv2.imread(
                str(p), cv2.IMREAD_UNCHANGED)
    return arts


def test_preprocess_matches_the_jax_cli(folder, weights, tmp_path,
                                        small_inputs):
    """The same folder through both CLIs (batch 2: the odd folder's last
    batch padded): the same files; JSON with the same keys, sizes,
    skeleton and pixel keypoints (± 1 px for rounding), confidences 1e-4,
    the depth range rtol 1e-3; the depth PNGs within one level; each
    package's ``CachedStage1`` reads the other's."""
    from pose3d_tpu.cli import preprocess as jax_pre
    from pose3d_tpu.stage1.api import CachedStage1 as JaxCached

    from pose3d_tpu_torch.stage1 import CachedStage1

    yolo, depth = weights
    args = ["--kp-weights", yolo, "--depth-weights", depth,
            "--batch-size", "2"]
    n_jax = jax_pre.main([str(folder), str(tmp_path / "jax"), *args])
    n_port = port_pre.main([str(folder), str(tmp_path / "port"), *args,
                            "--device", "cpu"])
    assert n_jax == n_port == 5
    want, got = _read(tmp_path / "jax"), _read(tmp_path / "port")
    assert set(want) == set(got) and len(want) == 10
    for name, w in want.items():
        g = got[name]
        if name.endswith(".png"):
            assert g.shape == w.shape and g.dtype == np.uint8
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, name
            continue
        assert g.keys() == w.keys()
        for key in ("image_size", "depth_size", "skeleton"):
            assert g[key] == w[key], (name, key)
        np.testing.assert_allclose([g["depth_min"], g["depth_max"]],
                                   [w["depth_min"], w["depth_max"]],
                                   rtol=1e-3)
        for a, b in zip(g["keypoints"][0], w["keypoints"][0]):
            assert abs(a["x"] - b["x"]) <= 1 and abs(a["y"] - b["y"]) <= 1
            assert abs(a["conf"] - b["conf"]) <= 1e-4
    for name in FOLDERS:
        for img in sorted((folder / name).iterdir()):
            for out in ("jax", "port"):
                p = tmp_path / out / name / img.name
                a = CachedStage1().predict_one(p)
                b = JaxCached().predict_one(p)
                np.testing.assert_array_equal(a.keypoints, b.keypoints)
                np.testing.assert_array_equal(a.depth, b.depth)


def test_preprocess_resumes_and_pads(folder, weights, tmp_path,
                                     small_inputs, monkeypatch):
    """A second run processes nothing (``finished.txt``); a folder without
    the marker redoes only the images whose outputs are missing; a batch
    of 3 over 3 images then 2 runs stage 1 on 3 images each time (the
    short batch padded); ``cli()`` returns 0."""
    yolo, depth = weights
    sizes = []
    real = port_models.TorchStage1.func.predict_batch

    def spy(self, imgs):
        sizes.append(len(imgs))
        return real(self, imgs)

    monkeypatch.setattr(port_models.TorchStage1.func, "predict_batch", spy)
    argv = [str(folder), str(tmp_path / "out"), "--kp-weights", yolo,
            "--depth-weights", depth, "--batch-size", "3", "--device", "cpu"]
    assert port_pre.main(argv) == 5 and sizes == [3, 3]
    assert port_pre.main(argv) == 0 and sizes == [3, 3]
    (tmp_path / "out" / "s1" / "finished.txt").unlink()
    (tmp_path / "out" / "s1" / "f1.json").unlink()
    assert port_pre.main(argv) == 1 and sizes == [3, 3, 3]
    assert port_pre.cli(argv) == 0


def test_preprocess_gates(folder, tmp_path):
    """Without both weight files the untrained networks are refused unless
    ``--allow-untrained`` is given (then they write artifacts from a seeded
    generator); ``--data-parallel`` names ROADMAP.md."""
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match="--kp-weights/--depth-weights"):
        port_pre.main([str(folder), str(out), "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        port_pre.main([str(folder), str(out), "--data-parallel"])
    assert e.value.code == 2
    assert not out.exists()
    assert port_pre.main([str(folder), str(out), "--allow-untrained",
                          "--input-size", "64", "--device", "cpu"]) == 5
    meta = json.loads((out / "s2" / "f0.json").read_text())
    assert meta["image_size"] == [48, 64] and len(meta["keypoints"][0]) == 17
    d = cv2.imread(str(out / "s2" / "f0_depth.png"), cv2.IMREAD_UNCHANGED)
    assert d.shape == (64, 48) and meta["depth_max"] > meta["depth_min"] > 0


def _lifter_pth(tmp_path):
    model = build_model(CNNModelConfig(**TINY_CNN), device="cpu",
                        dtype=torch.float32,
                        generator=torch.Generator().manual_seed(5))
    return save_pose_model(model, tmp_path / "cnn.pth", step=3)


@pytest.fixture
def fp32_lifters(monkeypatch):
    """Both packages' lifters in fp32 (their default compute dtype is
    bf16)."""
    import jax.numpy as jnp

    from pose3d_tpu.models import factory as jfactory

    monkeypatch.setattr(jfactory, "build_model", functools.partial(
        jfactory.build_model, dtype=jnp.float32))
    fp32 = functools.partial(GlobalConfig, compute_dtype="float32")
    monkeypatch.setattr(port_infer, "GlobalConfig", fp32)
    monkeypatch.setattr(port_config, "GlobalConfig", fp32)


def test_infer_stage1_jax_matches_the_jax_cli(folder, weights, tmp_path,
                                              fp32_lifters):
    """``--stage1 jax`` with both weight files, ``--allow-untrained`` and
    the input sizes from the command line, at ``--batch-size 2`` (a batch
    of one padded): the same files and joints within 1e-3."""
    from pose3d_tpu.cli import infer as jax_infer

    yolo, depth = weights
    pth = _lifter_pth(tmp_path)
    common = ["--checkpoint_path", str(pth), "--input_folder",
              str(folder / "s1"), "--stage1", "jax", "--kp-weights", yolo,
              "--depth-weights", depth, "--kp-input-size", str(YOLO_S),
              "--depth-input-size", str(DEPTH_S), "--allow-untrained",
              "--batch-size", "2"]
    n_jax = jax_infer.main([*common, "--output_folder",
                            str(tmp_path / "jax")])
    n_port = port_infer.main([*common, "--output_folder",
                              str(tmp_path / "port"), "--device", "cpu"])
    assert n_jax == n_port == 3
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    for f in files:
        np.testing.assert_allclose(np.load(tmp_path / "port" / f),
                                   np.load(tmp_path / "jax" / f), rtol=0,
                                   atol=1e-3)


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return dict(np.load(io.BytesIO(r.read())))


def _serve(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    for _ in range(1200):
        if srv.ready or srv.warmup_error:
            break
        threading.Event().wait(0.05)
    assert srv.ready, srv.warmup_error
    return thread


def _stop(srv, thread):
    srv.shutdown()
    srv.batcher.close()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_pipeline_server_matches_jax(weights, tmp_path, fp32_lifters):
    """One ``.pth`` and the two weight files behind both packages'
    ``make_pipeline_server``: each encoded image's joints (1e-3) and
    keypoints (1e-4) agree; the port's ``/predict`` is 404."""
    from pose3d_tpu import serve_http as jax_serve

    yolo, depth = weights
    pth = _lifter_pth(tmp_path)
    s1 = dict(kp_weights=yolo, depth_weights=depth, kp_input_size=YOLO_S,
              depth_input_size=DEPTH_S, confidence_threshold=0.2)
    srvs = [make_pipeline_server(pth, "127.0.0.1", 0, device="cpu",
                                 stage1_kwargs=s1),
            jax_serve.make_pipeline_server(pth, "127.0.0.1", 0,
                                           stage1_kwargs=s1)]
    threads = [_serve(s) for s in srvs]
    try:
        for im in images(30, ((60, 80), (72, 72))):
            ok, enc = cv2.imencode(".png", im[..., ::-1])
            got, want = (_post(f"http://127.0.0.1:{s.server_port}"
                               "/predict_image", enc.tobytes())
                         for s in srvs)
            assert got["joints_3d"].shape == (17, 3)
            np.testing.assert_allclose(got["joints_3d"], want["joints_3d"],
                                       rtol=0, atol=1e-3)
            np.testing.assert_allclose(got["keypoints"], want["keypoints"],
                                       rtol=0, atol=1e-4)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"http://127.0.0.1:{srvs[0].server_port}/predict", b"x")
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"http://127.0.0.1:{srvs[0].server_port}/predict_image",
                  b"not an image")
        assert e.value.code == 400
    finally:
        for s, t in zip(srvs, threads):
            _stop(s, t)


def test_pipeline_batcher_coalesces_concurrent_images():
    """Four single-image requests inside the wait window form one device
    batch of four in the port; the JAX package's batcher counts the first
    image's height as the request's size, so it runs each request alone
    (ROADMAP.md Queue 3, F10)."""
    from pose3d_tpu.serve_http import PipelineBatcher as JaxBatcher

    def call(imgs):
        calls.append(len(imgs))
        n = len(imgs)
        return np.zeros((n, 17, 3)), np.zeros((n, 17, 3))

    for cls, want in ((PipelineBatcher, [4]), (JaxBatcher, [1, 1, 1, 1])):
        calls = []
        b = cls(call, max_batch=8, max_wait_ms=2000)
        try:
            futs = [b.submit([np.zeros((40, 30, 3), np.uint8)])
                    for _ in range(4)]
            res = [f.result(timeout=30) for f in futs]
        finally:
            b.close()
        assert calls == want, cls
        assert all(r["joints_3d"].shape == (1, 17, 3) for r in res)


def test_vit_weights_from_the_cli(tmp_path, monkeypatch):
    """``cli.main --vit-weights`` with a timm-named file: the transformer
    starts from ``port_vit_backbone`` of it (the patch embedding inflated
    to 4 channels, the position grid resized)."""
    from helpers_synthetic import make_synthetic_chunk

    from pose3d_tpu_torch.cli import main as port_main
    from pose3d_tpu_torch.stage1.port import port_vit_backbone

    d = tmp_path / "chunks"
    d.mkdir()
    make_synthetic_chunk(d, 0, num_samples=4, image_hw=(40, 48), seed=2,
                         num_actions=2)
    make_synthetic_chunk(d, 1, num_samples=4, image_hw=(40, 48),
                         prefix="test", seed=3, num_actions=2)
    D, depth = 32, 1
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    timm = {"cls_token": r(1, 1, D), "pos_embed": r(1, 5, D),
            "patch_embed.proj.weight": r(D, 3, 16, 16),
            "patch_embed.proj.bias": r(D), "norm.weight": r(D),
            "norm.bias": r(D)}
    for name, shape in (("norm1", (D,)), ("attn.qkv", (3 * D, D)),
                        ("attn.proj", (D, D)), ("norm2", (D,)),
                        ("mlp.fc1", (4 * D, D)), ("mlp.fc2", (D, 4 * D))):
        timm[f"blocks.0.{name}.weight"] = r(*shape)
        timm[f"blocks.0.{name}.bias"] = r(shape[0])
    torch.save({"state_dict": timm}, tmp_path / "vit.pth")
    seen = {}

    def stop(state, *a, **kw):
        seen["vit"] = {k: v.clone() for k, v in
                       state.model.vit_backbone.state_dict().items()}
        return state, 0

    monkeypatch.setattr(port_main, "train_model", stop)
    monkeypatch.chdir(tmp_path)
    tiny = dict(image_size=[32, 32], heatmap_size=32, heatmap_patch_size=16,
                transformer_embed_dim=D, transformer_heads=2,
                vit_depth=depth, vit_heads=2, final_encoder_depth=1,
                num_cross_modal_layers=1, regression_hidden_dims=[16])
    port_main.main(["--chunks-dir", str(d), "--device", "cpu",
                    "--model-type", "transformer", "--model-args",
                    json.dumps(tiny), "--vit-weights",
                    str(tmp_path / "vit.pth"), "--no-tensorboard",
                    "--train-chunks", "0", "--val-chunks", "1"])
    want = port_vit_backbone(timm, depth=depth, in_channels=4,
                             num_patches=4)
    assert set(seen["vit"]) == set(want)
    for k, v in want.items():
        assert torch.equal(seen["vit"][k], v), k

"""pose3d_tpu_torch serving path on the CPU: a JAX checkpoint converted by
``pose3d-convert --to-torch`` is loaded by the port and served over HTTP;
the answers equal the JAX model's. Plus the checkpoint loader's errors and
the package's independence from JAX."""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_helpers import TINY_KW, inputs, jax_forward, jax_model

from pose3d_tpu_torch.checkpoint import load_pose_model, save_pose_model
from pose3d_tpu_torch.core.config import TransformerModelConfig
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.serve_http import make_server

ROOT = Path(__file__).resolve().parents[1]


def _convert_jax_checkpoint(tmp_path, seed=3):
    """JAX init → save_checkpoint → pose3d-convert --to-torch → .pth."""
    from pose3d_tpu.cli.convert import main as convert_main
    from pose3d_tpu.train import create_train_state
    from pose3d_tpu.train.checkpoint import save_checkpoint

    cfg, model, variables = jax_model(seed)
    state = create_train_state(model, variables)
    ck = save_checkpoint(tmp_path / "ckpt", state, "transformer",
                         json.loads(json.dumps(cfg.to_dict())))
    pth = tmp_path / "lifter.pth"
    assert convert_main([str(ck), str(pth), "--to-torch"]) == 0
    return pth, model, variables


def _npz(arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, image=arrays[0], depth=arrays[1], keypoints_2d=arrays[2])
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return np.load(io.BytesIO(r.read()))["joints_3d"]


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_converted_jax_checkpoint_served_over_http(tmp_path):
    pth, jmodel, variables = _convert_jax_checkpoint(tmp_path)
    srv = make_server(pth, "127.0.0.1", 0, device="cpu",
                      dtype=torch.float32, max_batch=4, max_wait_ms=20.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_port}"
    try:
        for _ in range(600):
            try:
                if _get(base + "/healthz")[0] == 200:
                    break
            except urllib.error.HTTPError as e:
                assert e.code == 503
            threading.Event().wait(0.05)
        assert srv.ready, srv.warmup_error
        batches = [1, 2, 3, 1]
        reqs = [inputs(20 + i, b) for i, b in enumerate(batches)]
        with ThreadPoolExecutor(len(reqs)) as ex:
            answers = list(ex.map(
                lambda a: _post(base + "/predict", _npz(a)), reqs))
        for b, a, got in zip(batches, reqs, answers):
            want = jax_forward(jmodel, variables, a)
            assert got.shape == (b, 17, 3)
            tol = 1e-4 * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)

        status, meta = _get(base + "/meta")
        assert status == 200
        stats = meta["batching"]
        assert stats["samples_served"] == 1 + sum(batches)  # + warmup
        assert 2 <= stats["device_calls"] <= 1 + len(batches)
        assert meta["image_size"] == [64, 64] and meta["num_joints"] == 17
        assert meta["artifact"]["model_type"] == "transformer"
        assert meta["artifact"]["device"] == "cpu"

        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(base + "/predict", b"not an npz")
        assert bad.value.code == 400
        img, dep, kpt = inputs(5, 1)
        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(base + "/predict", _npz((img[:, :32], dep, kpt)))
        assert bad.value.code == 400
        assert _get(base + "/meta")[1]["batching"]["device_calls"] \
            == stats["device_calls"]
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_cuda_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = TransformerModelConfig(**TINY_KW)
    pth = save_pose_model(
        build_model(cfg, device="cpu", dtype=torch.float32),
        tmp_path / "m.pth")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_server(pth, "127.0.0.1", 0)  # device defaults to cuda


def test_save_load_round_trip_and_loader_forms(tmp_path):
    cfg = TransformerModelConfig(**TINY_KW)
    model = build_model(cfg, device="cpu", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(7))
    pth = save_pose_model(model, tmp_path / "m.pth", step=4)
    ckpt = torch.load(pth, weights_only=True)
    assert ckpt["model_type"] == "transformer" and ckpt["step"] == 4
    assert ckpt["model_args"]["image_size"] == (64, 64)
    loaded, cfg2 = load_pose_model(pth, "cpu", dtype=torch.float32)
    assert cfg2 == cfg
    args = [torch.from_numpy(a) for a in inputs(1, 2)]
    with torch.inference_mode():
        want = model(*args)
        assert torch.equal(loaded(*args), want)

    # image_size as a list (JSON round trip) and DDP "module." prefixes
    ckpt["model_args"]["image_size"] = [64, 64]
    ckpt["model_state_dict"] = {"module." + k: v for k, v in
                                ckpt["model_state_dict"].items()}
    torch.save(ckpt, tmp_path / "ddp.pth")
    loaded, _ = load_pose_model(tmp_path / "ddp.pth", "cpu",
                                dtype=torch.float32)
    with torch.inference_mode():
        assert torch.equal(loaded(*args), want)


def test_loader_rejects_unreadable_checkpoints(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_pose_model(tmp_path / "missing.pth", "cpu")
    (tmp_path / "junk.pth").write_bytes(b"junk")
    with pytest.raises(ValueError, match="cannot read"):
        load_pose_model(tmp_path / "junk.pth", "cpu")
    torch.save({"weights": [1, 2]}, tmp_path / "odd.pth")
    with pytest.raises(ValueError, match="neither"):
        load_pose_model(tmp_path / "odd.pth", "cpu")
    cfg = TransformerModelConfig(**TINY_KW)
    pth = save_pose_model(
        build_model(cfg, device="cpu", dtype=torch.float32),
        tmp_path / "m.pth")
    ckpt = torch.load(pth, weights_only=True)
    ckpt["model_args"]["vit_depth"] = 3  # architecture no longer fits
    torch.save(ckpt, tmp_path / "wrong.pth")
    with pytest.raises(ValueError, match="do not fit"):
        load_pose_model(tmp_path / "wrong.pth", "cpu")
    ckpt["model_type"] = "cnn"
    torch.save(ckpt, tmp_path / "cnn.pth")
    ckpt["model_args"] = {}     # transformer weights under a CNN's name
    torch.save(ckpt, tmp_path / "cnn.pth")
    with pytest.raises(ValueError, match="do not fit the cnn"):
        load_pose_model(tmp_path / "cnn.pth", "cpu")


def test_port_imports_no_jax():
    """In a fresh process, importing every module of the port (the package
    is walked; the inference, export, conversion and preprocess CLIs,
    ``serve`` and the stage-1 modules among them) and running a tiny
    lifter of each kind loads nothing of JAX, flax or the JAX package, nor
    transformers, safetensors, timm or ultralytics."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import pose3d_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    pose3d_tpu_torch.__path__, 'pose3d_tpu_torch.')]\n"
        "assert len(names) > 20, names\n"
        "assert {'pose3d_tpu_torch.cli.infer', 'pose3d_tpu_torch.cli.export',\n"
        "        'pose3d_tpu_torch.cli.convert', 'pose3d_tpu_torch.serve',\n"
        "        'pose3d_tpu_torch.stage1.api', 'pose3d_tpu_torch.stage1.port',\n"
        "        'pose3d_tpu_torch.stage1.yolo11',\n"
        "        'pose3d_tpu_torch.stage1.yolo_port',\n"
        "        'pose3d_tpu_torch.stage1.depthpro',\n"
        "        'pose3d_tpu_torch.stage1.depthpro_port',\n"
        "        'pose3d_tpu_torch.stage1.models',\n"
        "        'pose3d_tpu_torch.cli.preprocess'} <= set(names), names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from pose3d_tpu_torch.core.config import (CNNModelConfig,\n"
        "    TransformerModelConfig)\n"
        "from pose3d_tpu_torch.models import build_model, dummy_inputs\n"
        "cfgs = [TransformerModelConfig(image_size=(32, 32),\n"
        "    heatmap_size=16, transformer_embed_dim=32,\n"
        "    transformer_heads=2, vit_depth=1, vit_heads=2,\n"
        "    final_encoder_depth=1, num_cross_modal_layers=1),\n"
        "    CNNModelConfig(image_size=(32, 32), heatmap_size=32,\n"
        "    initial_channels=8, stage_channels=(8, 8, 16),\n"
        "    stage_depths=(1, 1, 1), global_pool_size=2,\n"
        "    global_feature_dim=16, regression_dims=(16,))]\n"
        "for cfg in cfgs:\n"
        "    with torch.inference_mode():\n"
        "        out = build_model(cfg, device='cpu', dtype=torch.float32)(\n"
        "            *dummy_inputs(cfg, 2, 'cpu'))\n"
        "    assert out.shape == (2, 17, 3) and torch.isfinite(out).all()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                 'pose3d_tpu', 'transformers', 'safetensors',\n"
        "                 'timm', 'ultralytics'))\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "ok"

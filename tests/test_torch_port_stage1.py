"""pose3d_tpu_torch's YOLO11-pose, its loaders and the shared weight
helpers against the JAX package's: YOLO11n-pose at 64² with the JAX
variables carried across by ``compat.stage1_state_dict_from_jax`` (raw
heads rtol 1e-4 / atol 2e-4, decoded boxes and keypoints 5e-3 px,
confidences 1e-5, the best person and NMS with equal indices and values
to 1e-4), the loaders on real file formats (a replica state_dict, an
ultralytics-style pickle through the stub unpickler, ``.safetensors``
through the port's own reader), ``port_vit_backbone``, and that the
stage-1 modules import neither cv2 at their top nor anything of JAX."""

import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_stage1_helpers import YOLO_S, to_np, write_yolo, yolo_replica

from pose3d_tpu.stage1 import yolo11 as jyolo
from pose3d_tpu.stage1 import yolo_port as jyolo_port

from pose3d_tpu_torch.compat import stage1_state_dict_from_jax
from pose3d_tpu_torch.ops.kernels import flash_attention
from pose3d_tpu_torch.stage1 import port, yolo11, yolo_port

STAGE1_MODULES = ("port", "yolo11", "yolo_port", "depthpro", "depthpro_port",
                  "models", "api")


@pytest.fixture(scope="module")
def bridged():
    """(JAX YOLO11n, numpy variables with non-trivial statistics, the
    port's module with them bridged, seeded images [2, 64, 64, 3], the JAX
    raw heads)."""
    jm = jyolo.YOLO11Pose(scale="n", dtype=jnp.float32)
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(2, YOLO_S, YOLO_S, 3)).astype(np.float32)
    v = to_np(jax.jit(lambda x: jm.init(jax.random.PRNGKey(2), x,
                                        train=False))(img))
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.2, 0.6, a.shape)).astype(np.float32),
        v["batch_stats"])
    pm = yolo11.YOLO11Pose("n")
    pm.load_state_dict(stage1_state_dict_from_jax(v, "yolo11"), strict=True)
    pm.eval()
    raw = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, img)
    return jm, v, pm, img, raw


def _port_raw(pm, img, **kw):
    with torch.no_grad():
        return pm(torch.from_numpy(img).permute(0, 3, 1, 2), **kw)


def test_yolo_raw_heads_match_jax(bridged):
    _, _, pm, img, jraw = bridged
    for lvl, (j, t) in enumerate(zip(jraw, _port_raw(pm, img))):
        for name, a, b in zip(("box", "cls", "kpt"), j, t):
            np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(a), rtol=1e-4, atol=2e-4,
                                       err_msg=f"level {lvl} {name}")


def test_yolo_decode_matches_jax(bridged):
    _, _, pm, img, jraw = bridged
    jb, js, jk = (np.asarray(a) for a in jyolo.decode_pose(jraw))
    tb, ts, tk = (a.numpy() for a in yolo11.decode_pose(_port_raw(pm, img)))
    np.testing.assert_allclose(tb, jb, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tk[..., :2], jk[..., :2], rtol=1e-4,
                               atol=5e-3)
    np.testing.assert_allclose(tk[..., 2], jk[..., 2], rtol=1e-4, atol=1e-5)


def test_best_person_and_nms_match_jax(bridged):
    """The best person (the argmax's index, keypoints and confidence to
    1e-4) and greedy NMS over a fixed budget (the kept detections' order
    and keypoints, confidences to 1e-4)."""
    _, _, pm, img, jraw = bridged
    raw = _port_raw(pm, img)
    jkp, jconf = jyolo.best_person_keypoints(jraw, YOLO_S)
    tkp, tconf = yolo11.best_person_keypoints(raw, YOLO_S)
    np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), atol=1e-4)
    np.testing.assert_allclose(tconf.numpy(), np.asarray(jconf), atol=1e-4)
    _, js, _ = jyolo.decode_pose(jraw)
    _, ts, _ = yolo11.decode_pose(raw)
    assert np.array_equal(np.asarray(js).max(-1).argmax(1),
                          ts.numpy().max(-1).argmax(1))
    for thr in (0.0, float(np.median(np.asarray(js)))):
        jk, jc = jyolo.nms_persons(*jyolo.decode_pose(jraw), max_det=5,
                                   conf_threshold=thr)
        tk, tc = yolo11.nms_persons(*yolo11.decode_pose(raw), max_det=5,
                                    conf_threshold=thr)
        assert tk.shape == (2, 5, 17, 3) and tc.shape == (2, 5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4)


def test_nms_ties_go_to_the_lower_index():
    """Equal confidences: ``jax.lax.top_k`` takes the lower index first;
    so does the port (a stable sort, where ``torch.topk`` promises no
    order), through the candidate pool and the final selection."""
    A, J = 40, 17
    rng = np.random.default_rng(0)
    boxes = np.zeros((1, A, 4), np.float32)
    boxes[0, :, 0] = np.arange(A) * 100.0          # disjoint: none suppressed
    boxes[0, :, 2:] = 10.0
    scores = np.full((1, A, 1), 0.5, np.float32)
    scores[0, ::7, 0] = 0.9
    kpts = rng.normal(size=(1, A, J, 3)).astype(np.float32)
    jk, jc = jyolo.nms_persons(boxes, scores, kpts, max_det=10,
                               conf_threshold=0.0)
    tk, tc = yolo11.nms_persons(*map(torch.from_numpy, (boxes, scores,
                                                        kpts)),
                                max_det=10, conf_threshold=0.0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_letterbox_params_match_jax():
    for h, w, s in ((1000, 1000, 640), (480, 640, 640), (50, 70, 64),
                    (81, 40, 64)):
        assert yolo11.letterbox_params(h, w, s) == \
            jyolo.letterbox_params(h, w, s)


def test_psa_attention_backends_on_the_cpu(bridged):
    """``attention_backend="pallas"`` on CPU tensors runs the kernel's
    plain version (no launch) and equals ``"xla"``; an unknown backend is
    refused."""
    _, _, pm, img, _ = bridged
    ref = _port_raw(pm, img)
    psa = [m for m in pm.modules() if isinstance(m, yolo11.Attention)]
    assert len(psa) == 1 and (psa[0].key_dim, psa[0].head_dim) == (32, 64)
    before = flash_attention.flash_attention_fwd.launches
    for m in psa:
        m.impl = yolo11.attention_impl("pallas")
    try:
        got = _port_raw(pm, img)
    finally:
        for m in psa:
            m.impl = yolo11.attention_impl("xla")
    assert flash_attention.flash_attention_fwd.launches == before
    for a, b in zip(ref, got):
        for x, y in zip(a, b):
            torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="attention_backend"):
        yolo11.YOLO11Pose("n", attention_backend="cuda")


@pytest.mark.parametrize("scale", ["n", "s"])
def test_replica_file_loads_strict_and_matches(tmp_path, scale):
    """A replica's plain state_dict ``.pt`` → ``load_yolo11_pose``: the
    architecture the JAX loader infers, a strict load (without
    ``num_batches_tracked`` and the DFL), and the replica's raw heads and
    full ultralytics decode."""
    replica = yolo_replica(4, scale)
    path = tmp_path / "y.pt"
    torch.save(replica.state_dict(), path)
    sd = yolo_port.load_ultralytics_state_dict(path)
    assert yolo_port.infer_architecture(sd) == jyolo_port.infer_architecture(
        {k: v.numpy() for k, v in sd.items()})
    model = yolo_port.load_yolo11_pose(path, device="cpu")
    assert not any(k.endswith("num_batches_tracked") or ".dfl." in k
                   for k in model.state_dict())
    img = torch.rand(2, 3, YOLO_S, YOLO_S, generator=torch.Generator()
                     .manual_seed(5))
    with torch.no_grad():
        want, got = replica.forward_raw(img), model(img)
        dec = replica(img)
    for a, b in zip(want, got):
        for x, y in zip(a, b):
            torch.testing.assert_close(y, x, rtol=1e-4, atol=2e-4)
    boxes, scores, kpts = yolo11.decode_pose(got)
    torch.testing.assert_close(boxes, dec[:, :4].transpose(1, 2),
                               rtol=1e-4, atol=5e-3)
    torch.testing.assert_close(scores, dec[:, 4:5].transpose(1, 2),
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(kpts.reshape(2, -1, 51),
                               dec[:, 5:].transpose(1, 2), rtol=1e-4,
                               atol=5e-3)


def test_ultralytics_pickle_through_the_stub_unpickler(tmp_path, caplog):
    """A checkpoint pickled with ultralytics class references (as
    ``tests/test_yolo11_port.py`` writes one) loads without the package:
    the same tensors as the JAX loader reads, and the stub modules are gone
    afterwards."""
    inner = yolo_replica(1)
    fake = types.ModuleType("ultralytics.nn.tasks")
    PoseModel = type("PoseModel", (torch.nn.Module,),
                     {"__module__": "ultralytics.nn.tasks"})
    fake.PoseModel = PoseModel
    wrapper = PoseModel()
    wrapper.model = inner.model
    mods = {"ultralytics": types.ModuleType("ultralytics"),
            "ultralytics.nn": types.ModuleType("ultralytics.nn"),
            "ultralytics.nn.tasks": fake}
    sys.modules.update(mods)
    try:
        path = tmp_path / "fake_yolo11n-pose.pt"
        torch.save({"model": wrapper, "train_args": {}}, path)
    finally:
        for name in mods:
            sys.modules.pop(name, None)
    sd = yolo_port.load_ultralytics_state_dict(path)
    assert "weights_only=True" in caplog.text
    assert not any(m.startswith("ultralytics") for m in sys.modules)
    ref = jyolo_port.load_ultralytics_state_dict(path)
    assert set(sd) == set(ref) == set(inner.state_dict())
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k])
    model = yolo_port.load_yolo11_pose(path, device="cpu")
    assert model.scale == "n"


def test_dfl_weights_other_than_arange_are_logged(tmp_path, caplog):
    replica = yolo_replica(2)
    sd = replica.state_dict()
    sd["model.23.dfl.conv.weight"] = sd["model.23.dfl.conv.weight"] * 2
    torch.save(sd, tmp_path / "y.pt")
    yolo_port.load_yolo11_pose(tmp_path / "y.pt", device="cpu")
    assert "DFL weights differ from arange" in caplog.text


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_read_safetensors_dtypes(tmp_path, dtype):
    """The port's own ``.safetensors`` reader against the ``safetensors``
    package's writer: each dtype, shapes with a 0-d and an empty tensor,
    and the header's metadata skipped; ``load_torch_state_dict`` gives
    fp32."""
    st = pytest.importorskip("safetensors.torch")
    tdt = {"F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16}[dtype]
    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(3, 5, generator=g).to(tdt),
               "b": torch.randn(7, generator=g).to(tdt),
               "scalar": torch.tensor(2.5).to(tdt),
               "empty": torch.zeros(0, 4).to(tdt),
               "idx": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    path = tmp_path / "w.safetensors"
    st.save_file(tensors, str(path), metadata={"format": "pt"})
    got = port.read_safetensors(path)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    fp32 = port.load_torch_state_dict(path)
    assert all(v.dtype == torch.float32 for v in fp32.values())
    torch.testing.assert_close(fp32["a.weight"], tensors["a.weight"].float())


def test_yolo_safetensors_written_by_numpy(tmp_path):
    """A ``safetensors.numpy.save_file`` export of a YOLO state_dict loads
    through the port's reader like its ``.pt``."""
    stn = pytest.importorskip("safetensors.numpy")
    replica = write_yolo(tmp_path / "y.pt", seed=6)
    stn.save_file({k: v.numpy() for k, v in replica.state_dict().items()},
                  str(tmp_path / "y.safetensors"))
    a = yolo_port.load_yolo11_pose(tmp_path / "y.pt", device="cpu")
    b = yolo_port.load_yolo11_pose(tmp_path / "y.safetensors", device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka


def test_fold_and_unfold_paths():
    from pose3d_tpu.stage1.port import fold_torch_path as jfold

    for key in ("model.23.cv3.0.0.0", "model.10.m.0.attn.qkv",
                "depth_pro.neck.fuse_image_with_low_res",
                "fusion_stage.intermediate.0.residual_layer1.convolution2",
                "encoder.layer.11.layer_scale1",
                "depth_pro.neck.feature_upsample.scaled_images.2.layers.1"):
        assert port.fold_torch_path(key) == jfold(key)
        assert port.unfold_flax_path(port.fold_torch_path(key)) == key


def test_port_vit_backbone_matches_jax():
    """A random state_dict with timm's ViT names (3 input channels, a 6×6
    position grid) → ``port_vit_backbone`` at 4 channels and an 8×8 grid,
    against the JAX ``port_vit_backbone`` merged into the JAX transformer
    and carried across by ``compat.state_dict_from_jax``; it strict-loads
    into the port's ``vit_backbone``."""
    from pose3d_tpu.core.config import TransformerModelConfig as JCfg
    from pose3d_tpu.models import init_model
    from pose3d_tpu.stage1.port import merge_params
    from pose3d_tpu.stage1.port import port_vit_backbone as jport

    from pose3d_tpu_torch.compat import state_dict_from_jax
    from pose3d_tpu_torch.core.config import TransformerModelConfig
    from pose3d_tpu_torch.models import build_model

    from torch_port_helpers import TINY_KW

    D, depth, heads = 64, 2, 4
    rng = np.random.default_rng(7)
    r = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    timm = {"cls_token": r(1, 1, D), "pos_embed": r(1, 37, D),
            "patch_embed.proj.weight": r(D, 3, 16, 16),
            "patch_embed.proj.bias": r(D), "norm.weight": r(D),
            "norm.bias": r(D)}
    for i in range(depth):
        b = f"blocks.{i}."
        timm.update({b + "norm1.weight": r(D), b + "norm1.bias": r(D),
                     b + "attn.qkv.weight": r(3 * D, D),
                     b + "attn.qkv.bias": r(3 * D),
                     b + "attn.proj.weight": r(D, D),
                     b + "attn.proj.bias": r(D), b + "norm2.weight": r(D),
                     b + "norm2.bias": r(D),
                     b + "mlp.fc1.weight": r(4 * D, D),
                     b + "mlp.fc1.bias": r(4 * D),
                     b + "mlp.fc2.weight": r(D, 4 * D),
                     b + "mlp.fc2.bias": r(D)})
    got = port.port_vit_backbone({k: torch.from_numpy(v)
                                  for k, v in timm.items()}, depth=depth,
                                 in_channels=4, num_patches=16)
    jcfg = JCfg(**TINY_KW)
    _, variables = init_model(jcfg, rng=jax.random.PRNGKey(0),
                              dtype=jnp.float32, attention_backend="xla")
    variables = merge_params(to_np(variables),
                             jport(timm, num_heads=heads, depth=depth,
                                   in_channels=4, num_patches=16),
                             "vit_backbone")
    cfg = TransformerModelConfig(**TINY_KW)
    want = {k[len("vit_backbone."):]: v
            for k, v in state_dict_from_jax(to_np(variables), cfg).items()
            if k.startswith("vit_backbone.")}
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6,
                                   msg=k)
    model = build_model(cfg, device="cpu")
    model.vit_backbone.load_state_dict(got, strict=True)


def test_stage1_modules_import_no_cv2_or_jax():
    """In a process where cv2, JAX, flax, transformers, safetensors, timm
    and ultralytics cannot be imported, every stage-1 module and CLI of the
    port imports, and none of them pulls in cv2 or the JAX package."""
    blocked = ("cv2", "jax", "flax", "transformers", "safetensors", "timm",
               "ultralytics", "pose3d_tpu")
    code = f"""
import sys
for m in {blocked!r}:
    sys.modules[m] = None
import importlib
for m in {STAGE1_MODULES!r}:
    importlib.import_module("pose3d_tpu_torch.stage1." + m)
for m in ("cli.preprocess", "cli.infer", "cli.main", "serve_http",
          "compat"):
    importlib.import_module("pose3d_tpu_torch." + m)
bad = [m for m in sys.modules if sys.modules[m] is not None and
       (m == "cv2" or m.split(".")[0] in {blocked!r})]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_loaders_default_to_the_card(tmp_path):
    """Without CUDA, the loaders and backends raise unless the CPU is
    asked for; never a silent fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    write_yolo(tmp_path / "y.pt")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        yolo_port.load_yolo11_pose(tmp_path / "y.pt")
    from pose3d_tpu_torch.stage1.models import TorchStage1

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchStage1()

"""pose3d_tpu_torch's package-level names and the last public functions it
ported: every name a JAX package's ``__init__`` exports (but the
``jax.sharding`` objects) imports from the matching package of the port,
importing the packages loads no OpenCV, matplotlib, PIL, TensorBoard or
JAX, and ``gaussian_heatmaps_nchw``, ``inter_joint_distance_loss``,
``abs_root_distance_loss``, ``make_predict_fn`` and ``ensure_dirs`` against
their JAX counterparts."""

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import TINY_KW, inputs, jax_model

from pose3d_tpu.core import config as jcfg
from pose3d_tpu.ops import heatmap as jheat
from pose3d_tpu.ops import losses as jloss
from pose3d_tpu.train.step import make_predict_fn as jax_make_predict_fn

from pose3d_tpu_torch.compat import state_dict_from_jax
from pose3d_tpu_torch.core import config as tcfg
from pose3d_tpu_torch.core.mesh import make_mesh
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.ops import heatmap as theat
from pose3d_tpu_torch.ops import losses as tloss
from pose3d_tpu_torch.train.step import make_predict_fn

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("train", "core", "data", "geometry", "ops", "viz")
# jax.sharding objects, which a step of the port has no use for
NOT_PORTED = {"core": {"data_sharding", "replicated"}}


def _jax_exports(pkg: str) -> set:
    """The names ``pose3d_tpu/<pkg>/__init__.py`` imports, read from its
    source (importing it would load what it loads)."""
    tree = ast.parse((ROOT / "pose3d_tpu" / pkg / "__init__.py").read_text())
    return {a.asname or a.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) for a in node.names}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_name_of_a_jax_package_imports_from_the_port(pkg):
    import importlib

    names = _jax_exports(pkg) - NOT_PORTED.get(pkg, set())
    port = importlib.import_module(f"pose3d_tpu_torch.{pkg}")
    assert set(port.__all__) == names
    for name in sorted(names):
        ns = {}
        exec(f"from pose3d_tpu_torch.{pkg} import {name}", ns)
        assert ns[name] is getattr(port, name)
        home = getattr(ns[name], "__module__", None)
        assert home is None or home.startswith("pose3d_tpu_torch."), name
    with pytest.raises(AttributeError, match="no attribute"):
        getattr(port, "not_a_name")


def test_importing_the_packages_loads_no_heavy_module():
    """In a fresh process: importing the six packages, and reading one
    re-exported name of each, loads none of OpenCV, matplotlib, PIL,
    TensorBoard, JAX, flax or the JAX package."""
    code = f"""
import importlib, json, sys
banned = ("cv2", "matplotlib", "PIL", "tensorboard", "jax", "flax",
          "pose3d_tpu")
loaded = lambda: sorted(m for m in sys.modules if m.split(".")[0] in banned)
pkgs = [importlib.import_module("pose3d_tpu_torch." + p)
        for p in {PACKAGES!r}]
after_import = loaded()
for p in pkgs:
    getattr(p, p.__all__[0])
print(json.dumps([after_import, loaded()]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == [[], []]


@pytest.mark.parametrize("size,sigma", [(16, 1.5), (33, 2.0)])
def test_gaussian_heatmaps_nchw_matches_jax(size, sigma):
    rng = np.random.default_rng(size)
    kpts = rng.uniform(0.05, 0.95, size=(3, 17, 2)).astype(np.float32)
    kpts[0, 2, 0] = 0.0
    kpts[1, 4, 1] = -0.1
    want = np.asarray(jheat.gaussian_heatmaps_nchw(kpts, size, sigma))
    got = theat.gaussian_heatmaps_nchw(torch.from_numpy(kpts), size, sigma)
    assert tuple(got.shape) == want.shape == (3, 17, size, size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert not got[0, 2].any() and not got[1, 4].any()
    nhwc = theat.gaussian_heatmaps(torch.from_numpy(kpts), size, sigma)
    assert torch.equal(got, nhwc.permute(0, 3, 1, 2))


@pytest.mark.parametrize("root_index", [0, 3])
def test_inter_joint_and_root_losses_match_jax(root_index):
    """fp32, the same formulas: 1e-6 relative."""
    rng = np.random.default_rng(root_index)
    pred, gt = (rng.normal(size=(4, 17, 3)).astype(np.float32)
                for _ in range(2))
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    got = tloss.inter_joint_distance_loss(tp, tg)
    want = jloss.inter_joint_distance_loss(jnp.asarray(pred),
                                           jnp.asarray(gt))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    got = tloss.abs_root_distance_loss(tp, tg, root_index)
    want = jloss.abs_root_distance_loss(jnp.asarray(pred), jnp.asarray(gt),
                                        root_index)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # the composite loss's terms are these
    _, comps = tloss.composite_pose_loss(tp, tg)
    np.testing.assert_allclose(comps["inter_joint_loss"].item(),
                               tloss.inter_joint_distance_loss(tp, tg).item(),
                               rtol=1e-6)
    np.testing.assert_allclose(comps["abs_root_loss"].item(),
                               tloss.abs_root_distance_loss(tp, tg).item(),
                               rtol=1e-6)


def test_ensure_dirs_makes_what_jax_makes(tmp_path):
    assert tcfg.GlobalConfig().cache_dir == jcfg.GlobalConfig().cache_dir
    made = {}
    for name, mod in (("port", tcfg), ("jax", jcfg)):
        base = tmp_path / name
        cfg = dataclasses.replace(mod.GlobalConfig(),
                                  log_dir=str(base / "a" / "logs"),
                                  cache_dir=str(base / "b" / "cache"))
        mod.ensure_dirs(cfg)
        mod.ensure_dirs(cfg)                      # and again: no error
        made[name] = sorted(str(p.relative_to(base))
                            for p in base.rglob("*"))
    assert made["port"] == made["jax"] == ["a", "a/logs", "b", "b/cache"]


@pytest.fixture(scope="module")
def tiny_pair():
    """The tiny transformer in JAX and the same variables in the port."""
    jcfg_, jmodel, variables = jax_model(seed=3)
    cfg = tcfg.TransformerModelConfig(**TINY_KW)
    model = build_model(cfg, device="cpu", dtype=torch.float32, train=True)
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return jmodel, variables, model


def test_make_predict_fn_matches_jax(tiny_pair):
    """An eval-mode forward without gradient on the device asked for, fp32
    against the JAX ``make_predict_fn`` on the same variables to
    1e-4·max(1, |ref|) (test_torch_port_model's bound); numpy inputs and
    tensors alike; the model is left in the mode it was in; with a mesh
    (here one rank) the same answer."""
    jmodel, variables, model = tiny_pair
    args = inputs(5, 3)
    want = np.asarray(jax_make_predict_fn(jmodel)(
        variables, *map(jnp.asarray, args)), np.float32)
    assert model.training
    predict = make_predict_fn(model, device="cpu")
    got = predict(*args)
    assert model.training and not got.requires_grad
    assert got.shape == (3, 17, 3) and got.device.type == "cpu"
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    again = predict(*map(torch.from_numpy, args))
    assert torch.equal(got, again)
    meshed = make_predict_fn(model, mesh=make_mesh())(*args)
    assert torch.equal(got, meshed)

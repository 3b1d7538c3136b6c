"""Two faults of the port's ``.pth`` load path, held to the JAX package.

F8: a file that does not name its ``model_type`` (a reference checkpoint
without the key, or a bare state_dict, with or without DDP's ``module.``
prefixes) is a CNN unless the caller's hint says otherwise, as in
``pose3d_tpu.cli.convert``; ``cli.evaluate`` takes the JAX CLI's
``--model-type``. A bare state_dict carries no ``model_args``, so both
packages build the default architecture from it: the tests shrink both
packages' defaults to the small configs.

F9: ``normalization="batch_dot"`` and ``"batch_pallas:N"`` load from a
JAX-written ``.pth`` and compute what the JAX modules compute, eval and
train mode, the gate of ``batch_pallas:N`` included; the grouped step
refuses both, as the JAX one does."""

import dataclasses
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers_synthetic import make_synthetic_chunk
from torch_port_helpers import TINY_KW, inputs, jax_model

from pose3d_tpu import compat_export as jexport, models as jmodels
from pose3d_tpu.cli import convert as jconvert
from pose3d_tpu.core import config as jcfg
from pose3d_tpu.models import init_model
from pose3d_tpu.models import cnn as jcnn
from pose3d_tpu.train import checkpoint as jckpt
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import step as jstep

from pose3d_tpu_torch import checkpoint as tcheckpoint
from pose3d_tpu_torch.checkpoint import load_pose_model
from pose3d_tpu_torch.cli import evaluate as port_eval
from pose3d_tpu_torch.core import config as tcfg
from pose3d_tpu_torch.models import cnn as tcnn
from pose3d_tpu_torch.serve_http import make_server
from pose3d_tpu_torch.train import loop, state as tstate, step as tstep

TINY_CNN = dict(
    image_size=(50, 50), heatmap_size=50, initial_channels=8,
    stage_channels=(16, 32, 64), stage_depths=(1, 3, 3),
    global_pool_size=2, global_feature_dim=32, regression_dims=(32, 16),
    regression_dropout=0.0,
)
SMALL = {"cnn": TINY_CNN, "transformer": TINY_KW}
HW = {"cnn": 50, "transformer": 64}
# The existing parity bounds: the CNN's eval forward (1e-4, absolute) and
# the transformer's fp32 forward (1e-4·max(1, |ref|)); running statistics
# 1e-5·max(1, |ref|).
TOL = 1e-4
TOL_STATS = 1e-5
# batch_pallas:N at the tiny CNN's sizes: 25² = 625 pixels a sample in the
# stem and stage 1, 13² in stage 2, 7² and 4² after; N = 100 puts the
# layers of 49 pixels and fewer under the gate.
GATE = 100


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.fixture
def small_defaults(monkeypatch):
    """The default architecture of both packages, as a bare state_dict
    builds it, becomes the small config of its model type."""
    for mod in (jcfg, tcheckpoint):
        real = mod.make_model_config

        def small(model_type=None, /, real=real, **kw):
            t = str(kw.get("model_type", model_type)).lower()
            return real(model_type, **{**SMALL.get(t, {}), **kw})

        monkeypatch.setattr(mod, "make_model_config", small)


def _jax_variables(model_type, seed=0):
    """(JAX config, module, numpy variables); the CNN's statistics are
    moved off 0 and 1 by one train-mode forward."""
    if model_type == "transformer":
        return jax_model(seed=seed)
    cfg = jcfg.CNNModelConfig(**TINY_CNN)
    model, variables = init_model(cfg, rng=jax.random.PRNGKey(seed),
                                  dtype=jnp.float32)
    _, mut = jax.jit(lambda v, a: model.apply(
        v, *a, train=True, mutable=["batch_stats"]))(
            variables, tuple(map(jnp.asarray, inputs(90, 4, hw=50))))
    return cfg, model, _np({"params": variables["params"],
                            "batch_stats": mut["batch_stats"]})


@pytest.fixture(scope="module")
def lifters():
    """model type → (JAX config, module, numpy variables)."""
    return {t: _jax_variables(t) for t in ("cnn", "transformer")}


_JIT = {}


def _jax_eval(key, jmodel, variables, args) -> np.ndarray:
    """The JAX eval forward, compiled once per module under ``key``."""
    fn = _JIT.setdefault(key, jax.jit(
        lambda v, a: jmodel.apply(v, *a, train=False)))
    return np.asarray(fn(variables, tuple(map(jnp.asarray, args))),
                      np.float32)


def _reference_sd(model_type, variables, cfg):
    export = (jexport.export_reference_cnn if model_type == "cnn"
              else jexport.export_reference_transformer)
    return {k: torch.from_numpy(np.array(v))
            for k, v in export(variables, cfg).sd.items()}


def _jax_convert(pth, model_type=None, monkeypatch=None):
    """What ``pose3d_tpu.cli.convert`` reads from ``pth``: the state it
    would save (params, batch_stats) and its model type and args."""
    seen = {}
    monkeypatch.setattr(jckpt, "save_checkpoint",
                        lambda out, state, t, args: seen.update(
                            state=state, model_type=t, model_args=args))
    # its fresh init (the optimizer state's template) is the same for every
    # file of one architecture: compile it once
    real = jmodels.init_model
    monkeypatch.setattr(jmodels, "init_model", lambda cfg, **kw: _INIT.setdefault(
        (cfg, tuple(sorted(kw.items()))), real(cfg, **kw)))
    jconvert.convert(str(pth), "unused", model_type=model_type)
    return seen


_INIT = {}


# --- F8 ----------------------------------------------------------------------

@pytest.mark.parametrize("model_type", ["cnn", "transformer"])
@pytest.mark.parametrize("form", ["bare", "module.", "no model_type"])
def test_a_file_without_its_model_type_loads_as_jax_converts_it(
        model_type, form, lifters, small_defaults, tmp_path, monkeypatch):
    """A bare state_dict, the same with ``module.`` prefixes, and a
    reference checkpoint without ``model_type``: the CNN loads with no
    hint, the transformer with ``model_type="transformer"`` (and fails to
    fit the CNN without it); the eval forward equals the JAX forward on
    the variables ``pose3d_tpu.cli.convert`` reads from the same file."""
    cfg, jmodel, variables = lifters[model_type]
    sd = _reference_sd(model_type, variables, cfg)
    if form == "module.":
        sd = {"module." + k: v for k, v in sd.items()}
    args = dataclasses.asdict(cfg)
    args.pop("model_type")
    blob = sd if form != "no model_type" else {
        "step": 3, "model_state_dict": sd, "model_args": args}
    pth = tmp_path / f"{model_type}.pth"
    torch.save(blob, pth)
    hint = None if model_type == "cnn" else "transformer"
    if hint:
        with pytest.raises(ValueError, match="(?i)cnn"):
            load_pose_model(pth, "cpu", dtype=torch.float32)
    model, got_cfg = load_pose_model(pth, "cpu", dtype=torch.float32,
                                     model_type=hint)
    assert got_cfg.model_type == model_type and not model.training
    conv = _jax_convert(pth, hint, monkeypatch)
    assert conv["model_type"] == model_type
    jvars = {"params": conv["state"].params}
    if model_type == "cnn":
        jvars["batch_stats"] = conv["state"].batch_stats
    args = inputs(5, 2, hw=HW[model_type])
    want = _jax_eval(model_type, jmodel, _np(jvars), args)
    with torch.inference_mode():
        got = model(*map(_t, args)).numpy()
    np.testing.assert_allclose(
        got, want, rtol=0, atol=TOL * max(1.0, float(np.abs(want).max())))


def test_cli_evaluate_and_serving_take_bare_state_dicts(
        lifters, small_defaults, tmp_path, monkeypatch):
    """``cli.evaluate --model-type transformer`` evaluates a bare
    transformer state_dict on the CPU, and without the hint refuses it as a
    CNN; a bare CNN state_dict needs no hint in ``cli.evaluate`` and in
    ``serve_http``; ``--model-type`` has the JAX CLI's choices and default."""
    from pose3d_tpu.cli import evaluate as jax_eval

    chunks = tmp_path / "chunks"
    make_synthetic_chunk(chunks, 0, num_samples=5, image_hw=(40, 48),
                         prefix="test", seed=3, num_actions=2)
    for model_type in ("transformer", "cnn"):
        cfg, _, variables = lifters[model_type]
        pth = tmp_path / f"{model_type}.pth"
        torch.save(_reference_sd(model_type, variables, cfg), pth)
        argv = ["--checkpoint", str(pth), "--chunks-dir", str(chunks),
                "--device", "cpu", "--batch-size", "2"]
        if model_type == "transformer":
            with pytest.raises(ValueError, match="do not fit the cnn"):
                port_eval.main(argv)
            argv += ["--model-type", "transformer"]
        out = port_eval.main(argv)
        assert np.isfinite([out["mpjpe"], out["pa_mpjpe"]]).all()
        assert out["checkpoint_step"] == 0
    srv = make_server(pth, "127.0.0.1", 0, device="cpu",
                      dtype=torch.float32, max_batch=2)
    args = inputs(6, 2, hw=HW["cnn"])
    try:
        assert srv.artifact_meta["model_type"] == "cnn"
        got = srv.batcher.submit(*args).result(timeout=120)["joints_3d"]
    finally:
        srv.batcher.close()
        srv.server_close()
    model, _ = load_pose_model(pth, "cpu", dtype=torch.float32)
    with torch.inference_mode():
        want = model(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for mod in (port_eval, jax_eval):
        act = {a.dest: a for a in mod.build_parser()._actions}["model_type"]
        assert (act.choices, act.default) == (["cnn", "transformer"], None)


# --- F9 ----------------------------------------------------------------------

def _rename(tree):
    """flax names the norm ``DotStatsBatchNorm_0`` where normalization is
    not "batch"; the JAX package's exporter reads ``BatchNorm_0`` (it
    takes "batch" only), and the leaves are the same."""
    return {("BatchNorm_0" if k == "DotStatsBatchNorm_0" else k):
            (_rename(v) if isinstance(v, dict) else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module", params=["batch_dot", f"batch_pallas:{GATE}"])
def jax_norm_cnn(request, tmp_path_factory):
    """(norm, JAX config, module, numpy variables, ``.pth``): the tiny CNN
    with this normalisation, written as a reference ``.pth`` by
    ``pose3d_tpu.compat_export`` with the config's own ``model_args``."""
    norm = request.param
    cfg = jcfg.CNNModelConfig(**TINY_CNN, normalization=norm)
    model, variables = init_model(cfg, rng=jax.random.PRNGKey(3),
                                  dtype=jnp.float32)
    _, mut = jax.jit(lambda v, a: model.apply(
        v, *a, train=True, mutable=["batch_stats"]))(
            variables, tuple(map(jnp.asarray, inputs(90, 4, hw=50))))
    variables = _np({"params": variables["params"],
                     "batch_stats": mut["batch_stats"]})
    writer = jexport.export_reference_cnn(
        {k: _rename(v) for k, v in variables.items()},
        dataclasses.replace(cfg, normalization="batch"))
    args = cfg.to_dict()
    args.pop("model_type")
    pth = tmp_path_factory.mktemp("pth") / "cnn.pth"
    torch.save({"step": 0, "model_type": "cnn", "model_args": args,
                "model_state_dict": {k: torch.from_numpy(np.array(v))
                                     for k, v in writer.sd.items()}}, pth)
    return norm, cfg, model, variables, pth


def test_batch_dot_and_batch_pallas_n_load_and_match_jax(jax_norm_cnn):
    """The port's load of the JAX-written file: eval-mode joints, then one
    train-mode forward's joints and updated running statistics, against
    the JAX module on the same variables."""
    norm, cfg, jmodel, variables, pth = jax_norm_cnn
    model, got_cfg = load_pose_model(pth, "cpu", dtype=torch.float32)
    assert got_cfg.normalization == norm
    norms = [m for m in model.modules()
             if isinstance(m, tcnn.DotStatsBatchNorm)]
    assert norms and all(
        m.stats_impl == ("reference" if norm == "batch_dot" else "auto")
        for m in norms)
    args = inputs(91, 3, hw=50)
    want = _jax_eval(norm, jmodel, variables, args)
    with torch.no_grad():
        got = model(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)

    want, mut = jax.jit(lambda v, a: jmodel.apply(
        v, *a, train=True, mutable=["batch_stats"]))(
            variables, tuple(map(jnp.asarray, args)))
    model.train()
    with torch.no_grad():
        got = model(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)
    from pose3d_tpu_torch.compat import state_dict_from_jax

    ref = state_dict_from_jax({"params": variables["params"],
                               "batch_stats": _np(mut["batch_stats"])}, cfg)
    stats = tstate.batch_stats(model)
    assert stats and set(stats) <= set(ref)
    for name, buf in stats.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(
            buf.numpy(), r, rtol=0,
            atol=TOL_STATS * max(1.0, float(np.abs(r).max())), err_msg=name)


def test_the_pixel_gate_matches_jax(jax_norm_cnn):
    """Each DotStatsBatchNorm of a train-mode forward, in call order: the
    port's record of whether the layer sat under the gate against the JAX
    module's ``pallas_min_pixels`` decision at the same input size. Under
    ``batch_dot`` no layer launches the kernel."""
    norm, cfg, jmodel, variables, pth = jax_norm_cnn
    args = inputs(92, 2, hw=50)
    decisions = []

    def record(next_fun, a, kw, context):
        mdl = context.module
        if isinstance(mdl, jcnn.DotStatsBatchNorm) \
                and context.method_name == "__call__":
            x = a[0]
            pixels = x.size // x.shape[-1] // x.shape[0]
            decisions.append((pixels, mdl.stats != "pallas"
                              or pixels < mdl.pallas_min_pixels))
        return next_fun(*a, **kw)

    def apply(v, a):
        with fnn.intercept_methods(record):
            return jmodel.apply(v, *a, train=True, mutable=["batch_stats"])

    jax.eval_shape(apply, variables, tuple(map(jnp.asarray, args)))
    model, _ = load_pose_model(pth, "cpu", dtype=torch.float32)
    model.train()
    seen = []
    for m in model.modules():
        if isinstance(m, tcnn.DotStatsBatchNorm):
            m.register_forward_hook(lambda m, a, out: seen.append(
                (a[0].numel() // a[0].shape[-1] // a[0].shape[0],
                 m.gated or m.stats_impl == "reference")))
    with torch.no_grad():
        model(*map(_t, args))
    assert seen == decisions
    plain = [d for _, d in seen]
    if norm == "batch_dot":
        assert all(plain)
    else:
        assert 0 < plain.count(False) < len(plain)


def test_grouped_step_refuses_both_as_jax_does(jax_norm_cnn):
    """``accum_mode="grouped"`` raises in both packages and leaves the
    port's state untouched; an unknown name still raises."""
    norm, cfg, jmodel, variables, pth = jax_norm_cnn
    img, depth, kpt = inputs(93, 4, hw=50)
    sb = {"image": img.reshape(2, 2, 50, 50, 3),
          "depth": depth.reshape(2, 2, 50, 50, 1),
          "keypoints_2d": kpt.reshape(2, 2, 17, 2),
          "joints_3d": np.zeros((2, 2, 17, 3), np.float32)}
    st = jstate.create_train_state(jmodel, variables)
    with pytest.raises(NotImplementedError, match="grouped"):
        jstep.make_train_step(jmodel, accum_mode="grouped", donate=False)(
            st, {k: jnp.asarray(v) for k, v in sb.items()},
            jax.random.PRNGKey(0))
    model, _ = load_pose_model(pth, "cpu", dtype=torch.float32)
    state = tstate.create_train_state(model)
    with pytest.raises(NotImplementedError, match="grouped"):
        tstep.make_train_step(accum_mode="grouped")(
            state, loop.to_device(sb, "cpu"))
    assert state.step == 0
    with pytest.raises(NotImplementedError, match="not ported"):
        tcnn._norm("batch_dott", 8)
    assert json.loads(json.dumps(tcfg.CNNModelConfig(
        **TINY_CNN, normalization=norm).to_dict()))["normalization"] == norm

"""pose3d_tpu_torch's model options against the JAX package on the same
numpy inputs and bridged weights: the transformer's ``remat`` (encoder and
fusion blocks recomputed in the backward pass) and the CNN's per-sample
normalisations ``identity``, ``layer`` and ``group`` (flax ``GroupNorm``:
epsilon 1e-6, fast variance), with the coordinate attention's BatchNorms,
the only ones left, grouped in the grouped step. ``instance`` is held to a
flax ``GroupNorm(group_size=1)`` at the layer level: the JAX factory cannot
build it under the installed flax (the defect is on record here too)."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import TINY_KW, assert_params_close, inputs

from pose3d_tpu.core import config as jcfg
from pose3d_tpu.models import init_model
from pose3d_tpu.ops import losses as jlosses
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import step as jstep

from pose3d_tpu_torch.compat import state_dict_from_jax
from pose3d_tpu_torch.core.config import CNNModelConfig, TransformerModelConfig
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.models import cnn
from pose3d_tpu_torch.models.cnn import BatchNorm, GroupNorm, Identity
from pose3d_tpu_torch.ops import losses
from pose3d_tpu_torch.train import loop, state as tstate, step as tstep

LR = 1e-3
NO_DROPOUT = dict(transformer_dropout_rate=0.0, regression_dropout=0.0)
# the tiny CNN of test_torch_port_cnn.py (every block kind, SE, ECA and
# CoordAttention, WASP) with expand ratios 1, 2, 2, so that every width
# divides into min(32, C) groups, as the published widths do
TINY_CNN = dict(
    image_size=(50, 50), heatmap_size=50, initial_channels=8,
    stage_channels=(16, 32, 64), stage_depths=(1, 3, 3),
    stage_expand_ratios=(1, 2, 2),
    global_pool_size=2, global_feature_dim=32, regression_dims=(32, 16),
    regression_dropout=0.0,
)
# Per-tensor bound on a gradient's max error, relative to max(1, |ref|):
# summation order through some forty normalisations in fp32, as in
# test_torch_port_cnn.py.
GRAD_TOL = 3e-4
# The grouped step's applied gradients, each fp32 side against the same step
# in float64, per tensor relative to max(1, |exact|): fp32 rounding of the
# step (no fault: the port's closed-form GroupNorm backward equals plain
# autograd to 1e-9 in float64). Measured, the port's worst and JAX's are
# 2.4e-4 and 3.9e-4 with ``group`` (1.6e-5 and 1.2e-5 with ``layer``, 5e-7
# and 4e-7 with ``identity``); the bound is the worst rounded up to 5e-4 a
# side, and the two sides are held to each other at the sum.
STEP_TOL = 5e-4

_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731


def _grad_atol(ref) -> float:
    return GRAD_TOL * max(1.0, float(np.abs(ref).max(initial=0)))


def _superbatch(seed, A, B, hw):
    rng = np.random.default_rng(seed)
    batches = []
    for a in range(A):
        img, depth, kpt = inputs(seed * 10 + a, B, hw=hw)
        batches.append({
            "image": img, "depth": depth, "keypoints_2d": kpt,
            "joints_3d": rng.normal(scale=0.5, size=(B, 17, 3)).astype(
                np.float32)})
    return next(loop._superbatches(batches, A))


def _jax_step(jmodel, variables, sb):
    """The JAX grouped step (EMA 0.999) from ``variables``: (the loss and
    its gradients on the flat batch, the gradients the step applied, the
    new state, the metrics). The applied gradients are the scan oracle's:
    the mean over microbatches of each one's gradient at the running
    statistics that microbatch sees, which the grouped step equals."""
    jsb = {k: jnp.asarray(v) for k, v in sb.items()}
    grad_fn = jax.jit(lambda p, s, b: jax.value_and_grad(
        jstep._loss_fn, has_aux=True)(p, s, jmodel.apply, b,
                                      jax.random.PRNGKey(0),
                                      jlosses.LossWeights()))
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in jsb.items()}
    stats = variables.get("batch_stats", {})
    (loss, _), grads = grad_fn(variables["params"], stats, flat)
    A, total = sb["image"].shape[0], None
    for i in range(A):
        (_, (_, stats)), g = grad_fn(variables["params"], stats,
                                     {k: v[i] for k, v in jsb.items()})
        total = g if total is None else jax.tree_util.tree_map(
            jnp.add, total, g)
    applied = jax.tree_util.tree_map(lambda g: g / A, total)
    st = jstate.create_train_state(jmodel, variables, learning_rate=LR,
                                   ema=True)
    new, m = jstep.make_train_step(jmodel, accum_mode="grouped",
                                   donate=False, ema_decay=0.999)(
        st, jsb, jax.random.PRNGKey(0))
    return (loss, grads, applied, new,
            {k: float(v) for k, v in m.items()})


# --- transformer remat --------------------------------------------------------

TCFG = TransformerModelConfig(**TINY_KW, **NO_DROPOUT)


@pytest.fixture(scope="module")
def jax_remat():
    """The JAX transformer with ``remat=True`` (the plain XLA attention,
    which the JAX model runs off the TPU), its numpy variables, the eval
    forward on a batch of 3, and one grouped step (A 2, B 2) with the
    gradients of its loss."""
    cfg = jcfg.TransformerModelConfig(**TINY_KW, **NO_DROPOUT)
    jmodel, variables = init_model(cfg, rng=jax.random.PRNGKey(4),
                                   dtype=jnp.float32, attention_backend="xla",
                                   remat=True)
    variables = _np(variables)
    args = inputs(11, 3)
    out = np.asarray(jax.jit(lambda v, *a: jmodel.apply(v, *a))(
        variables, *map(jnp.asarray, args)))
    sb = _superbatch(2, 2, 2, 64)
    loss, grads, applied, new, m = _jax_step(jmodel, variables, sb)
    sd = lambda t: state_dict_from_jax({"params": _np(t)}, TCFG)  # noqa
    return dict(variables=variables, args=args, out=out, sb=sb,
                loss=float(loss), grads=sd(grads), applied=sd(applied),
                params=sd(new.params), ema=sd(new.ema_params), metrics=m)


def _port_transformer(variables, **kw):
    model = build_model(TCFG, device="cpu", dtype=torch.float32, train=True,
                        **kw)
    model.load_state_dict(state_dict_from_jax(variables, TCFG), strict=True)
    return model


def test_transformer_remat_keeps_parameter_names():
    """One checkpoint loads either way: the port's state_dict keys and the
    JAX variable tree are the same with and without ``remat``."""
    keys = [list(build_model(TCFG, device="cpu", remat=r).state_dict())
            for r in (False, True)]
    assert keys[0] == keys[1]
    cfg = jcfg.TransformerModelConfig(**TINY_KW)
    trees = [jax.tree_util.tree_structure(jax.eval_shape(
        lambda r=r: init_model(cfg, attention_backend="xla", remat=r)[1]))
        for r in (False, True)]
    assert trees[0] == trees[1]


def test_transformer_remat_matches_jax_remat(jax_remat):
    """At dropout 0, fp32, against the JAX model with ``remat=True``: the
    eval forward (rtol 1e-5 of the output's norm), the grouped step's loss
    (rtol 1e-5) and every gradient (1e-4·max(1, |ref|), the bound of
    test_torch_port_train.py), then one grouped AdamW step with EMA:
    metrics (rtol 1e-5), params and EMA params (``assert_params_close``)."""
    ref = jax_remat
    model = _port_transformer(ref["variables"], remat=True)
    model.eval()
    with torch.no_grad():
        out = model(*map(torch.from_numpy, ref["args"])).numpy()
    assert np.linalg.norm(out - ref["out"]) <= 1e-5 * np.linalg.norm(
        ref["out"])
    model.train()
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in ref["sb"].items()}
    loss, _ = tstep._forward_loss(model, loop.to_device(flat, "cpu"),
                                  losses.LossWeights(), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    for name, p in model.named_parameters():
        want = ref["grads"][name].numpy()
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=tol,
                                   err_msg=name)

    model = _port_transformer(ref["variables"], remat=True)
    st = tstate.create_train_state(model, LR, 0.01, ema=True)
    m = tstep.make_train_step(accum_mode="grouped", ema_decay=0.999)(
        st, loop.to_device(ref["sb"], "cpu"))
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(m[k].item(), v, rtol=1e-5, err_msg=k)
    assert_params_close(dict(model.named_parameters()), ref["params"],
                        ref["applied"])
    assert_params_close(st.ema_params, ref["ema"], ref["applied"])


def test_transformer_remat_redraws_the_same_dropout_masks():
    """At dropout 0.1 the rematerialised model, from the same generator
    seed, gives the loss and every gradient of the plain one bitwise, and
    leaves the generator where the plain model's forward left it: the
    recomputation drew the first run's masks (a plain
    ``torch.utils.checkpoint`` would draw new ones from the caller's
    generator, and the gradient would be wrong with no error)."""
    cfg = dataclasses.replace(TCFG, transformer_dropout_rate=0.1,
                              regression_dropout=0.1)
    args = list(map(torch.from_numpy, inputs(12, 2)))
    runs = []
    for remat in (False, True):
        model = build_model(cfg, device="cpu", dtype=torch.float32,
                            train=True, remat=remat,
                            generator=torch.Generator().manual_seed(3))
        gen = torch.Generator().manual_seed(9)
        loss = model(*args, generator=gen).square().mean()
        after_forward = gen.get_state()
        loss.backward()
        runs.append((loss, {n: p.grad for n, p in model.named_parameters()},
                     after_forward, gen.get_state()))
    (l0, g0, f0, b0), (l1, g1, f1, b1) = runs
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert torch.equal(f0, f1) and torch.equal(b1, f1) and torch.equal(b0, f0)


def test_transformer_remat_from_the_cli_builds_the_remat_model():
    """``build_model(remat=True)`` reaches every encoder and fusion block
    (the CLI's ``--remat``); eval and no-grad forwards do not checkpoint."""
    model = build_model(TCFG, device="cpu", remat=True)
    assert model.remat and model.vit_backbone.remat
    plain = build_model(TCFG, device="cpu")
    args = list(map(torch.from_numpy, inputs(13, 2)))
    with torch.no_grad():
        assert torch.equal(model(*args), plain(*args))


# --- CNN normalisations ------------------------------------------------------

NORMS = ["identity", "layer", "group"]


@pytest.fixture(scope="module", params=NORMS)
def jax_norm_cnn(request):
    """(norm, JAX module, numpy variables, the eval forward, and the
    grouped step's reference)."""
    norm = request.param
    cfg = jcfg.CNNModelConfig(**TINY_CNN, normalization=norm)
    jmodel, variables = init_model(cfg, rng=jax.random.PRNGKey(5),
                                   dtype=jnp.float32)
    variables = _np(variables)
    args = inputs(93, 3, hw=50)
    out = np.asarray(jax.jit(lambda v, *a: jmodel.apply(v, *a))(
        variables, *map(jnp.asarray, args)))
    sb = _superbatch(4, 3, 4, 50)
    loss, grads, applied, new, m = _jax_step(jmodel, variables, sb)
    pcfg = CNNModelConfig(**TINY_CNN, normalization=norm)

    def sd(params, stats):
        return state_dict_from_jax(
            {"params": _np(params), "batch_stats": _np(stats)}, pcfg)

    bs = new.batch_stats
    return dict(norm=norm, cfg=pcfg, variables=variables, args=args, out=out,
                sb=sb, loss=float(loss), metrics=m,
                grads=sd(grads, variables["batch_stats"]),
                applied=sd(applied, variables["batch_stats"]),
                new=sd(new.params, bs), ema=sd(new.ema_params,
                                               new.ema_batch_stats))


def _port_cnn(ref):
    model = build_model(ref["cfg"], device="cpu", dtype=torch.float32,
                        train=True)
    model.load_state_dict(state_dict_from_jax(ref["variables"], ref["cfg"]),
                          strict=True)
    return model


def _plain_group_norm(x, weight, bias, groups, out_dtype):
    """flax ``GroupNorm`` (fast variance) in plain autograd."""
    N, C = x.shape[0], x.shape[-1]
    xg = x.reshape(N, -1, groups, C // groups)
    mean = xg.mean((1, 3), keepdim=True)
    var = ((xg * xg).mean((1, 3), keepdim=True) - mean * mean).clamp_min(0)
    y = ((xg - mean) * torch.rsqrt(var + cnn.GN_EPS)
         * weight.view(groups, -1) + bias.view(groups, -1))
    return y.to(out_dtype).reshape(x.shape)


def _port_step_grads(ref, dtype, plain=False):
    """The port's grouped step (A 3 × B 4) from the bridged weights in
    ``dtype`` (float64: model, parameters and statistics; the uint8 inputs
    decode as in fp32); its applied gradients as float64 numpy.
    ``plain``: GroupNorm through plain autograd."""
    model = build_model(ref["cfg"], device="cpu", dtype=dtype,
                        train=True).to(dtype)
    model.load_state_dict(state_dict_from_jax(ref["variables"], ref["cfg"]),
                          strict=True)
    st = tstate.create_train_state(model, LR, 0.01, ema=True)
    sb = {k: torch.from_numpy(v.astype(np.float64) if v.dtype == np.float32
                              and dtype == torch.float64 else v)
          for k, v in ref["sb"].items()}
    with pytest.MonkeyPatch.context() as mp:
        if plain:
            mp.setattr(cnn._GroupNormFn, "apply", _plain_group_norm)
        tstep.make_train_step(accum_mode="grouped", ema_decay=0.999)(st, sb)
    return {n: p.grad.double().numpy() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def f64_step(jax_norm_cnn):
    """The grouped step's applied gradients in float64, GroupNorm in plain
    autograd: the exact reference both fp32 sides are held to."""
    return _port_step_grads(jax_norm_cnn, torch.float64, plain=True)


def _assert_stats_close(got, want, tol=1e-5):
    assert got and set(got) <= set(want)
    for name, buf in got.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(
            buf.numpy(), ref, rtol=0,
            atol=tol * max(1.0, float(np.abs(ref).max())), err_msg=name)


def test_cnn_norm_modules_and_bridge(jax_norm_cnn):
    """Each ConvBnAct holds the norm the name asks for (``layer``: one
    group, ``group``: min(32, C)), the coordinate attention keeps its
    BatchNorm, the JAX variables (``GroupNorm_0``, ``_G_0/GroupNorm_0``,
    nothing) strict-load through the bridge, and the eval forward matches
    JAX in fp32 (1e-5 of the output's norm)."""
    ref = jax_norm_cnn
    model = _port_cnn(ref)
    norms = [m.norm for m in model.modules() if hasattr(m, "norm")
             and hasattr(m, "conv")]
    want = {"identity": Identity, "layer": GroupNorm,
            "group": GroupNorm}[ref["norm"]]
    assert norms and all(type(n) is want for n in norms)
    if ref["norm"] != "identity":
        assert all(n.groups == (1 if ref["norm"] == "layer"
                                else min(32, n.features)) for n in norms)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert bns and all(m.features >= 8 for m in bns)     # CoordAttention's
    assert set(tstate.batch_stats(model)) == {
        f"{n}.{s}" for n, m in model.named_modules()
        if isinstance(m, BatchNorm) for s in ("running_mean", "running_var")}
    model.eval()
    with torch.no_grad():
        out = model(*map(torch.from_numpy, ref["args"])).numpy()
    assert np.linalg.norm(out - ref["out"]) <= 1e-5 * np.linalg.norm(
        ref["out"])


def test_cnn_norm_gradients_match_jax(jax_norm_cnn):
    """The grouped step's loss on the flat batch of 12 (rtol 1e-5) and
    every parameter's gradient (``GRAD_TOL``·max(1, |ref|)) against
    ``jax.value_and_grad`` of the JAX step's loss."""
    ref = jax_norm_cnn
    model = _port_cnn(ref)
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in ref["sb"].items()}
    loss, _ = tstep._forward_loss(model, loop.to_device(flat, "cpu"),
                                  losses.LossWeights(), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    for name, p in model.named_parameters():
        want = ref["grads"][name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=_grad_atol(want), err_msg=name)


def _step_atol(exact) -> float:
    return STEP_TOL * max(1.0, float(np.abs(exact).max(initial=0)))


def test_cnn_norm_grouped_step_matches_jax(jax_norm_cnn, f64_step):
    """One grouped step (A 3 × B 4, EMA 0.999): the JAX grouped step groups
    the coordinate attention's BatchNorms and passes every GroupNorm
    through; the port's too. Metrics (rtol 1e-5); the applied gradients of
    each side against the float64 step (``STEP_TOL``) and of the two sides
    against each other (2·``STEP_TOL``), after the port's closed-form
    GroupNorm backward in float64 against plain autograd (1e-9); params
    and EMA params (``assert_params_close`` at that pair bound), running
    statistics and ``ema_batch_stats`` (1e-5·max(1, |ref|))."""
    ref = jax_norm_cnn
    closed = _port_step_grads(ref, torch.float64)
    for name, exact in f64_step.items():
        np.testing.assert_allclose(
            closed[name], exact, rtol=0,
            atol=1e-9 * max(1.0, np.abs(exact).max(initial=0)), err_msg=name)
    model = _port_cnn(ref)
    st = tstate.create_train_state(model, LR, 0.01, ema=True)
    m = tstep.make_train_step(accum_mode="grouped", ema_decay=0.999)(
        st, loop.to_device(ref["sb"], "cpu"))
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(m[k].item(), v, rtol=1e-5, err_msg=k)
    params = dict(model.named_parameters())
    for name, p in params.items():
        exact, want = f64_step[name], ref["applied"][name].numpy()
        atol = _step_atol(exact)
        np.testing.assert_allclose(p.grad.numpy(), exact, rtol=0, atol=atol,
                                   err_msg=f"port: {name}")
        np.testing.assert_allclose(want, exact, rtol=0, atol=atol,
                                   err_msg=f"JAX: {name}")
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=2 * atol, err_msg=name)

    def pair_atol(g):
        return 2 * _step_atol(g)

    assert_params_close(params, ref["new"], ref["applied"], LR, pair_atol)
    assert_params_close(st.ema_params, ref["ema"], ref["applied"], LR,
                        pair_atol)
    _assert_stats_close(tstate.batch_stats(model), ref["new"])
    assert set(st.ema_batch_stats) == set(tstate.batch_stats(model))
    _assert_stats_close(st.ema_batch_stats, ref["ema"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_matches_flax_group_size_one(dtype):
    """``normalization="instance"``: one group a channel, held to flax
    ``nn.GroupNorm(num_groups=None, group_size=1)`` (what the JAX factory
    means): output and the gradients of x, scale and bias; fp32 to
    1e-5·max(1, |ref|), bf16 (x and y in bf16, statistics and affine in
    fp32 in both) to one bf16 ulp of the output's scale."""
    rng = np.random.default_rng(21)
    x = (rng.normal(size=(3, 6, 5, 16)) * 1.7 + 0.4).astype(np.float32)
    w = rng.normal(size=16).astype(np.float32)
    b = rng.normal(size=16).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    jdt = getattr(jnp, dtype)
    gn = fnn.GroupNorm(num_groups=None, group_size=1, dtype=jdt)
    v = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}}

    def f(v, x):
        y = gn.apply(v, x)
        return (y.astype(jnp.float32) * dy).sum(), y

    (_, yj), (gv, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        v, jnp.asarray(x).astype(jdt))
    cfg = CNNModelConfig(**TINY_CNN, normalization="instance")
    model = build_model(cfg, device="cpu", dtype=torch.float32, train=True)
    assert all(m.groups == m.features for m in model.modules()
               if isinstance(m, GroupNorm))
    m = GroupNorm(16, 16)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w))
        m.bias.copy_(torch.from_numpy(b))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    y = m(tx, tdt)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    assert y.dtype == tdt and tx.grad.dtype == tdt
    for name, got, want in (("y", y, yj), ("dx", tx.grad, gx),
                            ("dscale", m.weight.grad, gv["params"]["scale"]),
                            ("dbias", m.bias.grad, gv["params"]["bias"])):
        want = np.asarray(want.astype(jnp.float32))
        rel = 2.0 ** -7 if dtype == "bfloat16" and name in ("y", "dx") \
            else 1e-5
        np.testing.assert_allclose(
            got.detach().float().numpy(), want, rtol=0,
            atol=rel * max(1.0, float(np.abs(want).max())), err_msg=name)


def test_instance_cnn_bridges_the_layer_tree_and_trains():
    """The JAX variables of an ``instance`` CNN would hold the same leaves
    as a ``layer`` CNN's (``GroupNorm_0`` scale and bias per ConvBnAct):
    they strict-load into the port's ``instance`` CNN, whose grouped step
    is finite."""
    jc = jcfg.CNNModelConfig(**TINY_CNN, normalization="layer")
    _, variables = init_model(jc, rng=jax.random.PRNGKey(6),
                              dtype=jnp.float32)
    cfg = CNNModelConfig(**TINY_CNN, normalization="instance")
    model = build_model(cfg, device="cpu", dtype=torch.float32, train=True)
    model.load_state_dict(state_dict_from_jax(_np(variables), cfg),
                          strict=True)
    st = tstate.create_train_state(model, LR, 0.01)
    m = tstep.make_train_step(accum_mode="grouped")(
        st, loop.to_device(_superbatch(7, 2, 4, 50), "cpu"))
    assert st.step == 1 and all(np.isfinite(v.item()) for v in m.values())


def test_jax_factory_cannot_build_instance():
    """The JAX factory's ``instance`` leaves ``num_groups`` at flax's
    default of 32 beside ``group_size=1``, and the installed flax refuses
    that pair (ROADMAP.md, Queue 3); the port builds what it means."""
    cfg = jcfg.CNNModelConfig(**TINY_CNN, normalization="instance")
    with pytest.raises(ValueError, match="num_groups"):
        init_model(cfg, rng=jax.random.PRNGKey(0), dtype=jnp.float32)

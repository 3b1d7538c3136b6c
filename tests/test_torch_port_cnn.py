"""pose3d_tpu_torch's CNN lifter against the JAX package on the same numpy
inputs, weights and BatchNorm statistics: the plain ``bn_stats`` and its
backward (against the Pallas kernel in interpret mode), both BatchNorm
flavours, the tiny CNN (block outputs, eval and train forwards, running
statistics, gradients) for ``normalization`` "batch" and "batch_pallas",
the grouped BatchNorm and one grouped and one scan optimizer step with
``ema_batch_stats``, rematerialisation, and the ``.pth`` round trip served
over HTTP. Off the TPU the JAX ``batch_pallas`` BatchNorm runs its Pallas
kernel in interpret mode by itself."""

import dataclasses
import io
import json
import threading
import urllib.request

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_params_close, inputs, rel_l2

from pose3d_tpu.core import config as jcfg
from pose3d_tpu.models import init_model
from pose3d_tpu.models import cnn as jcnn
from pose3d_tpu.ops import losses as jlosses
from pose3d_tpu.ops.pallas.bn_stats import bn_stats as jax_bn_stats
from pose3d_tpu.train import ghost_bn as jghost
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import step as jstep

from pose3d_tpu_torch.checkpoint import load_pose_model, save_pose_model
from pose3d_tpu_torch.compat import state_dict_from_jax
from pose3d_tpu_torch.compat_export import iter_cnn_stage_blocks
from pose3d_tpu_torch.core.config import CNNModelConfig
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.models import cnn as tcnn
from pose3d_tpu_torch.ops import losses
from pose3d_tpu_torch.ops.kernels.bn_stats import (
    BnStats,
    bn_stats,
    bn_stats_reference,
    launch_config,
)
from pose3d_tpu_torch.serve_http import make_server
from pose3d_tpu_torch.train import ghost_bn, loop, state as tstate, \
    step as tstep

# 50 → 25 → 13 → 7 → 4 with stride 2 on odd sizes, as 500 → 250 → 125 → 63
# → 32 at full size; InvertedResidual with expand 1 and > 1, SE and ECA,
# DualPath with and without shortcut, CoordAttention, WASP, 4 → 2 pooling.
TINY_CNN = dict(
    image_size=(50, 50), heatmap_size=50, initial_channels=8,
    stage_channels=(16, 32, 64), stage_depths=(1, 3, 3),
    global_pool_size=2, global_feature_dim=32, regression_dims=(32, 16),
    regression_dropout=0.0,
)
NORMS = ["batch", "batch_pallas"]
LR = 1e-3
# Per-tensor bound on a gradient's max error, relative to max(1, |ref|).
# Some forty BatchNorms deep in fp32, JAX's own rounding (the variance as
# E[x²] − E[x]²) reaches 1.6e-4 here: the port run in fp64 sits at the same
# distance from the JAX fp32 gradient as the port in fp32 does.
GRAD_TOL = 3e-4


def _grad_atol(ref) -> float:
    return GRAD_TOL * max(1.0, float(np.abs(ref).max(initial=0)))

_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731


def _t(x, dtype="float32"):
    return torch.from_numpy(np.asarray(x)).to(getattr(torch, dtype))


# --- bn_stats ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [3, 64])
@pytest.mark.parametrize("n", [1, 10, 1030])
def test_plain_bn_stats_matches_pallas(n, C, dtype):
    """Σx, Σx² of the plain version and the Function's backward against the
    Pallas kernel (interpret mode) and ``jax.vjp`` through it. Sums to
    1e-5·max(1, |ref|) (fp32 summation order over up to 1030 rows); the
    backward is the same closed form in the same order, held to one ulp
    of x's dtype."""
    rng = np.random.default_rng(n * 100 + C)
    x = rng.normal(0.3, 1.5, size=(n, C)).astype(np.float32)
    g = rng.normal(size=(2, C)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    (w1, w2), vjp = jax.vjp(lambda a: jax_bn_stats(a, True), jx)
    (wdx,) = vjp((jnp.asarray(g[0]), jnp.asarray(g[1])))
    tx = _t(x, dtype).requires_grad_()
    s1, s2 = BnStats.apply(tx, False)
    assert s1.dtype == s2.dtype == torch.float32 and s1.shape == (C,)
    for got, want in ((s1, w1), (s2, w2)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.detach().numpy(), want, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(want).max())))
    (dx,) = torch.autograd.grad((s1, s2), tx, (_t(g[0]), _t(g[1])))
    assert dx.dtype == tx.dtype
    want = np.asarray(wdx.astype(jnp.float32))
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -22
    np.testing.assert_allclose(dx.float().numpy(), want, rtol=ulp, atol=1e-30)
    p1, p2 = bn_stats_reference(tx.detach())
    assert torch.equal(p1, s1.detach()) and torch.equal(p2, s2.detach())


def test_bn_stats_wrapper_rejects_and_plans():
    """The kernel wrapper raises for what it does not take and counts no
    launch it did not make; the launch plan covers every row and channel
    of the path's shapes in one launch whose grid fits the card's
    resident blocks."""
    before = bn_stats.launches
    with pytest.raises(ValueError, match="CUDA"):
        bn_stats(torch.zeros(4, 8))
    with pytest.raises(ValueError, match=r"\[n, C\]"):
        bn_stats(torch.zeros(4, 8, 2))
    with pytest.raises(ValueError, match="contiguous"):
        bn_stats(torch.zeros(8, 4).t())
    with pytest.raises(ValueError, match="supported"):
        bn_stats(torch.zeros(4, 8, dtype=torch.float16))
    with pytest.raises(RuntimeError, match="drop its gradient"):
        bn_stats(torch.zeros(4, 8, requires_grad=True))
    assert bn_stats.launches == before
    for n, C in [(625000, 64), (156250, 128), (39690, 768), (10240, 3072),
                 (640, 1024), (10, 512), (1, 3), (7, 3), (1025, 64)]:
        for itemsize in (2, 4):
            for aligned in (True, False):
                cfg = launch_config(n, C, itemsize, aligned)
                vec, tiles, blocks = cfg["vec"], cfg["tiles"], cfg["blocks"]
                assert vec in (1, 16 // itemsize) and C % vec == 0
                assert not aligned or C % (16 // itemsize) or vec > 1
                assert cfg["launches"] == 1
                assert 1 <= blocks <= n
                rows = cfg["rows_per_block"]
                assert rows * blocks >= n           # every row covered
                assert tiles * 8 * vec >= C and tiles <= 65535
                assert blocks == 1 or tiles * blocks <= 3 * 132


# --- the two BatchNorm flavours ----------------------------------------------

def _bn_pair(flavour, C, dtype, seed=0):
    """A JAX BatchNorm of ``flavour`` in train mode, its variables with
    non-trivial scale, bias and running statistics, and the port's module
    holding the same."""
    rng = np.random.default_rng(seed)
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
                   "bias": rng.normal(size=C).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(size=C).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, C).astype(np.float32)},
    }
    jdt = getattr(jnp, dtype)

    def jmod(train):
        if flavour == "batch":
            return fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                                 epsilon=1e-5, dtype=jdt,
                                 param_dtype=jnp.float32)
        return jcnn.DotStatsBatchNorm(use_running_average=not train,
                                      dtype=jdt, stats="pallas")
    tmod = tcnn._norm(flavour, C)
    with torch.no_grad():
        tmod.weight.copy_(_t(variables["params"]["scale"]))
        tmod.bias.copy_(_t(variables["params"]["bias"]))
        tmod.running_mean.copy_(_t(variables["batch_stats"]["mean"]))
        tmod.running_var.copy_(_t(variables["batch_stats"]["var"]))
    return jmod, variables, tmod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flavour", NORMS)
def test_batchnorm_flavours_match_flax(flavour, dtype):
    """Train and eval outputs, the updated running statistics (biased
    variance, 0.9·old + 0.1·batch) and the gradients of an asymmetric loss
    with respect to x, scale and bias, against flax ``nn.BatchNorm`` and
    ``DotStatsBatchNorm(stats="pallas")``. fp32: 1e-5·max(1, |ref|);
    bf16 outputs and dx: 2 ulps of bf16 (2^-7·max|ref|), since the two
    flavours round at different places and each must match its own."""
    C = 8
    jmod, variables, tmod = _bn_pair(flavour, C, dtype)
    x = np.random.default_rng(1).normal(0.5, 1.2, (4, 5, 6, C)).astype(
        np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tdt = getattr(torch, dtype)

    def tol(ref):
        scale = max(1.0, float(np.abs(ref).max()))
        return (2.0 ** -7 if dtype == "bfloat16" else 1e-5) * scale

    def jloss(params, x):
        out, mut = jmod(True).apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            mutable=["batch_stats"])
        return (out.astype(jnp.float32) ** 3).mean(), (out, mut)

    (_, (jout, jmut)), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables["params"], jx)
    tx = _t(x, dtype).requires_grad_()
    tmod.train()
    out = tmod(tx, tdt)
    assert out.dtype == tdt
    (out.float() ** 3).mean().backward()
    want = np.asarray(jout.astype(jnp.float32))
    np.testing.assert_allclose(out.detach().float().numpy(), want, rtol=0,
                               atol=tol(want))
    for name, buf in (("mean", tmod.running_mean),
                      ("var", tmod.running_var)):
        np.testing.assert_allclose(
            buf.numpy(), np.asarray(jmut["batch_stats"][name]), rtol=1e-5,
            atol=1e-6, err_msg=name)
    assert int(tmod.num_batches_tracked) == 0
    for name, got, ref in (("dx", tx.grad, gx), ("dscale", tmod.weight.grad,
                                                 gp["scale"]),
                           ("dbias", tmod.bias.grad, gp["bias"])):
        ref = np.asarray(ref.astype(jnp.float32))
        # parameter gradients are fp32 sums of bf16-rounded terms
        atol = tol(ref) * (4 if name != "dx" and dtype == "bfloat16" else 1)
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=atol, err_msg=name)

    jeval = jmod(False).apply(variables, jx)
    tmod.eval()
    with torch.no_grad():
        tmod.running_mean.copy_(_t(variables["batch_stats"]["mean"]))
        tmod.running_var.copy_(_t(variables["batch_stats"]["var"]))
        got = tmod(tx.detach(), tdt)
    want = np.asarray(jeval.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol(want))


def test_ema_chain_and_grouped_batchnorm_match_jax():
    """``ema_chain`` against the JAX function (rtol 1e-6), and the grouped
    BatchNorm (3 groups of 2 samples, one layer) against flax ``nn.BatchNorm`` under
    the JAX grouped interceptor: output, running statistics and the
    gradients with respect to x, scale and bias, to 1e-5·max(1, |ref|);
    and the grouped module equals three sequential calls on the groups."""
    rng = np.random.default_rng(5)
    r0 = rng.normal(size=7).astype(np.float32)
    inc = rng.normal(size=(4, 7)).astype(np.float32)
    np.testing.assert_allclose(
        ghost_bn.ema_chain(_t(r0), _t(inc), 0.9).numpy(),
        np.asarray(jghost.ema_chain(jnp.asarray(r0), jnp.asarray(inc), 0.9)),
        rtol=1e-6)

    C, G = 8, 3
    jmod, variables, tmod = _bn_pair("batch", C, "float32", seed=2)
    x = rng.normal(0.5, 1.2, (6, 4, 5, C)).astype(np.float32)

    def jloss(params, x):
        with fnn.intercept_methods(jghost.ghost_batchnorm_interceptor(G)):
            out, mut = jmod(True).apply(
                {"params": params,
                 "batch_stats": variables["batch_stats"]}, x,
                mutable=["batch_stats"])
        return (out ** 3).mean(), (out, mut)

    (_, (jout, jmut)), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables["params"],
                                             jnp.asarray(x))
    seq = _bn_pair("batch", C, "float32", seed=2)[2].train()
    want_seq = torch.cat([seq(_t(x[2 * i:2 * i + 2]), torch.float32)
                          for i in range(G)])
    tx = _t(x).requires_grad_()
    tmod.train()
    tmod.groups = G
    out = tmod(tx, torch.float32)
    (out ** 3).mean().backward()
    for name, got, ref in (
            ("out", out, jout), ("dx", tx.grad, gx),
            ("dscale", tmod.weight.grad, gp["scale"]),
            ("dbias", tmod.bias.grad, gp["bias"]),
            ("mean", tmod.running_mean, jmut["batch_stats"]["mean"]),
            ("var", tmod.running_var, jmut["batch_stats"]["var"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            got.detach().numpy(), ref, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=name)
    np.testing.assert_allclose(out.detach().numpy(), want_seq.detach().numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tmod.running_mean.numpy(),
                               seq.running_mean.numpy(), rtol=1e-6)
    np.testing.assert_allclose(tmod.running_var.numpy(),
                               seq.running_var.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        tmod(_t(x[:4]), torch.float32)


@pytest.mark.parametrize("size,out", [(7, 3), (4, 8), (8, 4)])
def test_adaptive_avg_pool_matches_jax(size, out):
    """torch's bin boundaries in the non-divisible cases (7 → 3 and the
    upsampling 4 → 8) and the exact reshape-mean otherwise, to 1e-6; the
    non-divisible cases also against ``AdaptiveAvgPool2d`` itself."""
    x = np.random.default_rng(size).normal(size=(2, size, size, 5)).astype(
        np.float32)
    want = np.asarray(jcnn.adaptive_avg_pool(jnp.asarray(x), out))
    got = tcnn.adaptive_avg_pool(_t(x), out)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    stock = torch.nn.functional.adaptive_avg_pool2d(
        _t(x).permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), stock.numpy(), rtol=0, atol=1e-6)


# --- the tiny CNN -------------------------------------------------------------

def _jax_cnn(norm, seed=3):
    """(JAX config, module, numpy variables): the tiny CNN in fp32 with
    statistics moved off their initial 0/1 by one train-mode forward."""
    cfg = jcfg.CNNModelConfig(**TINY_CNN, normalization=norm)
    model, variables = init_model(cfg, rng=jax.random.PRNGKey(seed),
                                  dtype=jnp.float32)
    _, mut = jax.jit(lambda v, a: model.apply(
        v, *a, train=True, mutable=["batch_stats"]))(
            variables, tuple(map(jnp.asarray, inputs(90, 4, hw=50))))
    variables = {"params": variables["params"],
                 "batch_stats": mut["batch_stats"]}
    return cfg, model, _np(variables)


@pytest.fixture(scope="module", params=NORMS)
def jax_cnn(request):
    return (request.param, *_jax_cnn(request.param))


def _port_cnn(variables, norm, **kw):
    cfg = CNNModelConfig(**TINY_CNN, normalization=norm)
    model = build_model(cfg, device="cpu", dtype=torch.float32, train=True,
                        **kw)
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return model


def _sd(tree, stats, cfg):
    """A params-shaped JAX tree (params, grads, EMA) plus a batch_stats
    tree → reference names."""
    return state_dict_from_jax({"params": tree, "batch_stats": stats}, cfg)


def _assert_stats_close(model_or_dict, want, tol=1e-5):
    got = (tstate.batch_stats(model_or_dict)
           if isinstance(model_or_dict, torch.nn.Module) else model_or_dict)
    assert got and set(got) <= set(want)
    for name, buf in got.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(
            buf.numpy(), ref, rtol=0,
            atol=tol * max(1.0, float(np.abs(ref).max())), err_msg=name)


def test_cnn_state_dict_and_init(jax_cnn):
    """The JAX-exported state_dict strict-loads (fixture) with the keys in
    the port's own registration order; a seeded build repeats itself, its
    BatchNorms start at scale 1, bias 0, mean 0, var 1, WASP's weights at
    1/6, and the Kaiming and LeCun weights have the JAX initialiser's spread
    (ratio of standard deviations within 15 % over a whole model's
    worth; the few ECA taps are held to LeCun's cut at two sigma)."""
    norm, cfg, _, variables = jax_cnn
    sd = state_dict_from_jax(variables, cfg)
    model = _port_cnn(variables, norm)
    assert list(model.state_dict()) == list(sd)
    tcfg = CNNModelConfig(**TINY_CNN, normalization=norm)
    a, b = (build_model(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    assert all(torch.equal(v, b.state_dict()[k])
               for k, v in a.state_dict().items())
    assert not a.training and not any(p.requires_grad for p in a.parameters())
    fresh = state_dict_from_jax(_np(init_model(
        cfg, rng=jax.random.PRNGKey(1), dtype=jnp.float32)[1]), cfg)
    kinds = {}
    for k, v in a.state_dict().items():
        if k.endswith("norm.weight") or k.endswith("bn1.weight") \
                or k.endswith("running_var"):
            assert torch.equal(v, torch.ones_like(v)), k
        elif k.endswith("bias") or k.endswith("running_mean"):
            assert torch.equal(v, torch.zeros_like(v)), k
        elif k == "wasp.weights":
            np.testing.assert_allclose(v.numpy(), 1 / 6, rtol=1e-6)
        elif k.endswith("weight"):
            coord = any(s in k for s in (".conv1.", ".conv_h.", ".conv_w."))
            if v.dim() == 3:          # ECA: a handful of values, cut at 2σ
                bound = 2 * (1.0 / v.shape[-1]) ** 0.5 / 0.87962566103423978
                assert float(v.abs().max()) <= bound, k
                continue
            # compare on the initialiser's own scale
            fan = v[0].numel() if coord else v.shape[0] * v[0, 0].numel()
            got, want = kinds.setdefault("coord" if coord else "kaiming",
                                         ([], []))
            got.append(v.flatten() * fan ** 0.5)
            want.append(fresh[k].flatten() * fan ** 0.5)
    assert set(kinds) == {"kaiming", "coord"}
    for kind, (got, want) in kinds.items():
        ratio = torch.cat(got).std() / torch.cat(want).std()
        assert 0.85 < ratio < 1.15, (kind, float(ratio))


def test_cnn_block_outputs_match_jax(jax_cnn):
    """Eval forward: every backbone block's and the WASP module's output
    (shape, so each stage's spatial size, and values) and the final joints
    against the JAX model's captured intermediates, fp32, to
    1e-4·max(1, |ref|)."""
    norm, cfg, jmodel, variables = jax_cnn
    args = inputs(91, 2, hw=50)
    want, state = jax.jit(lambda v, a: jmodel.apply(
        v, *a, train=False, capture_intermediates=True,
        mutable=["intermediates"]))(variables, tuple(map(jnp.asarray, args)))
    inter = state["intermediates"]
    model = _port_cnn(variables, norm).eval()
    seen = {}
    blocks = {name: model.get_submodule(prefix[:-1]) for prefix, name, *_
              in iter_cnn_stage_blocks(cfg)}
    blocks["WASPModule_0"] = model.wasp
    hooks = [m.register_forward_hook(
        lambda _m, _a, out, name=name: seen.__setitem__(name, out))
        for name, m in blocks.items()]
    with torch.no_grad():
        got = model(*map(_t, args))
    for h in hooks:
        h.remove()
    sizes = []
    for name in blocks:
        ref = np.asarray(inter[name]["__call__"][0])
        assert tuple(seen[name].shape) == ref.shape, name
        sizes.append(ref.shape[1])
        np.testing.assert_allclose(
            seen[name].numpy(), ref, rtol=0,
            atol=1e-4 * max(1.0, float(np.abs(ref).max())), err_msg=name)
    assert sizes == [13, 7, 7, 7, 4, 4, 4, 4]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_cnn_bf16_eval_forward_matches_jax(jax_cnn):
    """bf16 compute over the fp32 weights, eval mode: the port against the
    JAX model in bf16, and each against its own fp32 run, relative L2 of
    the joints <= 2e-2 (measured 6e-3 to 7e-3 between the frameworks, 3e-3
    to 7e-3 against fp32: bf16 rounding through ~60 layers). No conv shape
    is left out: every bf16 conv of this model on this CPU stays within
    that bound of its fp32 self. The train-mode forward is not held in
    bf16 at this size: with 2 samples JAX's own bf16 run sits 7e-2 from
    its fp32 run, so the bound would hold nothing; the bf16 BatchNorm
    arithmetic of each flavour is held layer by layer above."""
    from pose3d_tpu.models import build_model as jax_build_model

    norm, cfg, jmodel, variables = jax_cnn
    args = inputs(91, 2, hw=50)
    jargs = tuple(map(jnp.asarray, args))
    runs = {}
    for name, mod in (("jax32", jmodel),
                      ("jax16", jax_build_model(cfg, dtype=jnp.bfloat16))):
        runs[name] = np.asarray(jax.jit(
            lambda v, a, mod=mod: mod.apply(v, *a, train=False))(
                variables, jargs))
    model = _port_cnn(variables, norm).eval()
    for name, dt in (("port32", torch.float32), ("port16", torch.bfloat16)):
        model.dtype = dt
        with torch.no_grad():
            out = model(*map(_t, args))
        assert out.dtype == torch.float32
        runs[name] = out.numpy()
    for a, b in (("port16", "jax16"), ("port16", "port32"),
                 ("jax16", "jax32")):
        assert rel_l2(runs[a], runs[b]) <= 2e-2, (a, b)


@pytest.fixture(scope="module")
def jax_cnn_grads(jax_cnn):
    """``jax.value_and_grad`` of the step's loss on one batch of 4, with
    the updated ``batch_stats``."""
    norm, cfg, jmodel, variables = jax_cnn
    img, depth, kpt = inputs(92, 4, hw=50)
    batch = {"image": img, "depth": depth, "keypoints_2d": kpt,
             "joints_3d": np.random.default_rng(8).normal(
                 scale=0.5, size=(4, 17, 3)).astype(np.float32)}
    fn = jax.jit(lambda p, s, b: jax.value_and_grad(
        jstep._loss_fn, has_aux=True)(p, s, jmodel.apply, b,
                                      jax.random.PRNGKey(0),
                                      jlosses.LossWeights()))
    (loss, (_, stats)), grads = fn(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, float(loss), _sd(_np(grads), _np(stats), cfg)


def test_cnn_gradients_match_jax(jax_cnn, jax_cnn_grads):
    """Train forward: the loss (rtol 1e-5), every parameter's gradient
    (``GRAD_TOL``·max(1, |ref|) per tensor) and every updated running mean and
    variance (1e-5·max(1, |ref|)) against JAX, weights and statistics
    carried by ``state_dict_from_jax``."""
    norm, cfg, _, variables = jax_cnn
    batch, want_loss, want = jax_cnn_grads
    model = _port_cnn(variables, norm)
    loss, _ = tstep._forward_loss(model, loop.to_device(batch, "cpu"),
                                  losses.LossWeights(), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), ref, rtol=0,
            atol=_grad_atol(ref), err_msg=name)
    _assert_stats_close(model, want)


def test_cnn_remat_changes_nothing(jax_cnn, jax_cnn_grads):
    """``remat=True`` (each block recomputed in the backward) gives the
    loss, gradients and running statistics of ``remat=False``: the
    recomputation must not move the statistics a second time. Equal to
    1e-6·max(1, |ref|)."""
    norm, _, _, variables = jax_cnn
    batch = loop.to_device(jax_cnn_grads[0], "cpu")
    runs = []
    for remat in (False, True):
        model = _port_cnn(variables, norm, remat=remat)
        loss, _ = tstep._forward_loss(model, batch, losses.LossWeights(),
                                      None)
        loss.backward()
        runs.append((loss.item(), model))
    assert runs[0][0] == pytest.approx(runs[1][0], rel=1e-6)
    plain = dict(runs[0][1].named_parameters())
    for name, p in runs[1][1].named_parameters():
        ref = plain[name].grad
        assert (p.grad - ref).abs().max() <= 1e-6 * max(
            1.0, float(ref.abs().max())), name
    _assert_stats_close(runs[1][1], tstate.batch_stats(runs[0][1]), 1e-6)


# --- optimizer steps ------------------------------------------------------------

def _superbatch(seed, A, B):
    rng = np.random.default_rng(seed)
    batches = []
    for a in range(A):
        img, depth, kpt = inputs(seed * 10 + a, B, hw=50)
        batches.append({
            "image": img, "depth": depth, "keypoints_2d": kpt,
            "joints_3d": rng.normal(scale=0.5, size=(B, 17, 3)).astype(
                np.float32)})
    return batches, next(loop._superbatches(batches, A))


@pytest.fixture(scope="module")
def jax_cnn_step(jax_cnn):
    """One JAX optimizer step (A 3 × B 4, uint8-compact superbatch, EMA
    0.999 with ``ema_batch_stats``) from the tiny CNN (groups of 2 samples
    are too ill-conditioned to compare: the 1×1 global-context BatchNorm
    then takes its variance from two values, and JAX's fp32 gradient sits
    2e-3 from the port's fp64 one): ``grouped`` for
    "batch", ``scan`` for "batch_pallas" (the mode that takes it), and the
    gradients the step applied."""
    norm, cfg, jmodel, variables = jax_cnn
    mode = "grouped" if norm == "batch" else "scan"
    _, sb = _superbatch(4, 3, 4)
    jsb = {k: jnp.asarray(v) for k, v in sb.items()}
    st = jstate.create_train_state(jmodel, variables, learning_rate=LR,
                                   ema=True)
    assert st.ema_batch_stats is not None
    new, m = jstep.make_train_step(jmodel, accum_mode=mode, donate=False,
                                   ema_decay=0.999)(
        st, jsb, jax.random.PRNGKey(0))
    # the applied gradient, from the scan oracle's definition: the mean
    # over microbatches of each microbatch's gradient at the running
    # statistics that microbatch sees
    grad_fn = jax.jit(lambda p, s, b: jax.value_and_grad(
        jstep._loss_fn, has_aux=True)(p, s, jmodel.apply, b,
                                      jax.random.PRNGKey(0),
                                      jlosses.LossWeights()))
    stats, total = variables["batch_stats"], None
    for i in range(3):
        (_, (_, stats)), g = grad_fn(variables["params"], stats,
                                     {k: v[i] for k, v in jsb.items()})
        total = g if total is None else jax.tree_util.tree_map(
            jnp.add, total, g)
    grads = jax.tree_util.tree_map(lambda g: g / 3, total)
    bs = _np(new.batch_stats)
    return dict(
        mode=mode, sb=sb, grads=_sd(_np(grads), bs, cfg),
        new=_sd(_np(new.params), bs, cfg),
        ema=_sd(_np(new.ema_params), _np(new.ema_batch_stats), cfg),
        metrics={k: float(v) for k, v in m.items()})


def _port_step(variables, norm, mode, sb, **kw):
    model = _port_cnn(variables, norm, **kw)
    st = tstate.create_train_state(model, LR, 0.01, ema=True)
    m = tstep.make_train_step(accum_mode=mode, ema_decay=0.999)(
        st, loop.to_device(sb, "cpu"))
    return model, st, m


def test_cnn_optimizer_step_matches_jax(jax_cnn, jax_cnn_step):
    """One step of the mode JAX runs for this normalisation (grouped for
    "batch", scan for "batch_pallas"): loss components (rtol 1e-5), the
    gradients the step applied (``GRAD_TOL``·max(1, |ref|)), params and EMA params
    (bounds of ``assert_params_close``), and ``batch_stats`` and
    ``ema_batch_stats`` (1e-5·max(1, |ref|)) after it. The EMA of the
    statistics is also held to its definition, d = 2/11 at step 1."""
    norm, _, _, variables = jax_cnn
    ref = jax_cnn_step
    model0 = _port_cnn(variables, norm)
    s0 = {n: b.clone() for n, b in tstate.batch_stats(model0).items()}
    model, st, m = _port_step(variables, norm, ref["mode"], ref["sb"])
    assert st.step == 1 and set(m) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(m[k].item(), v, rtol=1e-5, err_msg=k)
    params = dict(model.named_parameters())
    for name, p in params.items():
        g = ref["grads"][name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), g, rtol=0,
            atol=_grad_atol(g), err_msg=name)
    assert_params_close(params, ref["new"], ref["grads"], LR, _grad_atol)
    assert_params_close(st.ema_params, ref["ema"], ref["grads"], LR,
                        _grad_atol)
    _assert_stats_close(model, ref["new"])
    assert set(st.ema_batch_stats) == set(tstate.batch_stats(model))
    _assert_stats_close(st.ema_batch_stats, ref["ema"])
    d = 2.0 / 11.0
    for name, e in st.ema_batch_stats.items():
        want = d * s0[name] + (1 - d) * tstate.batch_stats(model)[name]
        np.testing.assert_allclose(e.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_cnn_grouped_equals_scan_and_refuses_bn_stats_flavour(jax_cnn,
                                                             jax_cnn_step):
    """In the port, the other accumulation mode gives the same step:
    for "batch", scan ≡ grouped (held to the JAX grouped reference, same
    bounds); for "batch_pallas", grouped raises as the JAX package does
    and leaves the BatchNorms ungrouped."""
    norm, _, _, variables = jax_cnn
    ref = jax_cnn_step
    if norm == "batch_pallas":
        model = _port_cnn(variables, norm)
        st = tstate.create_train_state(model)
        with pytest.raises(NotImplementedError, match="batch_pallas"):
            tstep.make_train_step(accum_mode="grouped")(
                st, loop.to_device(ref["sb"], "cpu"))
        assert st.step == 0
        return
    model, st, m = _port_step(variables, norm, "scan", ref["sb"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(m[k].item(), v, rtol=1e-5, err_msg=k)
    assert_params_close(dict(model.named_parameters()), ref["new"],
                        ref["grads"], LR, _grad_atol)
    _assert_stats_close(model, ref["new"])
    _assert_stats_close(st.ema_batch_stats, ref["ema"])
    assert all(mod.groups == 1 for mod in model.modules()
               if isinstance(mod, tcnn.BatchNorm))


def test_with_ema_params_swaps_statistics_and_warns_without_them(jax_cnn):
    """``with_ema_params`` puts the averaged weights and the averaged
    running statistics into the model and brings the live ones back; a
    state with ``ema_params`` only, on a model with BatchNorm, warns."""
    norm, _, _, variables = jax_cnn
    model = _port_cnn(variables, norm)
    st = tstate.create_train_state(model, ema=True)
    name = "conv1.0.norm.running_mean"
    live = model.state_dict()[name].clone()
    st.ema_batch_stats[name] += 1.0
    st.ema_params["conv1.0.conv.weight"] += 1.0
    w = model.conv1[0].conv.weight.detach().clone()
    with tstate.with_ema_params(st):
        assert torch.equal(model.state_dict()[name], live + 1.0)
        assert torch.equal(model.conv1[0].conv.weight, w + 1.0)
    assert torch.equal(model.state_dict()[name], live)
    assert torch.equal(model.conv1[0].conv.weight, w)
    st.ema_batch_stats = None
    with pytest.warns(UserWarning, match="ema_batch_stats"):
        with tstate.with_ema_params(st):
            assert torch.equal(model.state_dict()[name], live)


# --- checkpoint and serving -------------------------------------------------------

def test_cnn_pth_round_trip_and_http(jax_cnn, tmp_path):
    """``save_pose_model`` → ``load_pose_model`` keeps config, weights and
    running statistics; the file served over the port's HTTP server on the
    CPU answers ``/predict`` with the eval-mode forward (fp32, 1e-5) and
    names its model type on ``/meta``."""
    norm, cfg, jmodel, variables = jax_cnn
    model = _port_cnn(variables, norm).eval()
    pth = save_pose_model(model, tmp_path / "cnn.pth", step=7)
    loaded, lcfg = load_pose_model(pth, "cpu", dtype=torch.float32)
    assert lcfg == model.config and lcfg.normalization == norm
    assert not loaded.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, loaded.state_dict()[k]), k
    args = inputs(93, 3, hw=50)
    with torch.no_grad():
        want = model(*map(_t, args)).numpy()
    jwant = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, *a, train=False))(
        variables, tuple(map(jnp.asarray, args))))
    np.testing.assert_allclose(want, jwant, rtol=0, atol=1e-4)

    srv = make_server(pth, "127.0.0.1", 0, device="cpu",
                      dtype=torch.float32, max_batch=4)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_port}"
    try:
        buf = io.BytesIO()
        np.savez(buf, image=args[0], depth=args[1], keypoints_2d=args[2])
        req = urllib.request.Request(base + "/predict", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            got = np.load(io.BytesIO(r.read()))["joints_3d"]
        with urllib.request.urlopen(base + "/meta", timeout=30) as r:
            meta = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
        thread.join(timeout=30)
    # served in a padded batch of 4: eval-mode BatchNorm is per sample
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert meta["artifact"]["model_type"] == "cnn"
    assert meta["image_size"] == [50, 50]


def test_cnn_refuses_unported_normalisation_and_missing_generator():
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(CNNModelConfig(**TINY_CNN, normalization="switchable"),
                    device="cpu")
    cfg = dataclasses.replace(CNNModelConfig(**TINY_CNN),
                              regression_dropout=0.2)
    model = build_model(cfg, device="cpu", dtype=torch.float32, train=True)
    args = list(map(_t, inputs(1, 2, hw=50)))
    with pytest.raises(ValueError, match="Generator"):
        model(*args)
    a = model(*args, generator=torch.Generator().manual_seed(1))
    b = model(*args, generator=torch.Generator().manual_seed(2))
    assert not torch.equal(a, b)

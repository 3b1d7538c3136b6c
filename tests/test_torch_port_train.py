"""pose3d_tpu_torch training path against the JAX package on the same numpy
inputs and weights: the flash-attention backward's plain version and its
autograd wiring, losses, metrics, the lifter's gradients, one AdamW + EMA
step (grouped and scan), the freeze mask with clipping, LR schedules, the
eval step and ``evaluate`` over a ragged last batch, and ``train_model``
end to end on the CPU. JAX attention runs the Pallas kernels in interpret
mode."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import (
    TINY_KW,
    assert_params_close as _assert_params_close,
    inputs,
    jax_model,
)

from pose3d_tpu.core import config as jcfg
from pose3d_tpu.data.collate import compact_batch as jax_compact_batch
from pose3d_tpu.geometry import metrics as jmetrics
from pose3d_tpu.ops import losses as jlosses
from pose3d_tpu.ops.pallas.flash_attention import _bwd_impl, _fwd_impl
from pose3d_tpu.train import loop as jloop
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import step as jstep

from pose3d_tpu_torch.checkpoint import load_pose_model
from pose3d_tpu_torch.compat import state_dict_from_jax
from pose3d_tpu_torch.core.config import GlobalConfig, TransformerModelConfig
from pose3d_tpu_torch.data.collate import compact_batch
from pose3d_tpu_torch.geometry import metrics
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.ops import losses
from pose3d_tpu_torch.ops.attention import dot_product_attention
from pose3d_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
from pose3d_tpu_torch.train import loop, state as tstate, step as tstep

NO_DROPOUT = dict(transformer_dropout_rate=0.0, regression_dropout=0.0)
CFG0 = TransformerModelConfig(**TINY_KW, **NO_DROPOUT)
LR = 1e-3


# --- flash-attention backward ---------------------------------------------

# (B, Tq, Tk, H, D): self, the cross shapes (Tk 16, Tq 16), ragged edges
# across the 64-row tiles and the TPU kernel's 128 pad, D 32/48/64.
BWD_SHAPES = [
    (2, 17, 17, 2, 64),
    (2, 70, 16, 2, 48),
    (2, 16, 70, 2, 48),
    (1, 1, 1, 2, 64),
    (1, 130, 17, 2, 32),
    (1, 17, 130, 3, 48),
]


def _qkv(shape, seed):
    B, Tq, Tk, H, D = shape
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, H, D)).astype(np.float32)
            for T in (Tq, Tk, Tk, Tq)]


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_plain_backward_matches_pallas_backward(shape):
    """dq, dk, dv of the plain version vs the Pallas ``_bwd_impl``
    (interpret mode) on the Pallas forward's o and lse, fp32, to
    1e-5·max(1, |ref|): summation order only."""
    q, k, v, g = _qkv(shape, sum(shape))
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    jo, jlse = _fwd_impl(jq, jk, jv, True)
    want = _bwd_impl(jq, jk, jv, jo, jg, jlse, True)
    Tq = shape[1]
    got = flash_attention_bwd_reference(
        *map(torch.from_numpy, (q, k, v, np.array(jo), g,
                                np.array(jlse)[..., :Tq])))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == torch.float32, name
        tol = 1e-5 * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("shape", BWD_SHAPES[:3])
def test_autograd_function_matches_torch_autograd(shape):
    """The Function's plain pair (CPU) gives the gradients torch.autograd
    finds through the plain forward, to 1e-5·max(1, |ref|); q/k/v as the
    strided views of one projection, as the model hands them over."""
    B, Tq, Tk, H, D = shape
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.normal(size=(B, Tq, 3, H, D)).astype(
        np.float32))
    kv = torch.from_numpy(rng.normal(size=(B, Tk, 2, H, D)).astype(
        np.float32))
    w = torch.from_numpy(rng.normal(size=(B, Tq, H, D)).astype(np.float32))
    grads = []
    for attend in (dot_product_attention,
                   lambda q, k, v: flash_attention_fwd_reference(q, k, v)[0]):
        a = qkv.clone().requires_grad_()
        b = kv.clone().requires_grad_()
        q = a.unbind(2)[0]
        k, v = b.unbind(2)
        (attend(q, k, v) * w).sum().backward()
        grads.append((a.grad, b.grad))
    for got, want in zip(grads[0], grads[1]):
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        assert (got - want).abs().max().item() <= tol


def test_attention_output_is_differentiable_and_raw_kernel_refuses_grad():
    """The raw forward launcher's output has no graph, so it refuses
    inputs that require grad with grad mode on (it would drop their
    gradients); every ``dot_product_attention`` output carries the
    Function's grad_fn."""
    q = torch.randn(1, 5, 2, 64, requires_grad=True)
    o = dot_product_attention(q, q, q)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    with pytest.raises(RuntimeError, match="drop their gradients"):
        flash_attention_fwd(q, q, q)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, q, q)       # no grad: the usual device check


def test_backward_wrapper_rejects():
    x = torch.zeros(1, 4, 2, 64)
    lse = torch.zeros(1, 2, 4)
    before = flash_attention_bwd.launches
    with pytest.raises(ValueError, match="do must have q's shape"):
        flash_attention_bwd(x, x, x, x, torch.zeros(1, 5, 2, 64), lse)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(x, x, x, x, x, lse)
    assert flash_attention_bwd.launches == before


# --- losses and metrics ----------------------------------------------------

def _poses(seed, b=4, j=17):
    rng = np.random.default_rng(seed)
    gt = rng.normal(scale=300.0, size=(b, j, 3)).astype(np.float32)
    pred = gt + rng.normal(scale=40.0, size=gt.shape).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("per_sample", [False, True])
def test_losses_match_jax(per_sample):
    pred, gt = _poses(0)
    w = losses.LossWeights(mse=0.5, l1=2.0, inter_joint=100.0, abs_root=3.0)
    jfn = (jlosses.composite_pose_loss_per_sample if per_sample
           else jlosses.composite_pose_loss)
    tfn = (losses.composite_pose_loss_per_sample if per_sample
           else losses.composite_pose_loss)
    jt, jc = jfn(jnp.asarray(pred), jnp.asarray(gt),
                 jlosses.LossWeights(*w))
    tt, tc = tfn(torch.from_numpy(pred), torch.from_numpy(gt), w)
    assert set(tc) == set(jc)
    for k in jc:
        want = np.asarray(jc[k])
        assert tuple(tc[k].shape) == want.shape, k
        np.testing.assert_allclose(tc[k].numpy(), want, rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5)
    assert losses.LossWeights() == tuple(jlosses.LossWeights())


@pytest.mark.parametrize("compat", [False, True])
def test_metrics_match_jax(compat):
    """mpjpe, procrustes_align and pa_mpjpe in both rotation conventions,
    with one degenerate prediction (all joints at one point: scale
    falls back to 1), to 1e-3 mm on poses of a few hundred mm."""
    pred, gt = _poses(1, b=5)
    rot = np.linalg.qr(np.random.default_rng(2).normal(size=(3, 3)))[0]
    pred[1] = pred[1] @ rot.astype(np.float32) * 1.3 + 50.0
    pred[2] = 7.0
    jp, jg = jnp.asarray(pred), jnp.asarray(gt)
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    np.testing.assert_allclose(metrics.mpjpe(tp, tg).numpy(),
                               np.asarray(jmetrics.mpjpe(jp, jg)), rtol=1e-6)
    np.testing.assert_allclose(
        metrics.procrustes_align(tp, tg, compat).numpy(),
        np.asarray(jmetrics.procrustes_align(jp, jg, compat)),
        rtol=0, atol=1e-3)
    np.testing.assert_allclose(
        metrics.pa_mpjpe(tp, tg, compat).numpy(),
        np.asarray(jmetrics.pa_mpjpe(jp, jg, compat)), rtol=1e-5)
    with pytest.raises(ValueError, match="Shape mismatch"):
        metrics.mpjpe(tp, tg[:, :3])


# --- the lifter's gradients and one optimizer step ------------------------

def _superbatch(seed, A, B):
    """A list of A numpy batches of B samples, and the same as the
    uint8-compact [A, B, ...] superbatch the loop makes."""
    rng = np.random.default_rng(seed)
    batches = []
    for a in range(A):
        img, depth, kpt = inputs(seed * 10 + a, B)
        batches.append({
            "image": img, "depth": depth, "keypoints_2d": kpt,
            "joints_3d": rng.normal(scale=0.5, size=(B, 17, 3)).astype(
                np.float32),
        })
    return batches, next(loop._superbatches(batches, A))


@pytest.fixture(scope="module")
def jax_tiny():
    return jax_model(seed=3, **NO_DROPOUT)


def _port_model(variables, cfg=CFG0):
    model = build_model(cfg, device="cpu", dtype=torch.float32, train=True)
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return model


def _jax_sd(tree, cfg=CFG0):
    """A JAX params-shaped tree (params, grads, ...) → reference names."""
    return state_dict_from_jax({"params": tree}, cfg)


def test_compact_and_decompact_match_jax():
    batches, sb = _superbatch(0, 1, 3)
    ours = compact_batch(batches[0])
    theirs = jax_compact_batch(batches[0])
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    want = jstep.decompact_batch({k: jnp.asarray(v) for k, v in ours.items()})
    got = tstep.decompact_batch({k: torch.from_numpy(v)
                                 for k, v in ours.items()})
    assert set(got) == set(want) and "depth_scale" not in got
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def jax_one_step(jax_tiny):
    """The JAX reference for one grouped step (A 2, B 2, uint8-compact
    superbatch) with EMA 0.999 from the tiny lifter's weights: the loss and
    gradients of the step's loss (``jax.value_and_grad``), and the new
    params, EMA params and metrics of ``make_train_step``."""
    cfg, jmodel, variables = jax_tiny
    _, sb = _superbatch(2, 2, 2)
    jsb = {k: jnp.asarray(v) for k, v in sb.items()}
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in jsb.items()}
    grad_fn = jax.jit(lambda p, b: jax.value_and_grad(
        jstep._loss_fn, has_aux=True)(p, {}, jmodel.apply, b,
                                      jax.random.PRNGKey(0),
                                      jlosses.LossWeights()))
    (loss, _), grads = grad_fn(variables["params"], flat)
    st = jstate.create_train_state(jmodel, variables, learning_rate=LR,
                                   ema=True)
    step = jstep.make_train_step(jmodel, accum_mode="grouped", donate=False,
                                 ema_decay=0.999)
    new, m = step(st, jsb, jax.random.PRNGKey(0))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(sb=sb, loss=float(loss), jax_grads=tree(grads),
                grads=_jax_sd(tree(grads)),
                params=_jax_sd(tree(new.params)),
                ema=_jax_sd(tree(new.ema_params)),
                metrics={k: float(v) for k, v in m.items()})


def test_lifter_gradients_match_jax(jax_tiny, jax_one_step):
    """Loss and every parameter's gradient of the grouped step's loss
    (flat A·B batch, uint8-compact input, dropout 0, fp32) against
    ``jax.value_and_grad`` of the JAX step's loss, the JAX gradients
    mapped to reference names through ``state_dict_from_jax``; to
    1e-4·max(1, |ref|) per tensor."""
    _, _, variables = jax_tiny
    sb = jax_one_step["sb"]
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in sb.items()}
    model = _port_model(variables)
    loss, _ = tstep._forward_loss(
        model, loop.to_device(flat, "cpu"), losses.LossWeights(), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_one_step["loss"], rtol=1e-5)
    want = jax_one_step["grads"]
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
        ref = want[name].numpy()
        tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("accum_mode", ["grouped", "scan"])
def test_one_adamw_ema_step_matches_jax(jax_tiny, jax_one_step, accum_mode):
    """Params, EMA params and loss components after one step against the
    JAX grouped step; "scan" (sequential microbatches) is held to the same
    reference, which makes scan ≡ grouped in the port."""
    _, _, variables = jax_tiny
    ref = jax_one_step
    model = _port_model(variables)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    st = tstate.create_train_state(model, LR, 0.01, ema=True)
    step = tstep.make_train_step(accum_mode=accum_mode, ema_decay=0.999)
    m = step(st, loop.to_device(ref["sb"], "cpu"))
    assert st.step == 1 and set(m) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(m[k].item(), v, rtol=1e-5, err_msg=k)
    params = dict(model.named_parameters())
    _assert_params_close(params, ref["params"], ref["grads"])
    # EMA after step 1: d = min(0.999, (1 + 1)/(10 + 1)) = 2/11 and
    # ema = d·p0 + (1 − d)·p1. Against the port's own p1 the ramp is held
    # to fp32 rounding (no EMA, d = 0.999 or the ramp one step off, d =
    # 1/10, miss by ~0.08·lr); against JAX's EMA with the params'
    # bounds, since the (1 − d) share carries p1's uncertainty.
    d = 2.0 / 11.0
    assert set(st.ema_params) == set(params)
    for name, e in st.ema_params.items():
        want = d * p0[name].double() + (1 - d) * params[name].detach().double()
        np.testing.assert_allclose(e.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    _assert_params_close(st.ema_params, ref["ema"], ref["grads"])


def _freeze_backbone(path) -> bool:
    """``--freeze-backbone`` on a JAX params path: trainable unless under
    vit_backbone, its patch_embed excepted."""
    keys = "/".join(str(getattr(p, "key", getattr(p, "idx", "?")))
                    for p in path)
    return (keys.startswith("vit_backbone/patch_embed")
            or not keys.startswith("vit_backbone"))


def test_freeze_mask_and_clipping_match_jax(jax_tiny, jax_one_step):
    """``--freeze-backbone`` (vit_backbone frozen, its patch_embed
    trainable) with clip-by-global-norm 0.05, one grouped step. The
    gradients the port's AdamW reads (``.grad`` after the step) against
    ``optax.clip_by_global_norm(0.05)`` of JAX's trainable gradients, to
    1e-5·max(1, |ref|), with the clip firing; the params against JAX's
    multi_transform(set_to_zero) + clip step, with the bounds of
    ``_assert_params_close`` (Adam's first step barely sees the clip's
    scale, so the gradients are what holds the clip)."""
    _, jmodel, variables = jax_tiny
    ref = jax_one_step
    sb = ref["sb"]
    freeze = dict(frozen_prefixes=["vit_backbone"],
                  trainable_exceptions=["vit_backbone/patch_embed"])
    st = jstate.create_train_state(jmodel, variables, learning_rate=LR,
                                   clip_grad_norm=0.05, **freeze)
    new, _ = jstep.make_train_step(jmodel, donate=False)(
        st, {k: jnp.asarray(v) for k, v in sb.items()},
        jax.random.PRNGKey(0))
    want = _jax_sd(jax.tree_util.tree_map(np.asarray, new.params))
    trainable = jax.tree_util.tree_map_with_path(
        lambda path, g: g if _freeze_backbone(path) else np.zeros_like(g),
        ref["jax_grads"])
    assert float(optax.global_norm(trainable)) > 10 * 0.05
    clipped, _ = optax.clip_by_global_norm(0.05).update(
        trainable, optax.EmptyState())
    clipped = _jax_sd(jax.tree_util.tree_map(np.asarray, clipped))
    before = _jax_sd(variables["params"])
    model = _port_model(variables)
    tst = tstate.create_train_state(model, LR, 0.01, clip_grad_norm=0.05,
                                    **freeze)
    tstep.make_train_step()(tst, loop.to_device(sb, "cpu"))
    n_frozen = 0
    for name, p in model.named_parameters():
        frozen = (name.startswith("vit_backbone.")
                  and not name.startswith("vit_backbone.patch_embed."))
        n_frozen += frozen
        assert p.requires_grad != frozen, name
        if frozen:
            assert p.grad is None, name
            np.testing.assert_array_equal(p.detach().numpy(),
                                          before[name].numpy())
            continue
        g = clipped[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), g, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(g).max())), err_msg=name)
    _assert_params_close(dict(model.named_parameters()), want, clipped)
    assert n_frozen > 0


@pytest.mark.parametrize("kw", [
    dict(schedule="constant", warmup_steps=3),
    dict(schedule="cosine", warmup_steps=2, decay_steps=9,
         end_lr_factor=0.1),
    dict(schedule="linear", warmup_steps=3, decay_steps=8),
    dict(schedule="cosine", warmup_steps=0, decay_steps=5),
])
def test_lr_schedule_matches_optax(kw):
    """The LR that optimizer step t uses, t = 0..11, against optax's
    schedule at count t (fp32 in optax: rtol 1e-6)."""
    want = jstate.make_lr_schedule(LR, **kw)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.AdamW([p], lr=LR)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, tstate.make_lr_schedule(**kw))
    for t in range(12):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(want(t)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {t}")
        opt.step()
        sched.step()
    assert tstate.make_lr_schedule() is None
    with pytest.raises(ValueError, match="decay_steps"):
        tstate.make_lr_schedule("cosine")


def test_eval_step_and_ragged_evaluate_match_jax(jax_tiny):
    """Per-sample eval metrics and the exact average over batches of 3, 3
    and 2, both PA conventions, vs the JAX
    ``make_eval_step(per_sample=True)`` and ``evaluate`` (which pads the
    last batch to 3 and masks the padding; the port runs it at 2); to
    1e-4 relative."""
    _, jmodel, variables = jax_tiny
    batches, _ = _superbatch(5, 3, 3)
    batches[-1] = {k: v[:2] for k, v in batches[-1].items()}
    jst = jstate.create_train_state(jmodel, variables)
    model = _port_model(variables)
    st = tstate.create_train_state(model)
    for compat in (False, True):
        want = jloop.evaluate(
            jstep.make_eval_step(jmodel, per_sample=True, compat_pa=compat),
            jst, batches, pad_to=3)
        got = loop.evaluate(
            tstep.make_eval_step(compat_pa=compat), st, batches)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    m, out = tstep.make_eval_step()(
        st, loop.to_device(batches[0], "cpu"))
    assert out.shape == (3, 17, 3) and m["pa_mpjpe"].shape == (3,)
    assert model.training      # the eval step restores the mode
    with pytest.raises(RuntimeError, match="no batches"):
        loop.evaluate(tstep.make_eval_step(), st, [])


# --- dropout, config, trainer ---------------------------------------------

def test_dropout_only_in_train_mode_and_from_the_generator():
    cfg = TransformerModelConfig(**TINY_KW)      # published dropout rates
    model = build_model(cfg, device="cpu", dtype=torch.float32, train=True)
    args = [torch.from_numpy(a) for a in inputs(9, 2)]
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    with pytest.raises(ValueError, match="Generator"):
        model(*args)
    a = model(*args, generator=gen(1))
    assert torch.equal(a, model(*args, generator=gen(1)))
    assert not torch.equal(a, model(*args, generator=gen(2)))
    model.eval()
    with torch.no_grad():
        e = model(*args)
        assert torch.equal(e, model(*args, generator=gen(1)))
    assert not torch.equal(a, e)
    serving = build_model(cfg, device="cpu", dtype=torch.float32)
    assert not serving.training
    assert not any(p.requires_grad for p in serving.parameters())
    assert all(p.requires_grad for p in model.parameters())


def test_global_config_matches_jax():
    ours = GlobalConfig().to_dict()
    theirs = jcfg.GlobalConfig().to_dict()
    assert ours == {k: theirs[k] for k in ours}


def test_grouped_step_refuses_batchnorm():
    """The grouped step groups the port's own BatchNorm; it refuses the
    flavours it cannot group (stock torch BatchNorm here; the bn_stats
    flavour in test_torch_port_cnn.py) and an unknown mode."""
    model = torch.nn.Sequential(torch.nn.BatchNorm1d(3))
    st = tstate.create_train_state(model)
    batch = {"image": torch.zeros(2, 2, 3)}
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        tstep.make_train_step()(st, batch)
    with pytest.raises(ValueError, match="accum_mode"):
        tstep.make_train_step(accum_mode="ghost")


class _Recorder:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((step, value))

    def flush(self):
        pass


def test_train_model_on_cpu_saves_a_servable_pth(tmp_path):
    """Two grouped steps (A 2, B 2) at the published dropout rates with
    EMA and a validation at step 2: finite losses, and the ``.pth`` it
    writes strict-loads through ``load_pose_model`` with the trained
    weights."""
    cfg = TransformerModelConfig(**TINY_KW)
    model = build_model(cfg, device="cpu", dtype=torch.float32, train=True,
                        generator=torch.Generator().manual_seed(11))
    st = tstate.create_train_state(model, ema=True)
    batches, _ = _superbatch(6, 4, 2)
    w = _Recorder()
    pth = tmp_path / "lifter.pth"
    st, n = loop.train_model(
        st, batches, batches[:2], writer=w, gradient_accumulation_steps=2,
        num_steps=5, max_epochs=1, eval_interval_steps=2,
        log_interval_steps=1,
        ema_decay=0.999, generator=torch.Generator().manual_seed(0),
        checkpoint_path=pth)
    assert n == 2 and st.step == 2          # 4 batches → 2 superbatches
    losses_seen = [v for _, v in w.scalars["Loss/train_step"]]
    assert len(losses_seen) == 2 and np.isfinite(losses_seen).all()
    assert np.isfinite(w.scalars["Metrics/MPJPE_validation_epoch_avg"][0][1])
    loaded, lcfg = load_pose_model(pth, "cpu", dtype=torch.float32)
    assert lcfg == cfg
    for (name, p), q in zip(model.named_parameters(), loaded.parameters()):
        assert torch.equal(p.detach(), q), name


# --- the loop's behaviour against the JAX loop ------------------------------

SCHED = dict(schedule="constant", warmup_steps=3)


class _LoopingLoader:
    """A loader that never ends a pass by itself: it repeats its batches and
    stamps each with ``_pos`` = (epoch, index), as ``BatchLoader(loop=True)``
    does; ``interrupt_at``: raise KeyboardInterrupt in place of that
    batch."""

    def __init__(self, batches, interrupt_at=None):
        self.batches, self.interrupt_at = batches, interrupt_at

    def __iter__(self):
        n = 0
        while True:
            for i, b in enumerate(self.batches):
                if n == self.interrupt_at:
                    raise KeyboardInterrupt
                epoch = n // len(self.batches)
                yield dict(b, _pos=np.array([epoch, i]))
                n += 1


class _Val:
    batch_size = 2

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def _jax_loop_run(jax_tiny, tmp_path, loader, val, **kw):
    _, jmodel, variables = jax_tiny
    sched = jstate.make_lr_schedule(LR, **SCHED)
    st = jstate.create_train_state(jmodel, variables, learning_rate=sched)
    w = _Recorder()
    st, n = jloop.train_model(
        st, "transformer", loader, val, model=jmodel,
        model_args=CFG0.to_dict() if hasattr(CFG0, "to_dict") else {},
        writer=w, gradient_accumulation_steps=2, log_interval_steps=2,
        preview_interval_steps=1000, lr_schedule=sched,
        checkpoint_prefix=str(tmp_path / "jax"), **kw)
    return w, n


def _port_loop_run(jax_tiny, tmp_path, loader, val, **kw):
    _, _, variables = jax_tiny
    st = tstate.create_train_state(
        _port_model(variables), learning_rate=LR,
        lr_schedule=tstate.make_lr_schedule(**SCHED))
    w = _Recorder()
    pth = tmp_path / "port.pth"
    st, n = loop.train_model(
        st, loader, val, writer=w, gradient_accumulation_steps=2,
        log_interval_steps=2, checkpoint_path=pth,
        generator=torch.Generator().manual_seed(0), **kw)
    return w, n, st, pth


@pytest.fixture(scope="module")
def loop_runs(jax_tiny, tmp_path_factory):
    """Both loops over the same looping loader of four batches of 2
    (accumulation 2: two steps an epoch), ``num_steps=None``,
    ``max_epochs=2``, a validation every 2 steps, a warmup schedule."""
    batches, _ = _superbatch(7, 4, 2)
    val = _Val(batches[:2])
    kw = dict(num_steps=None, max_epochs=2, eval_interval_steps=2)
    tmp = tmp_path_factory.mktemp("loops")
    jw, jn = _jax_loop_run(jax_tiny, tmp, _LoopingLoader(batches), val, **kw)
    pw, pn, _, _ = _port_loop_run(jax_tiny, tmp, _LoopingLoader(batches), val,
                                  **kw)
    return dict(jax=(jw, jn), port=(pw, pn))


def test_loop_stops_a_looping_loader_at_max_epochs_like_jax(loop_runs):
    """``num_steps=None`` over a loader that loops by itself: both loops
    stop from the stream's own epoch counter in ``_pos``, at the same
    step, and log that last step."""
    (jw, jn), (pw, pn) = loop_runs["jax"], loop_runs["port"]
    assert pn == jn and 0 < pn < 50
    assert [s for s, _ in pw.scalars["Loss/train_step"]] \
        == [s for s, _ in jw.scalars["Loss/train_step"]] \
        == list(range(1, pn + 1))


def test_loop_writes_the_scalar_tags_of_the_jax_loop(loop_runs):
    """The tags written at the flushes and the validations, and the steps
    each is written at, are the JAX loop's: every ``Loss_Components_Val/*``
    and ``Train/learning_rate`` among them."""
    jw, pw = loop_runs["jax"][0], loop_runs["port"][0]
    assert set(pw.scalars) == set(jw.scalars)
    assert any(t.startswith("Loss_Components_Val/") for t in pw.scalars)
    for tag in jw.scalars:
        assert [s for s, _ in pw.scalars[tag]] \
            == [s for s, _ in jw.scalars[tag]], tag


@pytest.mark.parametrize("tag,rtol", [
    ("Train/learning_rate", 1e-6),
    ("Loss/train_step", 1e-3),
    ("Loss/validation_epoch_avg", 1e-3),
    ("Loss_Components_Val/total_loss", 1e-3),
    ("Metrics/PA_MPJPE_validation_epoch_avg", 1e-3),
])
def test_loop_scalars_match_jax(loop_runs, tag, rtol):
    """Values of the learning rate (the schedule at each flush's step), the
    training loss and the validation averages against the JAX loop on the
    same batches and weights (fp32, dropout off)."""
    jw, pw = loop_runs["jax"][0], loop_runs["port"][0]
    np.testing.assert_allclose([v for _, v in pw.scalars[tag]],
                               [v for _, v in jw.scalars[tag]], rtol=rtol,
                               err_msg=tag)


def test_keyboard_interrupt_saves_and_returns_like_jax(jax_tiny, tmp_path):
    """Ctrl-C while the loader is read: both loops end training, write
    what they reached and return ``(state, step)``. The interrupt comes in
    place of the sixth batch, in the third superbatch: both loops read one
    superbatch ahead of their step (the device prefetch hands a superbatch
    out once the next one is read), so both meet the interrupt before
    step 2 and stop after step 1."""
    batches, _ = _superbatch(8, 4, 2)
    kw = dict(num_steps=10, max_epochs=5, eval_interval_steps=100)
    jw, jn = _jax_loop_run(jax_tiny, tmp_path,
                           _LoopingLoader(batches, interrupt_at=5), None, **kw)
    pw, pn, st, pth = _port_loop_run(
        jax_tiny, tmp_path, _LoopingLoader(batches, interrupt_at=5), None,
        **kw)
    assert pn == jn == 1 and st.step == 1
    assert [s for s, _ in pw.scalars["Loss/train_step"]] \
        == [s for s, _ in jw.scalars["Loss/train_step"]] == [1]
    loaded, _ = load_pose_model(pth, "cpu", dtype=torch.float32)
    for (name, p), q in zip(st.model.named_parameters(),
                            loaded.parameters()):
        assert torch.equal(p.detach(), q), name


@pytest.mark.parametrize("compat", [False, True])
def test_compat_pa_metric_reaches_the_validation(jax_tiny, tmp_path, compat):
    """``train_model(compat_pa_metric=...)`` validates with that Procrustes
    convention: with a learning rate of 0 the weights stay the JAX
    model's, and the validation's PA-MPJPE is the JAX ``evaluate``'s under
    the same flag (and differs between the flags)."""
    _, jmodel, variables = jax_tiny
    batches, _ = _superbatch(9, 2, 2)
    st = tstate.create_train_state(_port_model(variables), learning_rate=0.0)
    w = _Recorder()
    loop.train_model(st, batches, batches, writer=w,
                     gradient_accumulation_steps=2, num_steps=1,
                     eval_interval_steps=1, compat_pa_metric=compat,
                     generator=torch.Generator().manual_seed(0))
    want = {c: jloop.evaluate(
        jstep.make_eval_step(jmodel, per_sample=True, compat_pa=c),
        jstate.create_train_state(jmodel, variables), batches, pad_to=2)
        for c in (False, True)}
    got = w.scalars["Metrics/PA_MPJPE_validation_epoch_avg"][0][1]
    np.testing.assert_allclose(got, want[compat]["pa_mpjpe"], rtol=1e-4)
    assert abs(want[True]["pa_mpjpe"] - want[False]["pa_mpjpe"]) \
        > 1e-3 * want[False]["pa_mpjpe"]
    assert abs(got - want[not compat]["pa_mpjpe"]) \
        > 1e-3 * want[False]["pa_mpjpe"]

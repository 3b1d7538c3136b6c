"""Sharded training states of pose3d_tpu_torch on gloo ranks (spawned
processes without JAX) against the JAX package's steps of the same
strategy on the conftest's virtual CPU devices and against the port's
one-process step, from the same weights and superbatch, at dropout 0:
FSDP on a 2-rank ``data`` mesh (each parameter and AdamW moment held as
the spec's shard), TP and TP+SP on a ``(1, 2)`` ``(data, model)`` mesh,
and PP with 2 stages and 2 microbatches on ``(1, 2)`` ``(data, stage)``,
on the tiny transformer; and the CNN's grouped step with FSDP on a 2 × 2
hybrid ``(replica, data)`` mesh of four ranks against one process.
Bounds: loss components rtol 1e-5; applied gradients
``GRAD_TOL``·max(1, |ref|); parameters and EMA parameters by
``assert_params_close``; the ranks' parameters bitwise equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist_worker as W
from torch_port_dist import run_ranks
from torch_port_helpers import TINY_KW, assert_params_close, inputs

from pose3d_tpu import parallel as jpar
from pose3d_tpu.core import mesh as jmesh
from pose3d_tpu.core.config import TransformerModelConfig as JTR
from pose3d_tpu.models import init_model
from pose3d_tpu.models.factory import build_model as jbuild
from pose3d_tpu.parallel.sp import make_sp_constraint
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import step as jstep

from pose3d_tpu_torch import parallel as tpar
from pose3d_tpu_torch.compat import state_dict_from_jax
from pose3d_tpu_torch.core.config import TransformerModelConfig
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.train import loop as tloop

KW = dict(TINY_KW, transformer_dropout_rate=0.0, regression_dropout=0.0)
LR = 1e-3
GRAD_TOL = 3e-4
MESH = {"fsdp": ((2,), ("data",)), "tp": ((1, 2), ("data", "model")),
        "sp": ((1, 2), ("data", "model")), "pp": ((1, 2), ("data", "stage"))}


def _grad_atol(ref) -> float:
    return GRAD_TOL * max(1.0, float(np.abs(ref).max(initial=0)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def superbatch(seed, A, B, hw=64):
    rng = np.random.default_rng(seed)
    batches = []
    for a in range(A):
        img, depth, kpt = inputs(seed * 10 + a, B, hw=hw)
        batches.append({
            "image": img, "depth": depth, "keypoints_2d": kpt,
            "joints_3d": rng.normal(scale=0.5, size=(B, 17, 3)).astype(
                np.float32)})
    return next(tloop._superbatches(batches, A))


@pytest.fixture(scope="module")
def weights():
    cfg = JTR(**KW)
    _, variables = init_model(cfg, rng=jax.random.PRNGKey(3),
                              dtype=jnp.float32, attention_backend="xla")
    return _np(variables)


def _jax_step(strategy, variables, sb):
    cfg = JTR(**KW)
    shape, axes = MESH[strategy]
    n = int(np.prod(shape))
    mesh = jmesh.make_mesh(shape, axes, devices=jax.devices()[:n])
    kw, params = {}, variables["params"]
    if strategy == "sp":
        kw = dict(sp_constraint=make_sp_constraint(mesh))
    if strategy == "pp":
        kw = dict(vit_stacked=True, vit_block_runner=jpar.make_pipeline_runner(
            mesh, num_microbatches=2))
        params = dict(params, vit_backbone=jpar.stack_vit_blocks(
            params["vit_backbone"]))
    model = jbuild(cfg, dtype=jnp.float32, attention_backend="xla", **kw)
    st = jstate.create_train_state(model, {"params": params},
                                   learning_rate=LR, ema=True)
    shard = {"fsdp": jpar.shard_state_for_fsdp, "tp": jpar.shard_state_for_tp,
             "sp": jpar.shard_state_for_tp, "pp": jpar.shard_state_for_pp}
    st = shard[strategy](st, mesh)
    new, m = jstep.make_train_step(model, mesh=mesh, donate=False,
                                   state_sharding="auto", state_like=st,
                                   ema_decay=0.999)(
        st, {k: jnp.asarray(v) for k, v in sb.items()},
        jax.random.PRNGKey(0))
    tcfg = TransformerModelConfig(**KW)
    return dict(
        new=state_dict_from_jax({"params": _np(new.params)}, tcfg),
        ema=state_dict_from_jax({"params": _np(new.ema_params)}, tcfg),
        metrics={k: float(v) for k, v in m.items()})


@pytest.mark.parametrize("strategy", ["fsdp", "tp", "sp", "pp"])
def test_sharded_transformer_step_matches_jax_and_one_process(
        strategy, weights, tmp_path):
    A, B = (1, 4) if strategy == "pp" else (2, 4)
    sb = superbatch(7, A, B)
    shape, axes = MESH[strategy]
    job = dict(scenario="step", model_type="transformer", cfg=KW,
               state_dict=state_dict_from_jax(weights, TransformerModelConfig(
                   **KW)), superbatch=sb, lr=LR, strategy=strategy,
               mesh_shape=shape, mesh_axes=axes, microbatches=2)
    one = W.run_step(dict(job, strategy="dp"))
    ref = _jax_step(strategy, weights, sb)
    ranks = run_ranks(tmp_path, 2, **job)
    grads = one["grads"]
    for r in ranks:
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)
            np.testing.assert_allclose(r["metrics"][k], one["metrics"][k],
                                       rtol=1e-5, err_msg=k)
        for name, g in grads.items():
            np.testing.assert_allclose(
                r["grads"][name].numpy(), g.numpy(), rtol=0,
                atol=_grad_atol(g.numpy()), err_msg=name)
        params = {k: r["params"][k] for k in grads}
        assert_params_close(params, ref["new"], grads, LR, _grad_atol)
        assert_params_close(params, one["params"], grads, LR, _grad_atol)
        assert_params_close(r["ema"], ref["ema"], grads, LR, _grad_atol)
    # the whole parameters stay bitwise equal across the ranks
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k
    # each rank holds its shards, moments alike
    model = build_model(TransformerModelConfig(**KW), device="cpu")
    spec = {"fsdp": lambda: tpar.fsdp_param_spec(model, 2),
            "tp": lambda: tpar.tp_param_spec(model),
            "sp": lambda: tpar.tp_param_spec(model),
            "pp": lambda: tpar.pp_param_spec(model, 2)}[strategy]()
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    n_sharded = 0
    for rank, r in enumerate(ranks):
        for name, (p, m1, m2) in r["local"].items():
            s = spec[name]
            if s.stage is not None:
                want = full[name] if s.stage == rank else (0,)
            elif s.sharded:
                view = list(s.view)
                d = next(i for i, a in enumerate(s.dims) if a)
                view[d] //= 2
                want = tuple(view)
            else:
                want = full[name]
            assert p == m1 == m2 == want, (name, p, m1, m2, want)
            n_sharded += s.sharded
    assert n_sharded > 4


def test_hybrid_fsdp_cnn_step_on_four_ranks(tmp_path):
    """2 × 2 ``(replica, data)``: the BatchNorm statistics over all four
    ranks, FSDP shards over ``data``, their gradients added across the
    replicas."""
    from test_torch_port_distributed import TINY_CNN, superbatch as cnn_sb

    from pose3d_tpu_torch.core.config import CNNModelConfig

    model = build_model(CNNModelConfig(**TINY_CNN), device="cpu",
                        dtype=torch.float32,
                        generator=torch.Generator().manual_seed(4))
    job = dict(scenario="step", model_type="cnn", cfg=TINY_CNN,
               state_dict=model.state_dict(), superbatch=cnn_sb(8), lr=LR,
               strategy="fsdp", mesh_shape="hybrid")
    one = W.run_step(dict(job, strategy="dp"))
    res = run_ranks(tmp_path, 4, **job)
    for r in res:
        np.testing.assert_allclose(r["metrics"]["total_loss"],
                                   one["metrics"]["total_loss"], rtol=1e-5)
        for name, g in one["grads"].items():
            np.testing.assert_allclose(
                r["grads"][name].numpy(), g.numpy(), rtol=0,
                atol=_grad_atol(g.numpy()), err_msg=name)
        assert_params_close({k: r["params"][k] for k in one["grads"]},
                            one["params"], one["grads"], LR, _grad_atol)
    assert any(r["local"] for r in res)


@pytest.mark.parametrize("strategy", ["fsdp", "tp", "pp"])
def test_clip_by_global_norm_of_a_sharded_state(strategy, weights,
                                                tmp_path):
    """Clipping by the global norm (0.05: every gradient is scaled down)
    reads the reduced gradient, the shards' squared norms summed over the
    ranks and the whole tensors' counted once: the sharded step equals the
    one-process step with the same clip."""
    sb = superbatch(8, 1, 4)
    shape, axes = MESH[strategy]
    job = dict(scenario="step", model_type="transformer", cfg=KW,
               state_dict=state_dict_from_jax(weights, TransformerModelConfig(
                   **KW)), superbatch=sb, lr=LR, strategy=strategy,
               mesh_shape=shape, mesh_axes=axes, microbatches=2, clip=0.05)
    one = W.run_step(dict(job, strategy="dp"))
    raw = W.run_step(dict(job, strategy="dp", clip=None))

    def norm(grads):
        return float(torch.sqrt(sum(g.double().square().sum()
                                    for g in grads.values())))

    # the clip bites, and the gradients compared are the clipped ones
    assert norm(raw["grads"]) > 0.5
    assert norm(one["grads"]) == pytest.approx(0.05, rel=1e-5)
    for r in run_ranks(tmp_path, 2, **job):
        for name, g in one["grads"].items():
            np.testing.assert_allclose(
                r["grads"][name].numpy(), g.numpy(), rtol=0,
                atol=_grad_atol(g.numpy()), err_msg=name)
        assert_params_close({k: r["params"][k] for k in one["grads"]},
                            one["params"], one["grads"], LR, _grad_atol)

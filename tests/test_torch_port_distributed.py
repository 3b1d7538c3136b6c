"""Data-parallel CNN steps of pose3d_tpu_torch on two gloo ranks (spawned
processes without JAX, ``torch_port_dist.run_ranks``) against the JAX
package's mesh step on two of the conftest's virtual CPU devices and
against the port's one-process step, from the same weights and
superbatch: the grouped step (``normalization="batch"``; the scan step
with ``"batch_pallas"`` runs the same tests in
``test_torch_port_distributed_scan.py``). Bounds, as ``test_torch_port_cnn.py``'s: loss components
rtol 1e-5; the applied gradients ``GRAD_TOL``·max(1, |ref|) per tensor
against the one-process step's; parameters and EMA parameters by
``assert_params_close``; ``batch_stats`` and ``ema_batch_stats``
1e-5·max(1, |ref|). The BatchNorm backward's all-reduce is needed: a
copy that leaves it out moves the gradients past ``GRAD_TOL``. Ranks draw
different dropout masks; an augmented data-parallel step applies the rows
of one process's draw and equals the one-process step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist_worker as W
from torch_port_dist import run_ranks
from torch_port_helpers import assert_params_close, inputs

from pose3d_tpu.core import mesh as jmesh
from pose3d_tpu.core.config import CNNModelConfig as JCNN
from pose3d_tpu.models import init_model
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import step as jstep

from pose3d_tpu_torch.compat import state_dict_from_jax
from pose3d_tpu_torch.core.config import CNNModelConfig
from pose3d_tpu_torch.ops.augment_device import (
    DeviceAugmentConfig,
    draw_params,
)
from pose3d_tpu_torch.train import loop as tloop

TINY_CNN = dict(
    image_size=(50, 50), heatmap_size=50, initial_channels=8,
    stage_channels=(16, 32, 64), stage_depths=(1, 3, 3),
    global_pool_size=2, global_feature_dim=32, regression_dims=(32, 16),
    regression_dropout=0.0,
)
LR = 1e-3
GRAD_TOL = 3e-4
A, B = 2, 8              # each rank: 4 samples of each microbatch


def _grad_atol(ref) -> float:
    return GRAD_TOL * max(1.0, float(np.abs(ref).max(initial=0)))


def superbatch(seed, hw=50):
    rng = np.random.default_rng(seed)
    batches = []
    for a in range(A):
        img, depth, kpt = inputs(seed * 10 + a, B, hw=hw)
        batches.append({
            "image": img, "depth": depth, "keypoints_2d": kpt,
            "joints_3d": rng.normal(scale=0.5, size=(B, 17, 3)).astype(
                np.float32)})
    return next(tloop._superbatches(batches, A))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_case(norm, tmp_path_factory):
    """The JAX mesh step, the port's one-process step and the two ranks'
    step for ``norm`` (grouped for "batch", scan for "batch_pallas")."""
    mode = "grouped" if norm == "batch" else "scan"
    jcfg = JCNN(**TINY_CNN, normalization=norm)
    jmodel, variables = init_model(jcfg, rng=jax.random.PRNGKey(1),
                                   dtype=jnp.float32)
    sb = superbatch(4)
    mesh = jmesh.make_mesh((2,), ("data",), devices=jax.devices()[:2])
    st = jstate.create_train_state(jmodel, variables, learning_rate=LR,
                                   ema=True)
    new, m = jstep.make_train_step(jmodel, mesh=mesh, accum_mode=mode,
                                   donate=False, ema_decay=0.999)(
        st, {k: jnp.asarray(v) for k, v in sb.items()},
        jax.random.PRNGKey(0))
    tcfg = CNNModelConfig(**TINY_CNN, normalization=norm)
    bs = _np(new.batch_stats)
    jax_ref = dict(
        new=state_dict_from_jax({"params": _np(new.params),
                                 "batch_stats": bs}, tcfg),
        ema=state_dict_from_jax({"params": _np(new.ema_params),
                                 "batch_stats": _np(new.ema_batch_stats)},
                                tcfg),
        metrics={k: float(v) for k, v in m.items()})
    job = dict(scenario="step", model_type="cnn",
               cfg=dict(TINY_CNN, normalization=norm),
               state_dict=state_dict_from_jax(_np(variables), tcfg),
               superbatch=sb, accum_mode=mode, lr=LR)
    tmp = tmp_path_factory.mktemp(f"dp_{norm}")
    return dict(norm=norm, job=job, jax=jax_ref, one=W.run_step(job),
                ranks=run_ranks(tmp, 2, **job), tmp=tmp)


@pytest.fixture(scope="module", params=["batch"])
def case(request, tmp_path_factory):
    return make_case(request.param, tmp_path_factory)


def _stats(sd):
    return {k: v for k, v in sd.items()
            if k.endswith((".running_mean", ".running_var"))}


def _assert_stats_close(got, want, tol=1e-5):
    assert got and set(got) <= set(want)
    for name, buf in got.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(
            buf.numpy(), ref, rtol=0,
            atol=tol * max(1.0, float(np.abs(ref).max())), err_msg=name)


def test_data_parallel_cnn_step_matches_jax_mesh_and_one_process(case):
    one, ref = case["one"], case["jax"]
    grads = one["grads"]
    for r in case["ranks"]:
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
        _assert_stats_close(_stats(r["params"]), ref["new"])
        _assert_stats_close(r["ema_stats"], ref["ema"])
    # the ranks agree: the statistics come from the global sums
    a, b = case["ranks"]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


def test_batchnorm_backward_all_reduce_is_needed(case):
    """A copy whose BatchNorm backward keeps each rank's own Σdy and
    Σdy·x (forward sums still all-reduced) gives the same loss but
    gradients past ``GRAD_TOL`` of the one-process step's."""
    res = run_ranks(case["tmp"], 2, **dict(case["job"],
                                           drop_bn_backward_sync=True))
    grads = case["one"]["grads"]
    np.testing.assert_allclose(res[0]["metrics"]["total_loss"],
                               case["one"]["metrics"]["total_loss"],
                               rtol=1e-5)
    worst = max(float((res[0]["grads"][k] - g).abs().max())
                / _grad_atol(g.numpy()) for k, g in grads.items())
    assert worst > 10


def test_ranks_draw_different_masks_and_one_process_augment_rows(tmp_path):
    sb = superbatch(5)
    cfg = dict(enable_rotation=True)
    res = run_ranks(tmp_path, 2, scenario="draws", superbatch=sb,
                    augment=cfg)
    assert not torch.equal(res[0]["mask"], res[1]["mask"])
    want = draw_params(DeviceAugmentConfig(**cfg), A * B,
                       torch.Generator().manual_seed(7), "cpu")
    half = B // 2
    for r, got in enumerate(res):
        rows = (torch.arange(A)[:, None] * B + r * half
                + torch.arange(half)).reshape(-1)
        assert set(got["params"]) == set(want)
        for k, v in want.items():
            assert torch.equal(got["params"][k], v[rows]), k


def test_augmented_data_parallel_step_equals_one_process(tmp_path):
    """Grouped CNN with device augmentation, rotation on (the plain
    ``lane_resample`` on the CPU): two ranks against one process."""
    tcfg = CNNModelConfig(**TINY_CNN)
    from pose3d_tpu_torch.models import build_model

    model = build_model(tcfg, device="cpu", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(2))
    job = dict(scenario="step", model_type="cnn", cfg=TINY_CNN,
               state_dict=model.state_dict(), superbatch=superbatch(6),
               lr=LR, augment=dict(enable_rotation=True))
    one = W.run_step(job)
    for r in run_ranks(tmp_path, 2, **job):
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-5)
        for name, g in one["grads"].items():
            np.testing.assert_allclose(
                r["grads"][name].numpy(), g.numpy(), rtol=0,
                atol=_grad_atol(g.numpy()), err_msg=name)
        assert_params_close({k: r["params"][k] for k in one["grads"]},
                            one["params"], one["grads"], LR, _grad_atol)

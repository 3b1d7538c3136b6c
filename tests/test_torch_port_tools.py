"""The port's overfit demo and int8 accuracy scripts against the JAX
package: ``make_task_batch`` bitwise the JAX script's, five overfit steps
of a tiny CNN and a tiny transformer from weights bridged out of JAX
(losses and MPJPE against ``pose3d_tpu.train``'s steps on the same
superbatches), and the quantize script's fp32 and int8 MPJPE on a tiny
bridged checkpoint against JAX's ``serve.export_lifter`` (int8 through
``quantize_variables``)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose3d_tpu import serve as jserve
from pose3d_tpu.core import config as jcfg
from pose3d_tpu.models import init_model
from pose3d_tpu.train import state as jstate
from pose3d_tpu.train import step as jstep

from pose3d_tpu_torch.compat import state_dict_from_jax
from pose3d_tpu_torch.core.config import CNNModelConfig, TransformerModelConfig
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.train.checkpoint import save_checkpoint
from pose3d_tpu_torch.train.state import create_train_state

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _script(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


overfit = _script("torch_overfit_demo")
quantize = _script("torch_quantize_accuracy")

# the lifecycle's tiny configs, dropout 0 (the two frameworks draw other
# masks), at 32 px
TINY = {
    "cnn": (jcfg.CNNModelConfig, CNNModelConfig, dict(
        image_size=(32, 32), heatmap_size=32, heatmap_sigma=2.0,
        stage_channels=(8, 16, 32), stage_depths=(1, 1, 1),
        initial_channels=8, global_pool_size=2, global_feature_dim=16,
        regression_dims=(16,), regression_dropout=0.0)),
    "transformer": (jcfg.TransformerModelConfig, TransformerModelConfig, dict(
        image_size=(32, 32), heatmap_size=32, heatmap_patch_size=16,
        heatmap_sigma=2.0, transformer_embed_dim=32, transformer_heads=2,
        vit_depth=1, vit_heads=2, final_encoder_depth=1,
        num_cross_modal_layers=1, regression_hidden_dims=(16,),
        transformer_dropout_rate=0.0,
        transformer_attention_dropout_rate=0.0, regression_dropout=0.0)),
}
STEPS = 5
# superbatches of A x B: groups of 4 samples a BatchNorm (2 is
# ill-conditioned in fp32, in JAX too)
A, B = 2, 4
LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(name, seed=5):
    """(JAX config, module, numpy variables, the port's fp32 train model on
    the bridged weights)."""
    jc, pc, kw = TINY[name]
    jmodel, variables = init_model(
        jc(**kw), rng=jax.random.PRNGKey(seed), dtype=jnp.float32,
        **({"attention_backend": "xla"} if name == "transformer" else {}))
    variables = _np(variables)
    cfg = pc(**kw)
    model = build_model(cfg, device="cpu", dtype=torch.float32, train=True,
                        attention_impl="reference")
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return jmodel, variables, model, cfg


@pytest.mark.parametrize("a,b,size", [(10, 10, 16), (1, 8, 24), (1, 3, 5)])
def test_make_task_batch_is_the_jax_scripts(a, b, size):
    """The same arrays, bit for bit, from the same generator state — and
    ``task_data`` draws the superbatches and the held-out batch in the JAX
    script's order."""
    jax_demo = _script("overfit_demo")
    for seed in (0, 3):
        got = overfit.make_task_batch(np.random.default_rng(seed), a, b, size)
        want = jax_demo.make_task_batch(np.random.default_rng(seed), a, b,
                                        size)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    train, held = overfit.task_data(0, 3, a, b, size)
    rng = np.random.default_rng(0)
    for sb in train:
        want = jax_demo.make_task_batch(rng, a, b, size)
        for k in want:
            np.testing.assert_array_equal(sb[k], want[k])
    want = jax_demo.make_task_batch(rng, 1, b, size)
    for k in want:
        np.testing.assert_array_equal(held[k], want[k][0])


def _jax_curve(jmodel, variables, train, held, steps):
    """The JAX script's loop: a step, then the loss and the MPJPE of the
    held-out batch and of the first superbatch's first microbatch."""
    st = jstate.create_train_state(jmodel, variables, learning_rate=LR)
    step = jstep.make_train_step(jmodel, donate=False)
    evals = jstep.make_eval_step(jmodel)
    key = jax.random.PRNGKey(0)
    jtrain = [{k: jnp.asarray(v) for k, v in sb.items()} for sb in train]
    jheld = {k: jnp.asarray(v) for k, v in held.items()}
    train_eval = {k: v[0] for k, v in jtrain[0].items()}

    def mpjpe(s, batch):
        return float(evals(s, batch)[0]["mpjpe"])

    out = {"untrained": mpjpe(st, jheld), "curve": []}
    for i in range(1, steps + 1):
        st, m = step(st, jtrain[(i - 1) % len(jtrain)],
                     jax.random.fold_in(key, i))
        out["curve"].append({"loss": float(m["total_loss"]),
                             "held": mpjpe(st, jheld),
                             "train": mpjpe(st, train_eval)})
    return out


@pytest.mark.parametrize("name", sorted(TINY))
def test_overfit_steps_match_jax(name):
    """Five steps of the demo's loop (``train_curve``, evaluating after
    each) from bridged weights, against the JAX script's loop on the same
    superbatches: the untrained MPJPE, each step's loss and both MPJPEs
    to 1e-5 relative (fp32 in both, summation order: they sit within 3e-7
    here; AdamW's sign-like first steps could move an element whose
    gradient is near 0 apart, which this bound would show)."""
    jmodel, variables, model, cfg = _pair(name)
    train, held = overfit.task_data(0, 2, A, B, cfg.image_size[0])
    want = _jax_curve(jmodel, variables, train, held, STEPS)
    state = create_train_state(model, learning_rate=LR)
    got = overfit.train_curve(state, train, held, STEPS, eval_every=1)
    assert got["device"].type == "cpu" and len(got["curve"]) == STEPS
    np.testing.assert_allclose(got["untrained_mpjpe_mm"], want["untrained"],
                               rtol=1e-5)
    for i, (g, w) in enumerate(zip(got["curve"], want["curve"]), 1):
        assert g["step"] == i
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5,
                                   err_msg=f"loss at step {i}")
        np.testing.assert_allclose(g["held_out_mpjpe_mm"], w["held"],
                                   rtol=1e-5, err_msg=f"held-out at step {i}")
        np.testing.assert_allclose(g["train_mpjpe_mm"], w["train"],
                                   rtol=1e-5, err_msg=f"train at step {i}")
    assert got["curve"][-1]["loss"] < got["curve"][0]["loss"]


def test_quantize_accuracy_matches_jax(tmp_path):
    """The script's fp32 and int8 MPJPE on a checkpoint of bridged weights
    and its held-out batch, against the JAX package's ``export_lifter`` of
    the same variables (int8: ``quantize_variables``, whose q and scale the
    port's equal bitwise) on the same batch: 1e-4 relative (fp32 forwards,
    summation order); int8 − fp32 as the difference of the two."""
    jmodel, variables, model, cfg = _pair("cnn", seed=9)
    _, held = overfit.task_data(1, 1, A, B, cfg.image_size[0])
    want = {}
    for quant in (None, "int8"):
        exp = jserve.export_lifter(jmodel, variables, cfg.image_size,
                                   batch_size=B, quantize=quant)
        pred = np.asarray(exp.call(held["image"], held["depth"],
                                   held["keypoints_2d"]), np.float64)
        want[quant or "f32"] = float(np.linalg.norm(
            pred - held["joints_3d"], axis=-1).mean())
    ckpt = tmp_path / "ckpt"
    save_checkpoint(ckpt, create_train_state(model), "cnn", cfg.to_dict())
    np.savez(ckpt / "held_out.npz", **held)
    rep = quantize.accuracy(ckpt, torch.device("cpu"), torch.float32,
                            "xla", tmp_path / "art")
    assert "mpjpe_mm_ema_f32" not in rep       # no EMA in this checkpoint
    for k in ("f32", "int8"):
        np.testing.assert_allclose(rep[f"mpjpe_mm_{k}"], want[k], rtol=1e-4,
                                   err_msg=k)
        assert (tmp_path / "art" / k / "model.pt2").is_file()
    assert rep["artifact_mb_int8"] < rep["artifact_mb_f32"]
    np.testing.assert_allclose(rep["delta_mm_int8"],
                               rep["mpjpe_mm_int8"] - rep["mpjpe_mm_f32"])
    np.testing.assert_allclose(rep["delta_mm_int8"],
                               want["int8"] - want["f32"],
                               atol=1e-4 * want["f32"])

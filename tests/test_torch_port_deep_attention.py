"""pose3d_tpu_torch flash attention past head depth 256, the deep instance
of the kernels: the launchers zero-pad D and Dv to multiples of 64 at the
scale of the true D, and the kernels sum the scores over the depth in
64-column chunks and split the output columns into slices of 128. Here the
plain pair stands in for the kernels (``run_padded_fwd`` /
``run_padded_bwd``), held to the unpadded plain pair and to the Pallas
``_fwd_impl`` / ``_bwd_impl`` in interpret mode; then the deep plan in
``launch_config`` at every depth up to 4,096, the lifter at ``transformer_heads=1`` against
the JAX model, and the CLI training it."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import FIXTURE_DIR, TINY_KW, inputs, jax_model

from pose3d_tpu.ops import losses as jlosses
from pose3d_tpu.ops.pallas.flash_attention import _bwd_impl, _fwd_impl
from pose3d_tpu.train import step as jstep

from pose3d_tpu_torch.compat import state_dict_from_jax
from pose3d_tpu_torch.core.config import TransformerModelConfig
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.ops import losses
from pose3d_tpu_torch.ops.kernels import flash_attention as fa
from pose3d_tpu_torch.train import loop, step as tstep

# (B, Tq, Tk, H, D, Dv) past 256 at ragged Tq != Tk: D = Dv just past the
# widest built pair, at a whole number of chunks, transformer_heads 2 and
# 1 at embed 768 (384, 768), a value depth twice the key depth, and one
# depth past 256 beside a narrow other (each side padded on its own)
DEEP_SHAPES = [
    (1, 9, 13, 2, 257, 257),
    (1, 7, 5, 1, 320, 320),
    (2, 6, 9, 1, 384, 384),
    (1, 5, 7, 1, 768, 768),
    (1, 8, 6, 2, 384, 768),
    (2, 7, 4, 2, 300, 40),
    (1, 4, 9, 2, 40, 300),
]


def _arrays(shape, seed):
    B, Tq, Tk, H, D, Dv = shape
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Tq, H, D), (B, Tk, H, D), (B, Tk, H, Dv),
                      (B, Tq, H, Dv))]


def _ids(shape):
    return f"D{shape[4]}-Dv{shape[5]}"


@pytest.mark.parametrize("shape", DEEP_SHAPES, ids=_ids)
def test_deep_forward_matches_plain_and_pallas(shape):
    """o [B, Tq, H, Dv] and lse through the deep route, fp32: against the
    plain forward at the true depths to 1e-6 (zero columns add exact
    zeros) and against the Pallas ``_fwd_impl`` (interpret mode) to
    1e-5·max(1, |ref|) (summation order only)."""
    q, k, v, _ = _arrays(shape, sum(shape))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert fa.is_deep(*fa.padded_pair(shape[4], shape[5]))
    o, lse = fa.run_padded_fwd(fa.flash_attention_fwd_reference, tq, tk, tv)
    ro, rlse = fa.flash_attention_fwd_reference(tq, tk, tv)
    jo, jlse = _fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    B, Tq, _, H, _, Dv = shape
    assert o.shape == (B, Tq, H, Dv)
    assert lse.shape == (B, H, Tq)
    np.testing.assert_allclose(o.numpy(), ro.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), rtol=0, atol=1e-6)
    jo, jlse = np.asarray(jo), np.asarray(jlse)[..., :Tq]
    np.testing.assert_allclose(o.numpy(), jo, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(jo).max())))
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(jlse).max())))


@pytest.mark.parametrize("shape", DEEP_SHAPES, ids=_ids)
def test_deep_backward_matches_plain_and_pallas(shape):
    """dq, dk [.., D] and dv [.., Dv] through the deep route on the Pallas
    forward's o and lse, fp32: against the plain backward at the true
    depths to 1e-6·max(1, |ref|) and against the Pallas ``_bwd_impl``
    (interpret mode) to 1e-5·max(1, |ref|)."""
    q, k, v, g = _arrays(shape, 3 * sum(shape))
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    jo, jlse = _fwd_impl(jq, jk, jv, True)
    want = _bwd_impl(jq, jk, jv, jo, jg, jlse, True)
    Tq = shape[1]
    args = tuple(map(torch.from_numpy, (q, k, v, np.array(jo), g,
                                        np.array(jlse)[..., :Tq])))
    got = fa.run_padded_bwd(fa.flash_attention_bwd_reference, *args)
    plain = fa.flash_attention_bwd_reference(*args)
    for name, a, p, b in zip(("dq", "dk", "dv"), got, plain, want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=0,
                                   atol=1e-6 * scale, err_msg=name)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("D,Dv", [(300, 40), (40, 300), (257, 257)])
def test_deep_route_pads_to_chunks_at_the_true_depths_scale(D, Dv):
    """What the launch sees: q and k padded to D's multiple of 64, v to
    Dv's, the scale 1/√D of the true D; what comes back is sliced to the
    true depths."""
    q, k, v, g = map(torch.from_numpy, _arrays((1, 5, 4, 1, D, Dv), 7))
    seen = []

    def launch(q, k, v, scale):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], scale))
        return fa.flash_attention_fwd_reference(q, k, v, scale)
    o, lse = fa.run_padded_fwd(launch, q, k, v)
    Dp, Dvp = 64 * -(-D // 64), 64 * -(-Dv // 64)
    assert seen == [(Dp, Dp, Dvp, 1.0 / D ** 0.5)]
    assert o.shape[-1] == Dv

    def launch_bwd(q, k, v, o, do, lse, scale):
        seen.append((q.shape[-1], v.shape[-1], o.shape[-1], do.shape[-1],
                     scale))
        return fa.flash_attention_bwd_reference(q, k, v, o, do, lse, scale)
    grads = fa.run_padded_bwd(launch_bwd, q, k, v, o, g, lse)
    assert seen[1] == (Dp, Dvp, Dvp, Dvp, 1.0 / D ** 0.5)
    assert [t.shape[-1] for t in grads] == [D, D, Dv]


@pytest.mark.parametrize("D,Dv", [(320, 320), (384, 768), (64, 320),
                                  (320, 64)])
def test_chunks_and_slices_cover_the_depths(D, Dv):
    """The deep plan's chunks cover D, its slices cover Dv (forward) and
    max(D, Dv) (backward) with the last one 64 or 128 wide."""
    sf, sb = fa.slices(D, Dv)
    assert sf == -(-Dv // 128) and sb == -(-max(D, Dv) // 128)
    for n, width in ((sf, Dv), (sb, max(D, Dv))):
        assert width - (n - 1) * fa.DEEP_SLICE in (64, 128)
    cfg = fa.launch_config(2, 9, 7, 3, D, Dv, 4)
    assert cfg["chunk"] == fa.DEEP_CHUNK and D % cfg["chunk"] == 0
    assert (cfg["fwd"]["slices"], cfg["bwd"]["slices"]) == (sf, sb)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_launch_config_of_the_deep_instance_fits_at_every_depth(itemsize):
    """Every pair of multiples of 64 past 256 up to 4,096 takes the deep
    instance of the ``wmma`` (bf16) or ``scalar`` (fp32) path: 64 query
    rows a forward block, 64 (bf16) or 32 (fp32) keys a backward block,
    128 threads, a grid of H × slices on y, and shared memory that does
    not grow with the depth, within a block's 232,448 bytes."""
    B, Tq, Tk, H = 2, 1025, 1025, 3
    smem = set()
    for D in range(64, 4097, 64):
        for Dv in (64, 320, D, 4096):
            if max(D, Dv) <= 256:
                continue
            cfg = fa.launch_config(B, Tq, Tk, H, D, Dv, itemsize)
            assert cfg["path"] == ("wmma" if itemsize == 2 else "scalar")
            sf, sb = fa.slices(D, Dv)
            keys = 64 if itemsize == 2 else 32
            assert cfg["fwd"]["grid"] == (-(-Tq // 64), H * sf, B)
            assert cfg["bwd"]["grid"] == (-(-Tk // keys), H * sb, B)
            assert cfg["fwd"]["threads"] == cfg["bwd"]["threads"] == 128
            assert cfg["scratch_floats"] == B * H * Tq
            smem.add((cfg["fwd"]["smem"], cfg["bwd"]["smem"]))
    assert smem == ({(96256, 140800)} if itemsize == 2
                    else {(85248, 128000)})
    assert max(max(p) for p in smem) <= fa.MAX_SMEM


# --- the lifter at transformer_heads=1 against the JAX model ----------------

# a small backbone at the embed width where one head is past 256: the ViT
# at 6 heads of 64, the fusion and final blocks at one head of 384
HEADS1_KW = dict(TINY_KW, transformer_embed_dim=384, transformer_heads=1,
                 vit_heads=6, transformer_dropout_rate=0.0,
                 regression_dropout=0.0)


@pytest.fixture(scope="module")
def heads1():
    cfg = TransformerModelConfig(**HEADS1_KW)
    _, jmodel, variables = jax_model(seed=4, **HEADS1_KW)
    return cfg, jmodel, variables


def test_heads1_forward_matches_jax(heads1):
    """The forward through the deep route's plain version against the JAX
    model with the Pallas kernel in interpret mode at head depth 384, fp32
    to 1e-4·max(1, |ref|) (the tolerance of the lifter's other forward
    parity tests)."""
    cfg, jmodel, variables = heads1
    args = inputs(5, 2)
    fn = jax.jit(lambda v, i, d, k: jmodel.apply(v, i, d, k, train=False))
    want = np.asarray(fn(variables, *args), np.float32)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, args)).numpy()
    assert got.shape == (2, 17, 3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))


def test_heads1_grouped_step_gradients_match_jax(heads1):
    """One grouped step's loss and every parameter's gradient (A 2 × B 2,
    dropout 0, fp32) against ``jax.value_and_grad`` of the JAX step's loss,
    to 1e-5 relative on the loss and 1e-4·max(1, |ref|) per tensor."""
    cfg, jmodel, variables = heads1
    rng = np.random.default_rng(6)
    batches = []
    for a in range(2):
        img, depth, kpt = inputs(60 + a, 2)
        batches.append({"image": img, "depth": depth, "keypoints_2d": kpt,
                        "joints_3d": rng.normal(scale=0.5, size=(2, 17, 3))
                        .astype(np.float32)})
    sb = next(loop._superbatches(batches, 2))
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in sb.items()}
    grad_fn = jax.jit(lambda p, b: jax.value_and_grad(
        jstep._loss_fn, has_aux=True)(p, {}, jmodel.apply, b,
                                      jax.random.PRNGKey(0),
                                      jlosses.LossWeights()))
    (jloss, _), jgrads = grad_fn(variables["params"],
                                 {k: jnp.asarray(v) for k, v in flat.items()})
    want = state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)}, cfg)
    model = build_model(cfg, device="cpu", dtype=torch.float32, train=True)
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    loss, _ = tstep._forward_loss(model, loop.to_device(flat, "cpu"),
                                  losses.LossWeights(), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), ref, rtol=0,
            atol=1e-4 * max(1.0, float(np.abs(ref).max())), err_msg=name)


def test_cli_trains_transformer_heads_1_and_keeps_it(tmp_path, monkeypatch):
    """``cli.main --model-type transformer --model-args
    '{"transformer_heads": 1, ...}'`` takes one step on the committed
    fixture, the fusion and final blocks at head depth 320 (the deep
    route; its plain version on the CPU), and stores the heads in the
    checkpoint's ``model_args``."""
    from pose3d_tpu_torch.cli import main as port_main
    from pose3d_tpu_torch.core.config import GlobalConfig
    from pose3d_tpu_torch.train import checkpoint as ckpt

    tiny = dict(image_size=[32, 32], heatmap_size=32, heatmap_patch_size=16,
                transformer_embed_dim=320, transformer_heads=1, vit_depth=1,
                vit_heads=5, final_encoder_depth=1, num_cross_modal_layers=1,
                regression_hidden_dims=[16])
    monkeypatch.chdir(tmp_path)
    port_main.main(["--chunks-dir", str(FIXTURE_DIR), "--device",
                    "cpu", "--model-type", "transformer", "--model-args",
                    json.dumps(tiny), "--batch-size", "2", "--grad-accum",
                    "1", "--num-steps", "1", "--eval-interval", "100",
                    "--no-tensorboard"])
    prefix = GlobalConfig().checkpoint_prefix
    meta = ckpt.load_checkpoint_meta(tmp_path / f"{prefix}_transformer_step_1")
    assert meta["step"] == 1 and meta["model_type"] == "transformer"
    assert meta["model_args"]["transformer_heads"] == 1
    assert meta["model_args"]["transformer_embed_dim"] == 320

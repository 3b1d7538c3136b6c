"""pose3d_tpu_torch's two stand-alone row ops, ``layer_norm`` and
``fused_mlp``, against the JAX package's Pallas ops on the same numpy
inputs (interpret mode, as ``test_pallas_layernorm.py`` and
``test_pallas_mlp.py`` call them), against flax and plain PyTorch, the
weights bridge, and what the launchers refuse. Everything runs on the CPU,
where the port's ops take their kernels' plain versions."""

import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_port_helpers  # noqa: F401  (caps torch at one thread)

from pose3d_tpu.models.transformer import Mlp as JaxMlp
from pose3d_tpu.ops.pallas import layer_norm as jln
from pose3d_tpu.ops.pallas import mlp_block as jmb

from pose3d_tpu_torch.models.transformer import Mlp
from pose3d_tpu_torch.ops.kernels import _build
from pose3d_tpu_torch.ops.kernels import layer_norm as ln
from pose3d_tpu_torch.ops.kernels import mlp_block as mb


def _t(x, requires_grad=False):
    t = torch.from_numpy(np.array(x, copy=True))
    return t.requires_grad_() if requires_grad else t


def _assert_close(got, want, tol, what=""):
    """|Δ| <= tol·(1 + |want|), numpy's allclose with rtol = atol = tol."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


# --- layer_norm ---------------------------------------------------------------

def _ln_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    return (rng.normal(size=shape).astype(np.float32),
            (rng.normal(size=(C,)) * 0.1 + 1.0).astype(np.float32),
            (rng.normal(size=(C,)) * 0.1).astype(np.float32))


# fp32 against the Pallas kernel: the same arithmetic, sums in another
# order; 2e-5 is the bound of the JAX package's own test against flax
@pytest.mark.parametrize("shape", [(8, 100, 768), (3, 640), (513, 256),
                                   (37, 100)])
def test_layer_norm_forward_matches_jax(shape):
    x, s, b = _ln_inputs(shape)
    want, (mu, rstd, _) = jln._fwd_impl(jnp.asarray(x), jnp.asarray(s),
                                        jnp.asarray(b), 1e-6, True)
    got = ln.layer_norm(_t(x), _t(s), _t(b), 1e-6)
    assert got.shape == shape and got.dtype == torch.float32
    _assert_close(got, want, 2e-5)
    # the residuals: the port's are [rows] exactly, JAX's carry padded rows
    _, mean_t, rstd_t = ln.layer_norm_fwd_reference(_t(x), _t(s), _t(b), 1e-6)
    rows = int(np.prod(shape[:-1]))
    assert mean_t.shape == rstd_t.shape == (rows,)
    _assert_close(mean_t, np.asarray(mu)[:rows, 0], 2e-5, "mean")
    _assert_close(rstd_t, np.asarray(rstd)[:rows, 0], 2e-5, "rstd")


def test_layer_norm_grads_match_jax():
    shape = (4, 70, 256)
    x, s, b = _ln_inputs(shape, 1)
    w = np.random.default_rng(2).normal(size=shape).astype(np.float32)

    def loss(x, s, b):
        return (jln.layer_norm(x, s, b, 1e-6, True) * w).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, s, b)))
    leaves = [_t(v, True) for v in (x, s, b)]
    (ln.layer_norm(*leaves, 1e-6) * _t(w)).sum().backward()
    # 5e-5: the JAX test's bound for its gradients
    for leaf, g, name in zip(leaves, want, ("dx", "dscale", "dbias")):
        assert leaf.grad.dtype == torch.float32
        _assert_close(leaf.grad, g, 5e-5, name)


def test_layer_norm_bf16_input():
    x, s, b = _ln_inputs((130, 256), 3)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jln.layer_norm(xb, jnp.asarray(s), jnp.asarray(b),
                                     1e-6, True), np.float32)
    got = ln.layer_norm(_t(x).bfloat16(), _t(s), _t(b))
    assert got.dtype == torch.bfloat16
    # 2e-2: the output is rounded to bf16 (2^-8 relative at |y| up to ~4)
    _assert_close(got, want, 2e-2)
    # gradients of a bf16 input: dx bf16, dscale and dbias in scale's fp32
    leaves = [_t(x).bfloat16().requires_grad_(), _t(s, True), _t(b, True)]
    ln.layer_norm(*leaves).float().sum().backward()
    assert [v.grad.dtype for v in leaves] == [torch.bfloat16, torch.float32,
                                              torch.float32]


@pytest.mark.parametrize("shape", [(8, 100, 768), (37, 100)])
def test_layer_norm_matches_torch_layer_norm(shape):
    """Against ``F.layer_norm`` in fp32. The op takes the variance in one
    pass (E[x²] − E[x]²), PyTorch in two: for rows of mean 0.3 and spread
    1.5 the cancellation costs about (1 + μ²/σ²)·2^-24 of the variance, far
    inside 2e-5."""
    x, s, b = _ln_inputs(shape, 4)
    x = x * 1.5 + 0.3
    got = ln.layer_norm(_t(x), _t(s), _t(b), 1e-6)
    want = F.layer_norm(_t(x), shape[-1:], _t(s), _t(b), 1e-6)
    _assert_close(got, want.numpy(), 2e-5)


def test_layer_norm_function_backward_matches_autograd():
    """The Function's backward (the plain pair, fp32 by design, so
    ``gradcheck``'s fp64 does not apply) against autograd through an
    unfused composition in fp64: 5e-5, fp32 sums over 256 columns and 280
    rows."""
    x, s, b = _ln_inputs((4, 70, 256), 5)
    w = np.random.default_rng(6).normal(size=x.shape)
    leaves = [_t(v, True) for v in (x, s, b)]
    (ln.layer_norm(*leaves) * _t(w).float()).sum().backward()
    xd, sd, bd = (_t(v).double().requires_grad_() for v in (x, s, b))
    mu = xd.mean(-1, keepdim=True)
    var = ((xd - mu) ** 2).mean(-1, keepdim=True)
    (((xd - mu) / torch.sqrt(var + 1e-6) * sd + bd) * _t(w)).sum().backward()
    for leaf, ref in zip(leaves, (xd, sd, bd)):
        _assert_close(leaf.grad, ref.grad.numpy(), 5e-5)


# --- fused_mlp ----------------------------------------------------------------

def _mlp_inputs(N, D, H, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)
    return (n(N, D), n(D, H, s=0.05), n(H, s=0.05), n(H, D, s=0.05),
            n(D, s=0.05))


# fp32 against the Pallas kernel: the same arithmetic and polynomial, sums
# in another order; 2e-4 is the JAX test's bound against its reference
@pytest.mark.parametrize("N,D,H,lead", [(300, 128, 512, (300,)),
                                        (256, 256, 1024, (256,)),
                                        (260, 128, 512, (2, 130))])
def test_fused_mlp_forward_matches_jax(N, D, H, lead):
    x, *params = _mlp_inputs(N, D, H)
    x = x.reshape(*lead, D)
    want = jmb.fused_mlp(*map(jnp.asarray, (x, *params)), True)
    got = mb.fused_mlp(_t(x), *map(_t, params))
    assert got.shape == x.shape and got.dtype == torch.float32
    _assert_close(got, want, 2e-4)


def test_fused_mlp_grads_match_jax():
    args = _mlp_inputs(300, 128, 512, 1)
    w = np.random.default_rng(2).normal(size=(300, 128)).astype(np.float32)

    def loss(*a):
        return (jmb.fused_mlp(*a, True) * w).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    leaves = [_t(v, True) for v in args]
    (mb.fused_mlp(*leaves) * _t(w)).sum().backward()
    # 5e-4: the JAX test's bound for its gradients
    for leaf, g, name in zip(leaves, want,
                             ("dx", "dw1", "db1", "dw2", "db2")):
        assert leaf.grad.shape == leaf.shape
        _assert_close(leaf.grad, g, 5e-4, name)


def test_fused_mlp_bf16_forward():
    x, *params = _mlp_inputs(256, 128, 512, 3)
    want = np.asarray(jmb.fused_mlp(jnp.asarray(x, jnp.bfloat16),
                                    *map(jnp.asarray, params), True),
                      np.float32)
    got = mb.fused_mlp(_t(x).bfloat16(), *map(_t, params))
    assert got.dtype == torch.bfloat16
    # 3e-2: bf16 operands and a bf16 output; both sides round gelu(a) to
    # bf16 from fp32 values that differ in the last bits
    _assert_close(got, want, 3e-2)


def test_fused_mlp_grads_respect_param_dtypes():
    """Gradients come back in each parameter's own dtype: db1 fp32 and db2
    bf16 for a bf16 b2, as the JAX op's."""
    x, w1, b1, w2, b2 = _mlp_inputs(256, 128, 512, 4)
    leaves = [_t(x, True), _t(w1, True), _t(b1, True), _t(w2, True),
              _t(b2).bfloat16().requires_grad_()]
    mb.fused_mlp(*leaves).float().sum().backward()
    assert [v.grad.dtype for v in leaves] == [torch.float32] * 4 \
        + [torch.bfloat16]
    xb = _t(x).bfloat16().requires_grad_()
    mb.fused_mlp(xb, *(v.detach() for v in leaves[1:])).float().sum() \
        .backward()
    assert xb.grad.dtype == torch.bfloat16


def test_gelu_polynomial_against_exact_gelu():
    """The Abramowitz–Stegun erf (max error 1.5e-7) inside GELU against
    ``F.gelu`` (exact erf) in fp64: |Δ| <= 2e-7·max(1, |a|); the
    derivative against autograd's of the exact GELU likewise."""
    a = torch.linspace(-12.0, 12.0, 48001, dtype=torch.float64)
    bound = 2e-7 * a.abs().clamp_min(1.0)
    assert ((mb.gelu_as(a) - F.gelu(a)).abs() <= bound).all()
    leaf = a.clone().requires_grad_()
    F.gelu(leaf).sum().backward()
    assert ((mb.gelu_grad_as(a) - leaf.grad).abs() <= bound).all()
    # and in fp32, as the op runs it: fp32 rounding of a·Φ(a) besides
    a32 = a.float()
    assert ((mb.gelu_as(a32).double() - F.gelu(a)).abs()
            <= 2e-7 * a.abs().clamp_min(1.0) + 2e-7 * a.abs()).all()


def test_fused_mlp_function_backward_matches_autograd():
    """The Function's backward (the plain pair, fp32 by design) against
    autograd through the unfused composition with the exact GELU in fp64:
    5e-4, fp32 sums over up to 512 terms of magnitude ~1 plus the
    polynomial's 1.5e-7."""
    args = _mlp_inputs(64, 128, 512, 5)
    w = np.random.default_rng(6).normal(size=(64, 128))
    leaves = [_t(v, True) for v in args]
    (mb.fused_mlp(*leaves) * _t(w).float()).sum().backward()
    x, w1, b1, w2, b2 = (_t(v).double().requires_grad_() for v in args)
    ((F.gelu(x @ w1 + b1) @ w2 + b2) * _t(w)).sum().backward()
    for leaf, ref in zip(leaves, (x, w1, b1, w2, b2)):
        _assert_close(leaf.grad, ref.grad.numpy(), 5e-4)


# --- the slice: fused_mlp(layer_norm(x)) with bridged flax parameters ----------

def _flax_block(D=64, seed=0):
    norm = fnn.LayerNorm(epsilon=1e-6, dtype=jnp.float32)
    mlp = JaxMlp(hidden_ratio=4.0, dropout=0.0, dtype=jnp.float32)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    x0 = jnp.zeros((1, 4, D), jnp.float32)
    pn = norm.init(k1, x0)["params"]
    pm = mlp.init(k2, x0)["params"]
    # flax starts LayerNorm at scale 1, bias 0 and Dense biases at 0: move
    # them, so that a dropped or swapped parameter shows
    rng = np.random.default_rng(seed)

    def moved(tree):
        return jax.tree_util.tree_map(
            lambda v: np.asarray(v) + (rng.normal(size=v.shape) * 0.1)
            .astype(np.float32), tree)
    return norm, mlp, moved(pn), moved(pm)


def test_slice_matches_jax_ops_and_flax_modules():
    """``fused_mlp(layer_norm(x, ...), ...)`` at D 64, H 256 with the
    parameters of a flax LayerNorm + ``pose3d_tpu`` Mlp carried across by
    ``layer_norm_params`` and ``mlp_params``: outputs and the gradients of x
    and of all six parameters against (a) the JAX ops composed the same way
    (2e-4 / 5e-4, the ops' own bounds) and (b) the flax modules themselves
    (the same bounds: exact erf against the polynomial, two-pass against
    one-pass variance)."""
    norm, mlp, pn, pm = _flax_block()
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 20, 64)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    scale, bias = ln.layer_norm_params(pn)
    w1, b1, w2, b2 = mb.mlp_params(pm)
    assert w1.shape == (64, 256) and w2.shape == (256, 64)
    assert all(t.is_contiguous() for t in (scale, bias, w1, b1, w2, b2))
    leaves = [_t(x, True)] + [t.requires_grad_()
                              for t in (scale, bias, w1, b1, w2, b2)]
    out = mb.fused_mlp(ln.layer_norm(*leaves[:3], 1e-6), *leaves[3:])
    (out * _t(w)).sum().backward()

    flat = (pn["scale"], pn["bias"], pm["Dense_0"]["kernel"],
            pm["Dense_0"]["bias"], pm["Dense_1"]["kernel"],
            pm["Dense_1"]["bias"])

    def ops(x, s, b, w1, b1, w2, b2):
        return jmb.fused_mlp(jln.layer_norm(x, s, b, 1e-6, True), w1, b1,
                             w2, b2, True)

    def modules(x, s, b, w1, b1, w2, b2):
        y = norm.apply({"params": {"scale": s, "bias": b}}, x)
        return mlp.apply({"params": {
            "Dense_0": {"kernel": w1, "bias": b1},
            "Dense_1": {"kernel": w2, "bias": b2}}}, y)

    args = tuple(map(jnp.asarray, (x, *flat)))
    for name, fn in (("jax ops", ops), ("flax modules", modules)):
        _assert_close(out, fn(*args), 2e-4, name)
        grads = jax.grad(lambda *a: (fn(*a) * w).sum(),
                         argnums=tuple(range(7)))(*args)
        for leaf, g, which in zip(leaves, grads, ("x", "scale", "bias", "w1",
                                                  "b1", "w2", "b2")):
            _assert_close(leaf.grad, g, 5e-4, f"{name}: d{which}")


@pytest.mark.parametrize("names", [("fc1", "fc2"), ("0", "3")])
def test_mlp_params_reproduce_the_ports_mlp(names):
    """The port's own ``Mlp`` module (either key convention) carried into
    ``fused_mlp`` gives the module's forward (dropout 0, fp32) within
    2e-6·max(1, |ref|): the polynomial's 1.5e-7 times the second Linear,
    and summation order."""
    torch.manual_seed(0)
    mlp = Mlp(64, 4.0, "gelu", names, device="cpu")
    norm = torch.nn.LayerNorm(64, eps=1e-6)
    with torch.no_grad():
        for p in (*mlp.parameters(), *norm.parameters()):
            p.add_(torch.randn_like(p) * 0.1)
    x = torch.randn(3, 11, 64)
    w1, b1, w2, b2 = mb.mlp_params(mlp)
    assert w1.shape == (64, 256) and w1.is_contiguous()
    assert w2.shape == (256, 64) and w2.is_contiguous()
    with torch.no_grad():
        ref = mlp(x, torch.float32)
        got = mb.fused_mlp(x, w1, b1, w2, b2)
        assert (got - ref).abs().max() <= 2e-6 * ref.abs().max().clamp_min(1)
        scale, bias = ln.layer_norm_params(norm)
        assert scale is norm.weight and bias is norm.bias
        ref = F.layer_norm(x, (64,), norm.weight, norm.bias, 1e-6)
        got = ln.layer_norm(x, scale, bias, 1e-6)
        assert (got - ref).abs().max() <= 2e-6 * ref.abs().max().clamp_min(1)


# --- what the launchers refuse --------------------------------------------------

def _cpu_launcher_calls():
    x, s, b = map(_t, _ln_inputs((6, 32)))
    mx, w1, b1, w2, b2 = map(_t, _mlp_inputs(6, 32, 64))
    stat = torch.zeros(6)
    return {
        "layer_norm_fwd": lambda: ln.layer_norm_fwd(x, s, b),
        "layer_norm_bwd": lambda: ln.layer_norm_bwd(x, s, stat, stat + 1, x),
        "mlp_block_fwd": lambda: mb.mlp_block_fwd(mx, w1, b1, w2, b2),
        "mlp_block_bwd": lambda: mb.mlp_block_bwd(mx, w1, b1, w2, b2, mx),
    }


@pytest.mark.parametrize("name", ["layer_norm_fwd", "layer_norm_bwd",
                                  "mlp_block_fwd", "mlp_block_bwd"])
def test_launchers_refuse_cpu_tensors(name):
    """A launcher never takes the plain version: a CPU tensor raises, no
    launch is counted and nothing is built."""
    fn = getattr(ln if name.startswith("layer") else mb, name)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        _cpu_launcher_calls()[name]()
    assert fn.launches == before
    assert name not in _build.build_info


def test_launchers_refuse_inputs_that_require_grad():
    x, s, b = map(_t, _ln_inputs((6, 32)))
    with pytest.raises(RuntimeError, match="requires grad"):
        ln.layer_norm_fwd(x.requires_grad_(), s, b)
    mx, w1, b1, w2, b2 = map(_t, _mlp_inputs(6, 32, 64))
    with pytest.raises(RuntimeError, match="requires grad"):
        mb.mlp_block_bwd(mx, w1.requires_grad_(), b1, w2, b2, mx)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ln.layer_norm_fwd(x, s, b)      # grad mode off: the next refusal


def test_ops_refuse_bad_impl_and_strided_last_axis():
    x, s, b = map(_t, _ln_inputs((6, 32)))
    mx, *params = map(_t, _mlp_inputs(6, 32, 64))
    with pytest.raises(ValueError, match="impl"):
        ln.layer_norm(x, s, b, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        mb.fused_mlp(mx, *params, impl="pallas")
    # refused on any device, not copied silently
    with pytest.raises(ValueError, match="contiguous"):
        ln.layer_norm(x[:, ::2], s[::2], b[::2])
    with pytest.raises(ValueError, match="contiguous"):
        mb.fused_mlp(torch.randn(32, 6).t(), *params)
    with pytest.raises(ValueError, match="without a copy"):
        ln.layer_norm(torch.randn(4, 6, 32)[:, :5], s, b)
    # a row-strided 2-D view is fine
    wide = torch.randn(6, 48)
    got = ln.layer_norm(wide[:, 8:40], s, b)
    want = ln.layer_norm(wide[:, 8:40].contiguous(), s, b)
    assert torch.equal(got, want)


# --- mlp_block.launch_config: the C dispatch, mirrored in plain Python ------

def test_launch_config_full_width_takes_wgmma():
    """The lifter's MLP (8·1025 rows, D 768, H 3,072, bf16): the wgmma
    path, 64-row blocks in one wave of the card's 132 SMs, the dW kernel's
    grid of H/32 column blocks × G = 4 row groups of 128-row tiles (384
    blocks, about three waves), and fp32 scratch for G partials
    [dW1 | dW2 | db1] plus db2's 129 row blocks."""
    cfg = mb.launch_config(8 * 1025, 768, 3072, 2)
    assert cfg["path"] == "wgmma" and cfg["groups"] == 4
    assert cfg["fwd"] == {"rows": 64, "blocks": 129, "smem": cfg["fwd"]["smem"]}
    assert cfg["dx"]["rows"] == 64 and cfg["dx"]["blocks"] == 129
    assert cfg["dw"]["rows"] == 128 and cfg["dw"]["blocks"] == 96 * 4
    assert cfg["fwd"]["blocks"] <= 132
    assert cfg["scratch_bytes"] == 4 * (4 * (2 * 768 * 3072 + 3072)
                                        + 129 * 768)


@pytest.mark.parametrize("N,D,H,itemsize,path", [
    (8200, 768, 3072, 2, "wgmma"), (1, 128, 512, 2, "wgmma"),
    (7, 128, 512, 2, "wgmma"), (513, 128, 512, 2, "wgmma"),
    (65, 768, 3056, 2, "wgmma"), (70, 192, 80, 2, "wgmma"),
    (7, 48, 80, 2, "wmma"), (1, 16, 16, 2, "wmma"), (33, 720, 160, 2, "wmma"),
    (8200, 768, 3072, 4, "scalar"), (7, 48, 80, 4, "scalar"),
    (513, 128, 512, 4, "scalar"),
])
def test_launch_config_paths_and_shared_memory(N, D, H, itemsize, path):
    """bf16 with D a multiple of 64 → wgmma, any other bf16 D → WMMA, fp32 →
    the scalar kernels; every kernel's dynamic shared memory fits a
    block's 232,448 bytes; the blocks cover the rows."""
    cfg = mb.launch_config(N, D, H, itemsize)
    assert cfg["path"] == path and path in mb.PATHS
    for k in ("fwd", "dx", "dw"):
        assert 0 < cfg[k]["smem"] <= mb.MAX_SMEM == 232448, k
    for k in ("fwd", "dx"):
        assert cfg[k]["blocks"] * cfg[k]["rows"] >= N \
            > (cfg[k]["blocks"] - 1) * cfg[k]["rows"]
    if path != "wgmma":
        assert cfg["groups"] == 1 and cfg["scratch_bytes"] == 0


@pytest.mark.parametrize("N,H,groups", [
    (1, 512, 1), (128, 3072, 1), (129, 3072, 2), (511, 3072, 4),
    (513, 3072, 3), (2177, 3072, 4), (8200, 3072, 4), (102500, 3072, 4),
    (8200, 96, 65), (8200, 16384, 1),
])
def test_launch_config_row_groups(N, H, groups):
    """G: as many row groups as make ceil(H/32)·G about three waves of 132
    SMs, at most one per 128-row tile, and none empty (so 5 tiles split 2,
    2, 1 into three groups, not four)."""
    cfg = mb.launch_config(N, 768, H, 2)
    tiles = -(-N // 128)
    per_group = -(-tiles // cfg["groups"])
    assert cfg["groups"] == groups
    assert (cfg["groups"] - 1) * per_group < tiles <= cfg["groups"] * per_group
    assert cfg["dw"]["blocks"] == -(-H // 32) * groups
    assert cfg["groups"] <= max(1, 396 // -(-H // 32))


# --- csrc/hopper_mma.cuh holds what its kernels call, nothing ahead of them ---

def test_hopper_mma_header_has_no_unused_form():
    """Every function the shared header defines is called from a kernel
    source of the directory (or from the header itself, as the tensor-map
    helper is): a form arrives with its first caller."""
    csrc = _build.CSRC_DIR
    header = (csrc / "hopper_mma.cuh").read_text()
    names = set(re.findall(
        r"^(?:__device__ __forceinline__|inline|constexpr) [\w:<> ]*?"
        r"(\w+)(?:\(| =)", header, flags=re.M))
    assert {"wgmma_m64n32k16", "wgmma_m64n192k16", "tma_load_2d",
            "mbar_wait", "make_desc", "tma_map_bf16"} <= names
    sources = "".join(f.read_text() for f in sorted(csrc.glob("*.cu")))
    body = header.split("namespace hmma {", 1)[1]
    unused = sorted(n for n in names
                    if not re.search(rf"\b{n}\b", sources)
                    and len(re.findall(rf"\b{n}\b", body)) < 2)
    assert unused == []

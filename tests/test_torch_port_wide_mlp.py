"""pose3d_tpu_torch ``fused_mlp`` at every width the TPU kernel takes:
widths that are no multiple of 16 run zero-padded to one
(``run_padded_fwd`` / ``run_padded_bwd``, here with the plain pair standing
in for the kernels), against the Pallas ``fused_mlp`` in interpret mode,
output and all five gradients, at D 40 / H 100 and at ViT-L's D 1,024 /
H 4,096 over a few rows; and ``launch_config``'s plan for the padded
widths and for D above 768, whose output columns the WMMA and fp32
kernels split across blocks; the refusal past D 1,280."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (caps torch at one thread)

from pose3d_tpu.ops.pallas import mlp_block as jmb

from pose3d_tpu_torch.ops.kernels import mlp_block as mb


def _mlp_inputs(N, D, H, seed):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)
    return (n(N, D), n(D, H, s=D ** -0.5), n(H, s=0.1), n(H, D, s=H ** -0.5),
            n(D, s=0.1), n(N, D))


def _close(got, want, tol, what):
    """|Δ| <= tol·(1 + |want|), as the row-op tests hold the Pallas op."""
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


# fp32, the same arithmetic and polynomial, sums in another order: the
# bounds of the row-op tests against the Pallas op (2e-4 forward, 5e-4
# gradients); against the plain pair at the true widths the padding only
# adds exact zeros: 1e-5
@pytest.mark.parametrize("N,D,H", [(37, 40, 100), (9, 1024, 4096)])
def test_padded_route_matches_pallas(N, D, H):
    x, w1, b1, w2, b2, g = _mlp_inputs(N, D, H, D + H)
    jargs = tuple(map(jnp.asarray, (x, w1, b1, w2, b2)))
    want = jmb.fused_mlp(*jargs, True)
    _, vjp = jax.vjp(lambda *a: jmb.fused_mlp(*a, True), *jargs)
    want_grads = vjp(jnp.asarray(g))
    targs = tuple(map(torch.from_numpy, (x, w1, b1, w2, b2)))
    tg = torch.from_numpy(g)
    out = mb.run_padded_fwd(mb.mlp_block_fwd_reference, *targs)
    grads = mb.run_padded_bwd(mb.mlp_block_bwd_reference, *targs, tg)
    plain = mb.mlp_block_fwd_reference(*targs)
    plain_grads = mb.mlp_block_bwd_reference(*targs, tg)
    assert out.shape == (N, D) and out.is_contiguous()
    _close(out, want, 2e-4, "out")
    _close(out, plain.numpy(), 1e-5, "out vs plain")
    for name, a, p, w, t in zip(("dx", "dw1", "db1", "dw2", "db2"), grads,
                                plain_grads, want_grads, targs):
        assert a.shape == t.shape and a.is_contiguous(), name
        _close(a, w, 5e-4, name)
        _close(a, p.numpy(), 1e-5, name + " vs plain")


def test_padded_route_pads_with_zeros_to_multiples_of_16():
    """What the launch sees at D 40, H 100: widths 48 and 112, the padded
    rows and columns of x, w1, b1, w2, b2 and g zero, the rest as given;
    what comes back is sliced to the true widths."""
    args = tuple(map(torch.from_numpy, _mlp_inputs(3, 40, 100, 1)))
    seen = []

    def launch(*a):
        seen.append(a)
        return mb.mlp_block_bwd_reference(*a)
    dx, dw1, db1, dw2, db2 = mb.run_padded_bwd(launch, *args)
    (x, w1, b1, w2, b2, g), = seen
    assert [tuple(t.shape) for t in (x, w1, b1, w2, b2, g)] == [
        (3, 48), (48, 112), (112,), (112, 48), (48,), (3, 48)]
    for got, want in zip((x, w1, b1, w2, b2, g), args):
        inside = tuple(slice(0, n) for n in want.shape)
        assert torch.equal(got[inside], want)
        rest = got.clone()
        rest[inside] = 0
        assert not rest.any()
    assert [tuple(t.shape) for t in (dx, dw1, db1, dw2, db2)] == [
        (3, 40), (40, 100), (100,), (100, 40), (40,)]


@pytest.mark.parametrize("D,slices,cols", [
    (768, 1, 768), (784, 2, 400), (1024, 2, 512), (1280, 2, 640),
    (16, 1, 16), (48, 1, 48)])
def test_column_slices(D, slices, cols):
    """At most 768 output columns a block, in multiples of 16, as even as
    that allows; the slices cover D."""
    assert mb.column_slices(D) == (slices, cols)
    assert cols <= mb.MAX_COLS and cols % 16 == 0
    assert (slices - 1) * cols < D <= slices * cols


@pytest.mark.parametrize("N,D,H,itemsize,path,slices", [
    (8200, 1024, 4096, 2, "wmma", 2), (8200, 1280, 5120, 2, "wmma", 2),
    (8200, 1280, 5120, 4, "scalar", 2), (257, 776, 3104, 2, "wmma", 2),
    (257, 40, 100, 2, "wmma", 1), (257, 40, 100, 4, "scalar", 1),
    (8200, 768, 3072, 2, "wgmma", 1), (63, 760, 3000, 2, "wgmma", 1)])
def test_launch_config_of_wide_and_odd_widths(N, D, H, itemsize, path,
                                              slices):
    """The plan is the padded widths' (multiples of 16); above 768 the
    forward's and dx's blocks are the row blocks times the column slices,
    dW's the 16-column hidden chunks times the slices; fp32 dW tiles drop
    to 16 rows where 32 would not fit; every kernel fits a block's shared
    memory. D 760 pads to 768 and takes the wgmma kernels."""
    cfg = mb.launch_config(N, D, H, itemsize)
    Dp, Hp = cfg["padded"]
    assert (Dp, Hp) == (16 * -(-D // 16), 16 * -(-H // 16))
    assert cfg["path"] == path and cfg["slices"] == slices
    assert cfg["cols"] == mb.column_slices(Dp)[1]
    for key in ("fwd", "dx", "dw"):
        assert 0 < cfg[key]["smem"] <= mb.MAX_SMEM, key
    if path != "wgmma":
        rows = cfg["fwd"]["rows"]
        assert cfg["fwd"]["blocks"] == cfg["dx"]["blocks"] \
            == -(-N // rows) * slices
        assert cfg["dw"]["blocks"] == Hp // 16 * slices
        want_rows = 16 if itemsize == 4 and Dp > 880 else 32
        assert cfg["dw"]["rows"] == want_rows


@pytest.mark.parametrize("itemsize", [2, 4])
def test_every_width_up_to_1280_fits(itemsize):
    """Each D that is a multiple of 16 up to 1,280 gets a plan within a
    block's shared memory, on the wgmma kernels exactly when bf16 D is a
    multiple of 64 up to 768."""
    for D in range(16, 1281, 16):
        cfg = mb.launch_config(100, D, 4 * D, itemsize)
        assert max(cfg[k]["smem"] for k in ("fwd", "dx", "dw")) \
            <= mb.MAX_SMEM, D
        wgmma = itemsize == 2 and D % 64 == 0 and D <= 768
        assert (cfg["path"] == "wgmma") == wgmma, D


@pytest.mark.parametrize("D,H", [(40, 100), (1280, 5120), (776, 3104)])
def test_launchers_take_every_width_up_to_1280(D, H):
    """The width checks pass (these are CPU tensors: the device check
    refuses them), before any launch."""
    x, w1, b1, w2, b2, g = map(torch.zeros, ((2, D), (D, H), (H,), (H, D),
                                             (D,), (2, D)))
    before = (mb.mlp_block_fwd.launches, mb.mlp_block_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        mb.mlp_block_fwd(x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="CUDA"):
        mb.mlp_block_bwd(x, w1, b1, w2, b2, g)
    assert (mb.mlp_block_fwd.launches, mb.mlp_block_bwd.launches) == before


@pytest.mark.parametrize("D", [1281, 1296, 2048])
def test_launchers_refuse_d_past_1280_naming_the_limit(D):
    x, w1, b1, w2, b2 = map(torch.zeros, ((2, D), (D, 64), (64,), (64, D),
                                          (D,)))
    before = (mb.mlp_block_fwd.launches, mb.mlp_block_bwd.launches)
    with pytest.raises(ValueError, match="1280"):
        mb.mlp_block_fwd(x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="1280"):
        mb.mlp_block_bwd(x, w1, b1, w2, b2, x)
    assert (mb.mlp_block_fwd.launches, mb.mlp_block_bwd.launches) == before

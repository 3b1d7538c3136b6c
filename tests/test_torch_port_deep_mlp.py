"""pose3d_tpu_torch ``fused_mlp`` past D 1,280, where the WMMA and fp32
kernels stream D through shared memory in chunks (``depth_chunks``),
summing x·w1 and g·w2ᵀ over the chunks in order before the GELU, and split
the output columns across blocks (``column_slices``): the plain pair
(standing in for the kernels) against the Pallas ``fused_mlp`` in interpret
mode, output and all five gradients, at (1,344, 5,376) (H = 4D: the widest
the TPU kernel's VMEM budget takes at H = 4D), (2,048, 2,048) and (4,096,
512) over a few dozen rows; and ``launch_config``'s plan at those widths
and at every width past 1,280 up to 8,192."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (caps torch at one thread)

from pose3d_tpu.ops.pallas import mlp_block as jmb

from pose3d_tpu_torch.ops.kernels import mlp_block as mb

WIDE = [(24, 1344, 5376), (24, 2048, 2048), (16, 4096, 512)]


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
# gradients)
@pytest.mark.parametrize("N,D,H", WIDE)
def test_wide_plain_pair_matches_pallas(N, D, H):
    x, w1, b1, w2, b2, g = _mlp_inputs(N, D, H, D + H)
    jargs = tuple(map(jnp.asarray, (x, w1, b1, w2, b2)))
    want = jmb.fused_mlp(*jargs, True)
    _, vjp = jax.vjp(lambda *a: jmb.fused_mlp(*a, True), *jargs)
    want_grads = vjp(jnp.asarray(g))
    targs = tuple(map(torch.from_numpy, (x, w1, b1, w2, b2)))
    out = mb.run_padded_fwd(mb.mlp_block_fwd_reference, *targs)
    grads = mb.run_padded_bwd(mb.mlp_block_bwd_reference, *targs,
                              torch.from_numpy(g))
    assert out.shape == (N, D)
    _close(out, want, 2e-4, "out")
    for name, a, w, t in zip(("dx", "dw1", "db1", "dw2", "db2"), grads,
                             want_grads, targs):
        assert a.shape == t.shape, name
        _close(a, w, 5e-4, name)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("N,D,H,chunks,slices", [
    (8200, 1344, 5376, (2, 672), 2), (8200, 2048, 2048, (2, 1024), 3),
    (8200, 4096, 512, (4, 1024), 6), (8200, 1280, 5120, (1, 1280), 2),
    (64, 2560, 256, (2, 1280), 4)])
def test_launch_config_streams_d_past_1280(N, D, H, chunks, slices,
                                           itemsize):
    """Past 1,280 the plan streams D in chunks of at most 1,280 columns
    (ViT-H's 1,280 keeps one chunk: its plan as before), the output columns
    in slices of at most 768, on the WMMA (bf16) or scalar (fp32) path;
    every kernel's shared memory is that of the chunk's width, within a
    block's 232,448 bytes."""
    cfg = mb.launch_config(N, D, H, itemsize)
    assert cfg["chunks"] == chunks == mb.depth_chunks(D)
    assert cfg["slices"] == slices
    assert cfg["path"] == ("wmma" if itemsize == 2 else "scalar")
    for key in ("fwd", "dx", "dw"):
        assert 0 < cfg[key]["smem"] <= mb.MAX_SMEM, key
    narrow = mb.launch_config(N, chunks[1], H, itemsize)
    if itemsize == 4:
        # the fp32 dW tile and the x tiles are the chunk's width
        assert cfg["dw"] == dict(narrow["dw"], blocks=H // 16 * slices)
    else:
        assert cfg["fwd"]["smem"] - 32 * 132 * 4 - 32 * 136 * 2 \
            == 32 * (chunks[1] + 8) * 2


@pytest.mark.parametrize("itemsize", [2, 4])
def test_every_width_past_1280_fits(itemsize):
    """Each D that is a multiple of 16 from 1,296 to 8,192 gets a plan
    within a block's shared memory."""
    for D in range(1296, 8193, 16):
        cfg = mb.launch_config(100, D, 64, itemsize)
        assert max(cfg[k]["smem"] for k in ("fwd", "dx", "dw")) \
            <= mb.MAX_SMEM, D
        n, cols = cfg["chunks"]
        assert n >= 2 and cols <= mb.MAX_CHUNK and n * cols >= D, D

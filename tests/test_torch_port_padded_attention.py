"""pose3d_tpu_torch flash attention at every head depth the TPU kernel
takes: the launchers run a (D, Dv) pair that is not built on the smallest
built pair that holds it (``padded_pair``), q and k zero-padded to its D,
v, o and dO to its Dv, at the scale of the true D, and slice the outputs
back. Here the plain pair stands in for the kernels
(``run_padded_fwd`` / ``run_padded_bwd``), held to the unpadded plain pair
and to the Pallas ``_fwd_impl`` / ``_bwd_impl`` in interpret mode; then
``padded_pair``, the (256, 256) launch plan in ``launch_config`` and
depths past 256, which pad to multiples of 64 for the deep instance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose3d_tpu.ops.pallas.flash_attention import _bwd_impl, _fwd_impl

from pose3d_tpu_torch.ops.kernels import flash_attention as fa

# (B, Tq, Tk, H, D, Dv): D = Dv off the built pairs (8 and 24 below the
# lifter's, 40, 80 = ViT-H's, 96 = transformer_heads 8 at embed 768, and
# 200 on the widest pair), and two pairs with Dv != D, at ragged lengths
PADDED_SHAPES = [
    (2, 9, 13, 2, 8, 8),
    (1, 17, 5, 3, 24, 24),
    (1, 12, 20, 2, 40, 40),
    (1, 10, 7, 2, 80, 80),
    (2, 7, 11, 2, 96, 96),
    (1, 6, 9, 1, 200, 200),
    (1, 11, 6, 2, 48, 96),
    (2, 5, 12, 2, 24, 40),
]


def _arrays(shape, seed):
    B, Tq, Tk, H, D, Dv = shape
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Tq, H, D), (B, Tk, H, D), (B, Tk, H, Dv),
                      (B, Tq, H, Dv))]


def _ids(shape):
    return f"D{shape[4]}-Dv{shape[5]}"


@pytest.mark.parametrize("shape", PADDED_SHAPES, ids=_ids)
def test_padded_forward_matches_plain_and_pallas(shape):
    """o [B, Tq, H, Dv] and lse through the padded route, fp32: against
    the plain forward at the true depths to 1e-6 (zero columns add exact
    zeros, the sums' order may move) and against the Pallas ``_fwd_impl``
    (interpret mode) to 1e-5 (summation order only)."""
    q, k, v, _ = _arrays(shape, sum(shape))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert fa.padded_pair(shape[4], shape[5]) != (shape[4], shape[5])
    o, lse = fa.run_padded_fwd(fa.flash_attention_fwd_reference, tq, tk, tv)
    ro, rlse = fa.flash_attention_fwd_reference(tq, tk, tv)
    jo, jlse = _fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    B, Tq, _, H, _, Dv = shape
    assert o.shape == (B, Tq, H, Dv) and o.is_contiguous()
    assert lse.shape == (B, H, Tq)
    np.testing.assert_allclose(o.numpy(), ro.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., :Tq],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", PADDED_SHAPES, ids=_ids)
def test_padded_backward_matches_plain_and_pallas(shape):
    """dq, dk [.., D] and dv [.., Dv] through the padded route on the
    Pallas forward's o and lse, fp32: against the plain backward at the
    true depths to 1e-6·max(1, |ref|) and against the Pallas ``_bwd_impl``
    (interpret mode) to 1e-5·max(1, |ref|): summation order only."""
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
        assert a.shape == b.shape and a.is_contiguous(), name
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=0,
                                   atol=1e-6 * scale, err_msg=name)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def test_padded_route_keeps_the_true_depths_scale():
    """The route fixes the scale 1/√D of the true D before it pads: a
    forward that scaled by the padded depth's would be off by √(Dp/D)."""
    q, k, v, _ = map(torch.from_numpy, _arrays((1, 6, 6, 1, 96, 96), 5))
    seen = []

    def launch(q, k, v, scale):
        seen.append((q.shape[-1], v.shape[-1], scale))
        return fa.flash_attention_fwd_reference(q, k, v, scale)
    fa.run_padded_fwd(launch, q, k, v)
    assert seen == [(128, 128, 1.0 / 96 ** 0.5)]


@pytest.mark.parametrize("D,Dv,want", [
    (8, 8, (16, 16)), (16, 16, (16, 16)), (24, 24, (32, 32)),
    (40, 40, (48, 48)), (48, 48, (48, 48)), (80, 80, (128, 128)),
    (96, 96, (128, 128)), (129, 129, (256, 256)), (200, 200, (256, 256)),
    (256, 256, (256, 256)), (48, 96, (128, 128)), (24, 40, (32, 64)),
    (32, 64, (32, 64)), (64, 32, (64, 64)), (1, 256, (256, 256))])
def test_padded_pair_is_the_smallest_built_pair_that_holds_it(D, Dv, want):
    assert fa.padded_pair(D, Dv) == want
    assert want in fa.PAIRS


@pytest.mark.parametrize("D,Dv", [(264, 264), (257, 8), (8, 300)])
def test_depths_past_256_are_refused_naming_the_limit(D, Dv):
    """Past depth 256 was refused until the deep instance took it: now
    ``padded_pair`` rounds D and Dv up to multiples of 64 and both
    launchers pass every depth check (these CPU tensors are refused only
    for their device), before any launch. An empty depth is still
    refused, naming it."""
    Dp, Dvp = fa.padded_pair(D, Dv)
    assert (Dp, Dvp) == (64 * -(-D // 64), 64 * -(-Dv // 64))
    assert fa.is_deep(Dp, Dvp) and (Dp, Dvp) not in fa.PAIRS
    with pytest.raises(ValueError, match="D=0"):
        fa.padded_pair(0, Dv)
    q, v = torch.zeros(1, 4, 1, D), torch.zeros(1, 4, 1, Dv)
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, q, v)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q, q, v, v, v, torch.zeros(1, 1, 4))
    with pytest.raises(ValueError, match="D=0"):
        fa.flash_attention_fwd(q[..., :0], q[..., :0], v)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches) == before


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("Tq,Tk", [(1, 1), (65, 33), (1025, 1025)])
def test_launch_config_of_the_widest_pair(Tq, Tk, itemsize):
    """(256, 256): the forward takes 64 query rows a block on the WMMA
    path (194,560 bytes of shared memory) and 32 in fp32 (four threads a
    row, the rows' q in shared memory: 174,720 bytes), the backward 32 keys
    a block (187,904 and 217,088 bytes), 128 threads, all within a block's
    232,448."""
    B, H = 2, 3
    cfg = fa.launch_config(B, Tq, Tk, H, 256, 256, itemsize)
    assert cfg["path"] == ("wmma" if itemsize == 2 else "scalar")
    fwd, bwd = cfg["fwd"], cfg["bwd"]
    rows = 64 if itemsize == 2 else 32
    assert (fwd["rows"], bwd["rows"]) == (rows, 32)
    assert fwd["grid"] == (-(-Tq // rows), H, B)
    assert bwd["grid"] == (-(-Tk // 32), H, B)
    assert (fwd["smem"], bwd["smem"]) == ((194560, 187904) if itemsize == 2
                                          else (174720, 217088))
    assert fwd["threads"] == bwd["threads"] == 128
    assert max(fwd["smem"], bwd["smem"]) <= fa.MAX_SMEM
    assert cfg["scratch_floats"] == B * H * Tq


@pytest.mark.parametrize("D,Dv", [(48, 96), (96, 96), (200, 200), (24, 40)])
def test_wrappers_take_pairs_that_are_not_built(D, Dv):
    """A pair off the built ones passes every check of both launchers but
    the device one (these are CPU tensors), before any launch."""
    q, k, v = torch.zeros(1, 4, 2, D), torch.zeros(1, 5, 2, D), \
        torch.zeros(1, 5, 2, Dv)
    o, lse = torch.zeros(1, 4, 2, Dv), torch.zeros(1, 2, 4)
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q, k, v, o, o, lse)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches) == before

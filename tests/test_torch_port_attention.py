"""pose3d_tpu_torch flash attention beyond the lifter's shapes: a value
depth Dv other than the key depth D (YOLO11's PSA pair, D = Dv / 2), as the
TPU kernel takes it — the plain forward and backward against the Pallas
``_fwd_impl`` / ``_bwd_impl`` in interpret mode, and through the autograd
Function — and ``launch_config``, the kernels' C dispatch mirrored in plain
Python: the path each shape takes, the blocks, grids and shared memory."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose3d_tpu.ops.pallas.flash_attention import _bwd_impl, _fwd_impl

from pose3d_tpu_torch.ops.attention import dot_product_attention
from pose3d_tpu_torch.ops.kernels import flash_attention as fa

# (B, Tq, Tk, H, D, Dv): the PSA pair, self and cross, ragged across the
# kernels' 64-row tiles, one the kernels are not built for (the plain
# versions take any pair), then head depth 16 at the shapes of a lifter of
# embed 64 over 4 heads at 64 px (17 image tokens, 4 heatmap tokens: self
# and both cross attentions) and across a 64-row tile
DV_SHAPES = [
    (1, 20, 20, 2, 32, 64),
    (2, 9, 70, 1, 32, 64),
    (1, 66, 5, 2, 32, 64),
    (1, 12, 12, 2, 64, 32),
    (2, 17, 17, 4, 16, 16),
    (2, 17, 4, 4, 16, 16),
    (2, 4, 17, 4, 16, 16),
    (1, 70, 130, 2, 16, 16),
]


def _arrays(shape, seed):
    B, Tq, Tk, H, D, Dv = shape
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Tq, H, D), (B, Tk, H, D), (B, Tk, H, Dv),
                      (B, Tq, H, Dv))]


@pytest.mark.parametrize("shape", DV_SHAPES)
def test_plain_forward_with_value_depth_matches_pallas(shape):
    """o [B, Tq, H, Dv] and lse of the plain forward against the Pallas
    ``_fwd_impl`` (interpret mode), fp32, to 1e-5: summation order only."""
    q, k, v, _ = _arrays(shape, sum(shape))
    jo, jlse = _fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    o, lse = fa.flash_attention_fwd_reference(
        *map(torch.from_numpy, (q, k, v)))
    B, Tq, _, H, _, Dv = shape
    assert o.shape == (B, Tq, H, Dv) and lse.shape == (B, H, Tq)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., :Tq],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", DV_SHAPES)
def test_plain_backward_with_value_depth_matches_pallas(shape):
    """dq, dk [.., D] and dv [.., Dv] of the plain backward against the
    Pallas ``_bwd_impl`` (interpret mode) on the Pallas forward's o and
    lse, fp32, to 1e-5·max(1, |ref|): summation order only."""
    q, k, v, g = _arrays(shape, 3 * sum(shape))
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    jo, jlse = _fwd_impl(jq, jk, jv, True)
    want = _bwd_impl(jq, jk, jv, jo, jg, jlse, True)
    Tq = shape[1]
    got = fa.flash_attention_bwd_reference(
        *map(torch.from_numpy, (q, k, v, np.array(jo), g,
                                np.array(jlse)[..., :Tq])))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        tol = 1e-5 * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("shape", DV_SHAPES[:2])
def test_function_with_value_depth_matches_autograd(shape):
    """``dot_product_attention`` (the Function's plain pair on the CPU)
    gives the gradients torch.autograd finds through the plain forward,
    with Dv != D, to 1e-5·max(1, |ref|)."""
    q, k, v, w = map(torch.from_numpy, _arrays(shape, 11))
    grads = []
    for attend in (dot_product_attention,
                   lambda q, k, v: fa.flash_attention_fwd_reference(q, k, v)[0]):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        (attend(*leaves) * w).sum().backward()
        grads.append([x.grad for x in leaves])
    for got, want in zip(*grads):
        assert got.shape == want.shape
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        assert (got - want).abs().max().item() <= tol


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def test_wrappers_take_the_psa_pair_and_name_the_pairs_built():
    """(D 32, Dv 64) passes every check but the device one (these are CPU
    tensors); so does (32, 48), a pair that is not built, which the
    launchers run on the built (32, 64) (:func:`padded_pair`); a value
    depth past 256 is refused with the limit and the widest pair built, by
    both launchers, before any launch."""
    q, k, v = _t(1, 4, 2, 32), _t(1, 5, 2, 32), _t(1, 5, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, k, v)
    o, lse = _t(1, 4, 2, 64), _t(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q, k, v, o, o, lse)
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    assert fa.padded_pair(32, 48) == (32, 64)
    v48 = _t(1, 5, 2, 48)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, k, v48)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q, k, v48, _t(1, 4, 2, 48), _t(1, 4, 2, 48),
                               lse)
    bad_v = _t(1, 5, 2, 264)
    with pytest.raises(ValueError, match=r"256 \(the widest pair built is "
                       r"\(256, 256\)\)"):
        fa.flash_attention_fwd(q, k, bad_v)
    with pytest.raises(ValueError, match="value depth Dv=264"):
        fa.flash_attention_bwd(q, k, bad_v, _t(1, 4, 2, 264),
                               _t(1, 4, 2, 264), lse)
    with pytest.raises(ValueError, match="q's shape with v's depth"):
        fa.flash_attention_bwd(q, k, v, o, _t(1, 4, 2, 32), lse)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches) == before


def test_aligned_reads_packed_views_in_place_and_copies_the_rest():
    """The packed q/k/v of a self-attention (views of one [B, T, 3, H, D]
    projection) and the cross attention's k/v reach the kernels as they
    are; a [B, H, T, D] tensor seen as [B, T, H, D], or a last dim that is
    not contiguous, is copied into the layout the TMA maps read."""
    qkv = torch.zeros(2, 33, 3, 4, 48, dtype=torch.bfloat16)
    for x in qkv.unbind(2):
        assert fa._aligned(x) is x
    kv = torch.zeros(2, 16, 2, 4, 64)
    for x in kv.unbind(2):
        assert fa._aligned(x) is x
    one = torch.zeros(1, 1, 1, 64)
    assert fa._aligned(one) is one
    swapped = torch.zeros(2, 4, 33, 64).transpose(1, 2)
    fixed = fa._aligned(swapped)
    assert fixed is not swapped and fixed.is_contiguous()
    strided = torch.zeros(2, 33, 4, 128)[..., ::2]
    assert fa._aligned(strided).is_contiguous()


# --- launch_config: the C dispatch, mirrored in plain Python ----------------

# (Tq, Tk, H, D) of the lifter's attentions and the ragged shapes that
# chip_smoke.py checks, and edge lengths around the 64- and 128-row blocks
PATH_SHAPES = [(1025, 1025, 12, 64), (1024, 16, 16, 48), (16, 1024, 16, 48),
               (1041, 1041, 16, 48)]
RAGGED_SHAPES = [(1, 1, 4, 64), (17, 130, 4, 48), (130, 17, 4, 64)]
EDGES = [(t, t, 3, d) for t in (1, 63, 64, 65, 127, 128, 129)
         for d in (48, 64)]


def _expect_path(D, Dv, itemsize):
    if itemsize == 4:
        return "scalar"
    return "wgmma" if D == Dv and D in (48, 64) else "wmma"


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", PATH_SHAPES + RAGGED_SHAPES + EDGES)
def test_launch_config_path_blocks_and_shared_memory(shape, itemsize):
    """bf16 at the lifter's depths 48 and 64 takes the wgmma kernels (128
    query rows or keys a block, 384 threads), fp32 the scalar ones; the
    forward's blocks cover Tq and the backward's cover Tk, one per (H, B);
    every kernel's dynamic shared memory fits a block's 232,448 bytes."""
    Tq, Tk, H, D = shape
    B = 2
    cfg = fa.launch_config(B, Tq, Tk, H, D, D, itemsize)
    path = _expect_path(D, D, itemsize)
    assert cfg["path"] == path and path in fa.PATHS
    rows = 128 if path == "wgmma" else 64
    for key, T in (("fwd", Tq), ("bwd", Tk)):
        part = cfg[key]
        assert part["rows"] == rows
        assert part["threads"] == (384 if path == "wgmma" else 128)
        nb, gh, gb = part["grid"]
        assert (gh, gb) == (H, B)
        assert nb * rows >= T > (nb - 1) * rows
        assert 0 < part["smem"] <= fa.MAX_SMEM == 232448


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("D,Dv", [(32, 32), (48, 48), (64, 64), (128, 128),
                                  (32, 64), (16, 16)])
def test_launch_config_pairs(D, Dv, itemsize):
    """Each built pair in each dtype: the path by shape alone (the wgmma
    kernels only for bf16 with D = Dv in {48, 64}; the PSA pair on the
    WMMA or scalar kernels) and the backward's scratch: δ per query row,
    or on the wgmma path (lse·log2 e, δ) pairs over whole 64-row tiles."""
    B, Tq, Tk, H = 2, 400, 400, 6
    cfg = fa.launch_config(B, Tq, Tk, H, D, Dv, itemsize)
    assert cfg["path"] == _expect_path(D, Dv, itemsize)
    tiles = -(-Tq // 64)
    want = 2 * B * H * tiles * 64 if cfg["path"] == "wgmma" else B * H * Tq
    assert cfg["scratch_floats"] == want
    for part in (cfg["fwd"], cfg["bwd"]):
        assert 0 < part["smem"] <= fa.MAX_SMEM


@pytest.mark.parametrize("D,Dv", [(64, 32), (40, 40), (48, 64)])
def test_launch_config_refuses_pairs_not_built(D, Dv):
    with pytest.raises(ValueError, match="not built"):
        fa.launch_config(1, 8, 8, 1, D, Dv, 2)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("Tq,Tk", [(17, 17), (17, 4), (4, 17), (70, 130)])
def test_launch_config_head_depth_16(Tq, Tk, itemsize):
    """D = Dv = 16, the pair the TPU kernel takes for a lifter of embed 64
    over 4 heads: bf16 on the WMMA kernels, fp32 on the scalar ones, 64
    query rows or keys and 128 threads a block, the backward's scratch one
    δ a query row, and the smallest shared memory of any pair."""
    B, H = 2, 4
    cfg = fa.launch_config(B, Tq, Tk, H, 16, 16, itemsize)
    assert cfg["path"] == ("wmma" if itemsize == 2 else "scalar")
    assert cfg["scratch_floats"] == B * H * Tq
    for key, T in (("fwd", Tq), ("bwd", Tk)):
        part = cfg[key]
        assert (part["rows"], part["threads"]) == (64, 128)
        assert part["grid"] == (-(-T // 64), H, B)
        others = [fa.launch_config(B, Tq, Tk, H, D, Dv, itemsize)[key]["smem"]
                  for D, Dv in fa.PAIRS if (D, Dv) != (16, 16)
                  and fa.launch_config(B, Tq, Tk, H, D, Dv, itemsize)["path"]
                  == cfg["path"]]
        assert 0 < part["smem"] < min(others)


def test_wrappers_take_head_depth_16():
    """(16, 16) passes every check of both launchers but the device one
    (these are CPU tensors), before any launch."""
    q, k, v = _t(2, 17, 4, 16), _t(2, 4, 4, 16), _t(2, 4, 4, 16)
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q, k, v, q, q, _t(2, 4, 17))
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches) == before


def test_launch_config_lifter_vit_shape():
    """The ViT blocks' attention at batch 8: 9 blocks of 128 query rows
    (the last holds one) for each of 12 heads and 8 images, 864 blocks,
    about 6.5 waves of the card's 132 SMs, one block an SM."""
    cfg = fa.launch_config(8, 1025, 1025, 12, 64, 64, 2)
    assert cfg["path"] == "wgmma"
    assert cfg["fwd"]["grid"] == (9, 12, 8) == cfg["bwd"]["grid"]
    assert cfg["fwd"]["smem"] > fa.MAX_SMEM // 2     # one block an SM
    assert cfg["scratch_floats"] == 2 * 8 * 12 * 17 * 64

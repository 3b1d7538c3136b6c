"""pose3d_tpu_torch ``lane_resample`` in bf16, which the TPU kernel takes
(x of any float type, returned in it): the plain version against the
Pallas kernel in interpret mode on the same rows as the fp32 tests, orders
0 and 1. The positions stay fp32; the weight, the masks, the products and
the sum are bf16, rounded one by one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_augment import _resample_case

from pose3d_tpu.ops.pallas.lane_resample import lane_resample as jax_resample

from pose3d_tpu_torch.ops.kernels import lane_resample as lr


@pytest.mark.parametrize("grid", [True, False], ids=["grid_a", "free_a"])
@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("w", [50, 129, 200, 500])
def test_plain_lane_resample_bf16_matches_pallas(w, order, grid):
    """Order 0 picks the same pixels: equal. Order 1 where a·j is exact
    (a on a 1/64 grid): equal, the bf16 roundings being the same. For a
    free a, XLA on the CPU fuses a·j + o into one multiply-add (the fp32
    test states it), so a weight can round to the neighbouring bf16 value:
    one bf16 step of values in [0, 1], 2^-8."""
    x, a, o = _resample_case(w, order, grid)
    xb = torch.from_numpy(x).bfloat16()
    want = np.asarray(jax_resample(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(a),
        jnp.asarray(o), order=order, interpret=True)).astype(np.float32)
    got = lr.lane_resample_reference(xb, torch.from_numpy(a),
                                     torch.from_numpy(o), order)
    assert got.dtype == torch.bfloat16 and got.shape == (13, w)
    got = got.float().numpy()
    assert not got[10].any() and got[:10].any(axis=1).all()
    if order == 0 or grid:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -8)


def test_plain_lane_resample_bf16_rounds_where_the_kernel_does():
    """The weight is rounded to bf16 before it is used: a position whose
    fraction is no bf16 value gives x·(1 − bf16(w)), not x·(1 − w)."""
    x = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.bfloat16)
    a, o = torch.tensor([0.0]), torch.tensor([0.3])   # every p = 0.3
    got = lr.lane_resample_reference(x, a, o, 1)[0, 0]
    wt = torch.tensor(0.3, dtype=torch.float32).bfloat16()
    assert got == (1.0 - wt).bfloat16()


def test_launcher_takes_bf16_and_keeps_fp32_positions():
    """bf16 x passes every check but the device one (CPU tensors); x of
    another float type, or positions other than fp32, are refused."""
    x, a = torch.zeros(4, 8, dtype=torch.bfloat16), torch.zeros(4)
    before = lr.lane_resample.launches
    with pytest.raises(ValueError, match="CUDA"):
        lr.lane_resample(x, a, a)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lr.lane_resample(x.half(), a, a)
    with pytest.raises(ValueError, match="positions are float32"):
        lr.lane_resample(x, a.bfloat16(), a)
    assert lr.lane_resample.launches == before

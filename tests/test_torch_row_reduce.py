"""The launch plans of the port's row kernels on ``csrc/row_reduce.cuh``'s
stream, as their Python mirrors compute them. ``bn_stats`` and the
``layer_norm`` backward (``csrc/bn_stats.cu``, ``csrc/layer_norm_bwd.cu``,
``launch_config``): one launch a call, every row and column covered once,
a grid that fits the card's resident blocks (the launch is cooperative),
shared memory within a block's 232,448 bytes, and scratch and counters
sized from the plan. The ``layer_norm`` forward (``csrc/layer_norm_fwd.cu``,
``fwd_launch_config``): one launch of a persistent grid no larger than the
card's resident blocks, in which every row has exactly one warp, and a
ring of rows in shared memory that fits the SM, at ``chip_smoke.py``'s
shapes. The kernels themselves run only on the card
(``tests/test_torch_port_card.py``, marked ``cuda``); there
``chip_smoke.py`` also holds each mirror equal to the built library's plan.
"""

import numpy as np
import pytest

from chip_smoke import LN_RAGGED as CHIP_LN_RAGGED
from chip_smoke import ROW_COUNTS, ROW_WIDTH, TRAIN_ROWS
from pose3d_tpu_torch.ops.kernels import bn_stats as bn
from pose3d_tpu_torch.ops.kernels import layer_norm as ln
from pose3d_tpu_torch.ops.kernels._launch import SMS

MAX_SMEM = 232448
# (n, C) of the 59 bn_stats calls of one train-mode forward of the
# full-width batch_pallas CNN at microbatch 10 (13 shapes), and ragged ones
BN_PATH = [(625000, 64), (156250, 384), (156250, 128), (156250, 64),
           (39690, 768), (39690, 512), (39690, 384), (39690, 256),
           (10240, 3072), (10240, 512), (10240, 256), (640, 1024), (10, 512)]
BN_RAGGED = [(n, C) for n in (1, 7, 10, 1025) for C in (3, 64, 3072)]
# layer_norm's rows at C 768: the lifter's five row counts and a grouped
# 10 x 10 step's; ragged ones, one wider than a lane keeps in registers
LN_PATH = [(r, 768) for r in (8 * 1025, 8 * 1024, 8 * 16, 8 * 1041, 8,
                              100 * 1025)]
LN_RAGGED = ([(r, c) for r in (1, 7, 513) for c in (3, 100, 640)]
             + [(130, 2056)])


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n,C", BN_PATH + BN_RAGGED)
def test_bn_stats_plan_covers_once_in_one_launch(n, C, itemsize):
    for aligned in (True, False):
        cfg = bn.launch_config(n, C, itemsize, aligned)
        vec, tiles, blocks = cfg["vec"], cfg["tiles"], cfg["blocks"]
        width = 8 * vec
        assert cfg["launches"] == 1
        assert vec == (16 // itemsize if aligned and C % (16 // itemsize)
                       == 0 else 1)
        # every channel in one tile, no tile empty
        assert tiles * width >= C > (tiles - 1) * width
        # every row in one run of whole 256-row batches, no run empty
        rpb = cfg["rows_per_block"]
        assert rpb % 256 == 0
        assert blocks * rpb >= n > (blocks - 1) * rpb
        # more than one run a tile needs the barrier: all blocks resident
        per_sm = cfg["blocks_per_sm"]
        assert blocks == 1 or tiles * blocks <= per_sm * SMS
        assert 0 < cfg["smem"] <= MAX_SMEM
        assert cfg["smem"] * per_sm <= MAX_SMEM
        assert cfg["scratch_floats"] == tiles * blocks * 2 * width
        assert cfg["counters"] == 2 * tiles


def test_bn_stats_plan_fills_the_card_at_the_stem():
    """The stem's [625,000, 64] bf16: one tile of 64 channels cut into as
    many runs of whole batches as three resident blocks an SM allow, each
    with 32 KB of reads in flight."""
    cfg = bn.launch_config(625000, 64, 2, True)
    assert (cfg["vec"], cfg["tiles"]) == (8, 1)
    assert 3 * SMS - 60 < cfg["blocks"] <= 3 * SMS
    assert cfg["rows_per_block"] == 7 * 256
    assert cfg["smem"] == 8 * 2 * 64 * 4 + 256 * 16


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rows,C", LN_PATH + LN_RAGGED)
def test_layer_norm_bwd_plan_covers_once_in_one_launch(rows, C, itemsize):
    for aligned in (True, False):
        cfg = ln.launch_config(rows, C, itemsize, aligned)
        vec, nv, blocks = cfg["vec"], cfg["nv"], cfg["blocks"]
        assert cfg["launches"] == 1
        assert cfg["cached"] == (C <= 1024)
        if cfg["cached"]:
            # a lane's vectors cover the row; the 16-byte paths keep no
            # vector slot that lies wholly past C
            assert nv * 32 * vec >= C
            assert vec == 1 or (nv - 1) * 32 * vec < C
        else:
            assert nv == 0
        rpb = cfg["rows_per_block"]
        assert blocks * rpb >= rows > (blocks - 1) * rpb
        assert blocks <= cfg["blocks_per_sm"] * SMS
        assert cfg["blocks_per_sm"] == (2 if vec == 8 and nv <= 3 else 1)
        assert 0 < cfg["smem"] * cfg["blocks_per_sm"] <= MAX_SMEM
        width = 2 * (-(-C // 4) * 4)
        assert cfg["scratch_floats"] == blocks * width * (
            1 if cfg["cached"] else 9)
        assert cfg["counters"] == 2


def test_layer_norm_bwd_plan_at_the_lifter():
    """8,200 rows of 768 bf16: three 16-byte vectors a lane, two blocks of
    eight warps on each SM, every block a run of 32 rows (four a warp)."""
    cfg = ln.launch_config(8200, 768, 2, True)
    assert (cfg["vec"], cfg["nv"], cfg["blocks_per_sm"]) == (8, 3, 2)
    assert cfg["rows_per_block"] == 32 and cfg["blocks"] == 257
    cfg = ln.launch_config(100 * 1025, 768, 2, True)
    assert cfg["blocks"] == 2 * SMS


def test_layer_norm_forward_reads_its_plan():
    """The forward takes vec and cached from a plan of its own."""
    cfg = ln.fwd_launch_config(7, 100, 4, True)
    assert (cfg["vec"], cfg["cached"]) == (4, 1)
    cfg = ln.fwd_launch_config(7, 2056, 2, False)
    assert (cfg["vec"], cfg["cached"]) == (1, 0)


# the forward's shapes in chip_smoke.py: the lifter's row counts and a
# grouped 10 x 10 step's at C 768, and the ragged ones
CHIP_LN_SHAPES = ([(r, ROW_WIDTH) for r in ROW_COUNTS] + CHIP_LN_RAGGED
                  + [(TRAIN_ROWS, ROW_WIDTH)])


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rows,C", CHIP_LN_SHAPES)
def test_layer_norm_fwd_plan_owns_every_row_once(rows, C, itemsize):
    """One launch of at most the resident blocks; warp g of the grid's W
    takes rows g, g + W, ... (the ring hands block b the groups of eight
    rows b, b + blocks, ..., warp w row w of each: the same walk), so every
    row has exactly one warp, no warp takes more than ``rows_per_warp`` and
    no block is without a row. The ring's stages fit the SM's shared
    memory at the blocks an SM it is built for."""
    for aligned in (True, False):
        cfg = ln.fwd_launch_config(rows, C, itemsize, aligned)
        vec, nv, blocks = cfg["vec"], cfg["nv"], cfg["blocks"]
        assert cfg["launches"] == 1
        assert vec == (16 // itemsize if aligned and C % (16 // itemsize)
                       == 0 else 1)
        assert cfg["cached"] == (vec > 1 and C <= 1024)
        per_sm = cfg["blocks_per_sm"]
        if cfg["cached"]:
            assert nv * 32 * vec >= C > (nv - 1) * 32 * vec
            assert per_sm == (2 if nv * (4 + 2 * vec) <= 64 else 1)
            assert cfg["threads"] == 9 * 32 and cfg["stages"] == 4
            assert cfg["smem"] == cfg["stages"] * 8 * C * itemsize
            assert cfg["smem"] * per_sm <= MAX_SMEM
        else:
            assert nv == cfg["stages"] == cfg["smem"] == 0
            assert (per_sm, cfg["threads"]) == (2, 256)
        assert 1 <= blocks <= per_sm * SMS
        assert (blocks - 1) * 8 < rows
        warps = blocks * 8
        owners = np.zeros(rows, dtype=np.int64)
        for g in range(warps):
            owners[g::warps] += 1
        assert (owners == 1).all()
        assert max(len(range(g, rows, warps)) for g in range(warps)) \
            == cfg["rows_per_warp"]


def test_layer_norm_fwd_plan_is_the_shapes_alone():
    """The plan is a function of (rows, C, itemsize, aligned) and nothing
    else: the same in any order of calls, so a shape's sums are taken in
    the same order from run to run."""
    keys = [(rows, C, itemsize, al) for rows, C in CHIP_LN_SHAPES
            for itemsize in (2, 4) for al in (True, False)]
    first = [ln.fwd_launch_config(*k) for k in keys]
    again = [ln.fwd_launch_config(*k) for k in reversed(keys)][::-1]
    assert first == again


def test_layer_norm_fwd_plan_at_the_lifter():
    """8,200 rows of 768: the ring, bf16 with three 16-byte vectors a lane
    and two blocks an SM on all 132 SMs, four rows a warp; fp32 six vectors
    and one block an SM. Either way four stages of eight rows: 96 KB of
    reads in flight an SM."""
    cfg = ln.fwd_launch_config(8200, 768, 2, True)
    assert (cfg["vec"], cfg["nv"], cfg["blocks_per_sm"]) == (8, 3, 2)
    assert (cfg["blocks"], cfg["rows_per_warp"]) == (2 * SMS, 4)
    assert cfg["smem"] * cfg["blocks_per_sm"] == 96 << 10
    cfg = ln.fwd_launch_config(8200, 768, 4, True)
    assert (cfg["vec"], cfg["nv"], cfg["blocks_per_sm"]) == (4, 6, 1)
    assert (cfg["blocks"], cfg["rows_per_warp"]) == (SMS, 8)
    assert cfg["smem"] * cfg["blocks_per_sm"] == 96 << 10
    cfg = ln.fwd_launch_config(TRAIN_ROWS, 768, 2, True)
    assert (cfg["blocks"], cfg["rows_per_warp"]) == (2 * SMS, 49)

"""The plain reference against the port at a tiny size on the CPU: the
first three optimizer steps of each lifter, both sides in float64 from the benchmark's own weights and inputs, so
that what is left is the order of sums. The same comparison at the cells'
own sizes is every benchmark run's check; the ``cuda`` cases run a short
benchmark run of each cell on the card.

    python -m pytest perfbench/tests -q"""

import pytest
import torch

from perfbench.harness import cell
from perfbench.kinds import train as kt
from perfbench.tests.tiny import tiny_spec

TRAIN = ["cnn.train.b10x10", "vit.train.b10x10"]
SEED = 2**31 + 12345


@pytest.mark.parametrize("name", TRAIN)
def test_three_training_steps_match_the_port(name):
    spec = tiny_spec(name, compute="float64")
    dev = torch.device("cpu")
    t = kt.Trainer(spec["config"], spec["traffic"], SEED, dev)
    prog = t.check_steps()
    t.free()
    ref = kt.reference(spec["config"], spec["traffic"], t.leaves, SEED,
                       t.pool, dev, t.dtype, dtype=torch.float64)
    r = kt.readings(prog, ref)
    # the program reports its loss in fp32: 1e-7 of it; the first gradient
    # sits ~1e-6 from the reference's (the heatmaps' fp32 arithmetic);
    # AdamW's first steps turn that into ~3e-5 on the changes
    assert r["loss_gap"] < 1e-6
    assert r["grad_gap"] < 1e-5
    assert r["change_gap"] < 2e-4
    assert r["ema_gap"] < 2e-4
    assert r.get("stats_gap", 0.0) < 1e-5
    # the losses move: the steps did something
    assert len(set(ref["losses"])) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN)
def test_a_short_run_of_each_cell_is_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from perfbench.harness import run_cell

    out = run_cell(cell(name), SEED, 3.0, trace=False)
    assert out["correct"], out["checks"]

"""The work counters against what the reference's forward computes:
``torch.utils.flop_counter.FlopCounterMode`` over the plain forward at a
tiny size, and the attention calls the reference makes; and the full-size
counts the benchmark divides by."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import inputs, program
from perfbench.reference import common
from perfbench.reference.steps import make_model
from perfbench.tests.tiny import tiny_spec
from perfbench.work import flops

SEED = 77


def _forward(name, batch=2, watch=None):
    spec = tiny_spec(name)
    cfg = program.reference_config(spec["config"])
    model, _ = program.build(spec["config"], "cpu", train=False)
    sd = inputs.make_weights(program.leaves(model), SEED, "cpu")
    h, w = cfg["image_size"]
    x = (torch.rand(batch, h, w, 3), torch.rand(batch, h, w, 1),
         0.1 + 0.8 * torch.rand(batch, cfg["num_joints"], 2))
    ref = make_model(cfg, sd, common.Precision(), False, common.no_dropout)
    with FlopCounterMode(display=False) as fc:
        ref.forward(*x)
    return cfg, fc.get_total_flops() / batch


@pytest.mark.parametrize("name", ["cnn.train.b10x10", "vit.train.b10x10"])
def test_forward_flops_equal_the_counted_products(name):
    cfg, counted = _forward(name)
    assert flops.forward_flops(cfg) == pytest.approx(counted, rel=1e-9)


def test_attention_calls_are_the_reference_forwards(monkeypatch):
    seen = []
    real = common.attention

    def spy(q, k, v, prec):
        seen.append((q.shape[1], k.shape[1], q.shape[2], q.shape[3]))
        return real(q, k, v, prec)
    import perfbench.reference.vit as vit
    monkeypatch.setattr(vit, "attention", spy)
    cfg, _ = _forward("vit.train.b10x10", batch=1)
    assert seen == flops.vit_attention_calls(cfg)


def test_full_size_counts():
    from perfbench.harness import cell

    cnn = program.reference_config(cell("cnn.train.b10x10")["config"])
    vit = program.reference_config(cell("vit.train.b10x10")["config"])
    # a 10 x 10 step: three forwards of 100 images
    assert 300 * flops.forward_flops(cnn) == pytest.approx(19.0e12, rel=0.1)
    assert 3 * flops.forward_flops(vit) == pytest.approx(1.03e12, rel=0.1)
    calls = flops.vit_attention_calls(vit)
    assert calls.count((1025, 1025, 12, 64)) == 12
    assert calls.count((1041, 1041, 16, 48)) == 4
    w = flops.attention_work(1025, 1025, 12, 64, 8, backward=False)
    assert w["flops"] == pytest.approx(25.8e9, rel=1e-2)
    assert flops.least_seconds(w["flops"], w["bytes"]) == pytest.approx(
        0.0261e-3, rel=1e-2)

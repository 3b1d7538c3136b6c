"""The harness: ``BENCHMARK.json`` against the files it names and the
contract's shapes, the generators' repeatability, the result line, the
check for JAX, and ``correct`` coming out false with the timed path
broken underneath (at a tiny size on the CPU, the look for a card
skipped)."""

import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import harness, inputs
from perfbench.harness import BENCH, ROOT, benchmark, cell, run_cell
from perfbench.tests.tiny import tiny_spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SEED = 3_000_000_017


def test_every_file_is_found_by_name():
    b = benchmark()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in b["workloads"]:
        spec = cell(w["name"], b)
        assert (BENCH / "kinds" / f"{spec['traffic']['kind']}.py").is_file()
        assert spec["limits"]
    for m in b["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}


def test_names_units_and_keys_keep_the_contract():
    b = benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for f in BENCH.rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            assert re.match(r"^[A-Za-z0-9_./\-]+$",
                            str(f.relative_to(ROOT))), f


def test_each_metric_moves_what_its_cells_report():
    b = benchmark()
    cells = [w["name"] for w in b["workloads"]]

    def reported(m):
        return set(m.get("workloads", cells))
    e2e = {m["name"]: reported(m) for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert reported(m) <= e2e[m["moves"]], m["name"]
    for c in cells:
        assert c in e2e["setup_s"]
        assert any(c in v for k, v in e2e.items() if k != "setup_s")
        assert any(c in reported(m) for m in b["per_layer"])


def test_the_generators_repeat_from_the_seed():
    spec = tiny_spec("cnn.train.b10x10")
    cfg = spec["config"]
    a = inputs.train_pool(cfg, 2, 2, 3, SEED, "cpu")
    b = inputs.train_pool(cfg, 2, 2, 3, SEED, "cpu")
    c = inputs.train_pool(cfg, 2, 2, 3, SEED + 1, "cpu")
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["image"], c["image"])
    spec_w = [("a.weight", (4, 3), torch.float32),
              ("a.bias", (4,), torch.float32),
              ("n.running_var", (4,), torch.float32)]
    w1, w2 = (inputs.make_weights(spec_w, 2**40 + 3, "cpu") for _ in range(2))
    assert torch.equal(w1["a.weight"], w2["a.weight"])
    assert torch.equal(w1["n.running_var"], torch.ones(4))
    assert torch.equal(w1["a.bias"], torch.zeros(4))


@pytest.mark.parametrize("name,trace", [("cnn.train.b10x10", True),
                                        ("vit.train.b10x10", False)])
def test_the_result_line_has_the_contract_keys(name, trace):
    out = run_cell(tiny_spec(name, limit=1e-2), SEED, 1.0, trace, "cpu")
    out.pop("_notes")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in out["metrics"]
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_the_jax_check_compares_whole_names(monkeypatch):
    assert "pose3d_tpu" not in harness.forbidden_modules()
    import pose3d_tpu_torch.models  # noqa: F401
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    monkeypatch.setitem(sys.modules, "pose3d_tpu", object())
    assert harness.forbidden_modules() == ["jaxlib", "pose3d_tpu"]


def test_without_a_card_or_the_program_no_result_is_printed(tmp_path):
    """On a machine without a card, and in a directory holding only
    BENCHMARK.json and the benchmark's files, a run exits non-zero and
    prints no result line."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for root in (ROOT, tmp_path):
        p = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload",
             "cnn.train.b10x10", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=root, capture_output=True, text=True,
            timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "CUDA_VISIBLE_DEVICES": ""})
        assert p.returncode != 0 and p.stdout.strip() == ""


# the faults a cell can have, planted in the program underneath the run


def _unchanged_state(monkeypatch):
    import pose3d_tpu_torch.train.step as step
    monkeypatch.setattr(step, "_apply_update",
                        lambda state, ema_decay, batch=None: None)


def _half_batch(monkeypatch):
    import pose3d_tpu_torch.train.step as step
    real = step._forward_loss

    def half(model, micro, *a, **k):
        n = micro["image"].shape[0] // 2
        return real(model, {key: v[:n] for key, v in micro.items()}, *a, **k)
    monkeypatch.setattr(step, "_forward_loss", half)


def _unchanged_ema(monkeypatch):
    """The optimizer steps; the EMA is never updated."""
    import pose3d_tpu_torch.train.step as step
    real = step._apply_update
    monkeypatch.setattr(step, "_apply_update",
                        lambda state, ema_decay, batch=None:
                        real(state, None, batch))


def _ema_every_other_step(monkeypatch):
    """The EMA updated after the second step only, of the first three."""
    import pose3d_tpu_torch.train.step as step
    real = step._apply_update

    def update(state, ema_decay, batch=None):
        real(state, ema_decay if state.step % 2 else None, batch)
    monkeypatch.setattr(step, "_apply_update", update)


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in ("cnn.train.b10x10", "vit.train.b10x10")
    for fault in (None, _unchanged_state, _half_batch, _unchanged_ema,
                  _ema_every_other_step)])
def test_a_broken_timed_path_reads_not_correct(monkeypatch, name, fault):
    """The cells' own limits, the program in fp32 on the CPU; a sound run
    passes, each fault fails."""
    spec = tiny_spec(name)
    spec["limits"] = cell(name)["limits"]
    if fault is not None:
        fault(monkeypatch)
    out = run_cell(spec, SEED, 1.0, False, "cpu")
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("name", ["cnn.train.b10x10", "vit.train.b10x10"])
def test_the_training_control_reads_not_correct(name):
    """The control, the reference with fp8 operands put in the program's
    place, against the cell's own limits at a tiny size (on the card it is
    read at the cell's size by ``perfbench/calibrate.py``)."""
    from perfbench.kinds import train as kt

    spec = tiny_spec(name)
    limits = cell(name)["limits"]
    dev = torch.device("cpu")
    t = kt.Trainer(spec["config"], spec["traffic"], SEED, dev)
    t.free()
    ref = kt.reference(spec["config"], spec["traffic"], t.leaves, SEED,
                       t.pool, dev, t.dtype)
    ctl = kt.reference(spec["config"], spec["traffic"], t.leaves, SEED,
                       t.pool, dev, t.dtype, precision="fp8")
    r = kt.readings(kt.as_program(ctl), ref)
    assert any(r[k] > v for k, v in limits.items()), (r, limits)

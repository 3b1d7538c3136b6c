"""``scripts/torch_lifecycle_e2e.py`` on the CPU for the CNN, run to its
summary in a process of its own: the port's CLIs chained (train, SIGTERM
and a graceful save, ``--checkpoint auto`` resume bit for bit equal to an
uninterrupted control, ``cli.evaluate --per-action``, ``cli.export --ema``
against the live model, ``serve_http --artifact`` answering ``/predict``);
and the pieces it holds a resumed run with: the state's arrays, their L2
distance and the launch reports of its child processes."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "torch_lifecycle_e2e.py"


def _module():
    spec = importlib.util.spec_from_file_location("torch_lifecycle_e2e",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _failure(out) -> str:
    """A failed run's output: from the first stack dump of a child that
    ran out of time, where there is one, else the tails."""
    dump = out.stdout.find("Timeout (")
    head = out.stdout[dump:dump + 12000] if dump >= 0 else out.stdout[-3000:]
    return head + out.stderr[-3000:]


def test_cnn_lifecycle_on_the_cpu(tmp_path):
    """Every stage passes and the summary holds: the SIGTERM checkpoint
    before the final step 6, the resumed run bitwise the control over
    every array of the state, the artifact and the server bitwise the live
    model on the CPU (one program, one device), no kernel launched (the
    CPU runs the plain versions)."""
    out = subprocess.run(
        [sys.executable, str(SCRIPT), "--device", "cpu", "--workdir",
         str(tmp_path)], cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, _failure(out)
    line = [x for x in out.stdout.splitlines() if x.startswith("LIFECYCLE ")]
    s = json.loads(line[-1][len("LIFECYCLE "):])
    assert s["model_type"] == "cnn" and s["device"] == "cpu"
    # the signal lands after step 3's line; the step in flight may be 4
    assert 3 <= s["sigterm_checkpoint_step"] < 6
    assert s["resume_bit_exact"] and s["resume_l2_to_control"] == 0.0
    assert s["compared_arrays"] > 100
    assert s["update_l2_after_sigterm"] > 0
    assert np.isfinite(s["eval_mpjpe_mm"])
    assert s["export_bit_identical"] and s["export_rel_l2"] == 0.0, (
        "the artifact's answers differ from the live model's by max |d| "
        f"{s.get('export_max_abs_diff')}; both are kept in "
        f"{s.get('export_mismatch_npz')}")
    assert s["serve_roundtrip"] and s["serve_bit_identical"]
    assert set(s["launches"]) == {
        "flash_attention_fwd", "flash_attention_bwd", "bn_stats",
        "lane_resample", "layer_norm_fwd", "layer_norm_bwd",
        "mlp_block_fwd", "mlp_block_bwd"}
    assert not any(s["launches"].values())
    assert (tmp_path / "eval.json").is_file()
    assert json.loads((tmp_path / "eval.json").read_text())["per_action"]


def test_state_distance_and_launch_reports(tmp_path):
    """``state_arrays`` flattens a checkpoint's tensors (nested dicts and
    lists, scalars too), ``l2_distance`` sums the floating ones' squared
    differences, and ``Launches`` adds what each child process reported."""
    lc = _module()
    tree = {"step": 2, "model": {"w": torch.ones(2, 2),
                                 "n": torch.tensor([3])},
            "optimizer": {"state": {0: {"exp_avg": torch.zeros(3)}},
                          "param_groups": [{"lr": 1e-3}]}}
    other = {**tree, "model": {"w": torch.full((2, 2), 2.0),
                               "n": torch.tensor([4])}}
    for name, t in (("a", tree), ("b", other)):
        (tmp_path / name).mkdir()
        torch.save(t, tmp_path / name / "state.pt")
    a, b = lc.state_arrays(tmp_path / "a"), lc.state_arrays(tmp_path / "b")
    assert set(a) == {".step", ".model.w", ".model.n",
                      ".optimizer.state.0.exp_avg",
                      ".optimizer.param_groups[0].lr"}
    assert lc.l2_distance(a, b) == 2.0       # the four elements of w, by 1
    assert lc.l2_distance(a, a) == 0.0
    launches = lc.Launches()
    for n in (2, 3):
        launches.add("noise\n" + lc.LAUNCH_MARK + json.dumps(
            {"lane_resample": n, "bn_stats": 0}) + "\nmore")
    assert launches.total == {"lane_resample": 5, "bn_stats": 0}


def test_a_child_out_of_time_names_its_frames(tmp_path, monkeypatch,
                                              capsys):
    """A CLI process of the script that is still running near its
    timeout writes every thread's stack to its output; the run kills it
    at the timeout, prints the stacks and fails: a hang names its
    frames."""
    lc = _module()
    (tmp_path / "hang_here.py").write_text(
        "import time\n\n\ndef wait_forever():\n    time.sleep(600)\n\n\n"
        "wait_forever()\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.setattr(lc, "CHILD_TIMEOUT", 20)
    monkeypatch.setattr(lc, "DUMP_BEFORE_KILL", 10)
    with pytest.raises(SystemExit, match="hang_here exceeded 20"):
        lc.run(lc.module_cmd("hang_here"), tmp_path, lc.Launches())
    shown = capsys.readouterr().out
    assert "Timeout (0:00:10)" in shown
    assert "wait_forever" in shown and "hang_here.py" in shown


def _data_threads():
    import threading

    return [t for t in threading.enumerate() if t.is_alive() and (
        t.name.endswith("(feeder)") or t.name.endswith("(_worker)"))]


def test_closing_a_looping_loader_stops_its_threads(tmp_path):
    """F14: a training loader (``loop=True``) abandoned after its first
    batch, as ``train_model`` leaves it after the last step: closing its
    iterator waits for the feeder thread, which closes the dataset's
    iterator and so the chunk prefetcher's decode thread. Before, both
    daemon threads outlived the loop, and a process that exited while the
    decode thread was inside cv2 aborted (exit -6 after a finished
    ``cli.main`` on the card's host, which decodes through cv2)."""
    from helpers_synthetic import make_synthetic_chunk

    from pose3d_tpu_torch.data.pipeline import BatchLoader, \
        StreamingChunkedDataset

    for i in range(3):
        make_synthetic_chunk(tmp_path / "chunks", i, num_samples=40,
                             image_hw=(24, 24), prefix="train")
    before = _data_threads()
    ds = StreamingChunkedDataset("train", tmp_path / "chunks",
                                 image_size=(24, 24),
                                 cache_dir=tmp_path / "cache")
    it = iter(BatchLoader(ds, batch_size=4, loop=True))
    assert next(it)["image"].shape == (4, 24, 24, 3)
    assert len(_data_threads()) > len(before)     # feeder and prefetcher
    it.close()
    assert _data_threads() == before

"""Multi-process training of pose3d_tpu_torch on gloo ranks (spawned
processes without JAX): the eval step on two ranks splits a ragged batch
unevenly and gives the one-process metrics (rtol 1e-5); ``train_model`` on
two ranks validates on the whole validation stream on both (the
one-process averages), writes TensorBoard scalars and checkpoints from
process 0 alone, stops both ranks at one step when one rank sees the stop,
and a run resumed from that checkpoint ends bitwise equal to an
uninterrupted one, replicated or with the state sharded by FSDP (a
one-process checkpoint shards again); an FSDP run's checkpoint, gathered
by both ranks and written by process 0, loads into a one-process state;
``cli.main --coordinator … --num-processes 2 --process-id i`` trains on the
committed chunk fixture; ``dryrun_multichip(4)`` runs every leg."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_dist import child_env, free_port, run_ranks, wait_all
from torch_port_helpers import FIXTURE_DIR, inputs

from pose3d_tpu_torch.core.config import CNNModelConfig
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.parallel.dryrun import dryrun_multichip
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train import loop as tloop
from pose3d_tpu_torch.train import step as tstep
from pose3d_tpu_torch.train.state import create_train_state

TINY_CNN = dict(
    image_size=(50, 50), heatmap_size=50, initial_channels=8,
    stage_channels=(16, 32, 64), stage_depths=(1, 1, 1),
    global_pool_size=2, global_feature_dim=32, regression_dims=(32,),
    regression_dropout=0.0,
)
STEPS = 4


def _batches(rank, n=STEPS + 2):
    rng = np.random.default_rng(100 + rank)
    out = []
    for i in range(n):
        img, depth, kpt = inputs(1000 * rank + i, 4, hw=50)
        out.append({"image": img, "depth": depth, "keypoints_2d": kpt,
                    "joints_3d": rng.normal(scale=0.5, size=(4, 17, 3))
                    .astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def job():
    model = build_model(CNNModelConfig(**TINY_CNN), device="cpu",
                        dtype=torch.float32,
                        generator=torch.Generator().manual_seed(6))
    return dict(scenario="loop", model_type="cnn", cfg=TINY_CNN,
                state_dict=model.state_dict(), lr=1e-3, ema=False,
                batches=[_batches(0), _batches(1)], num_steps=STEPS,
                eval_every=2, val=_val())


class _Tags:
    def __init__(self):
        self.tags = {}

    def add_scalar(self, tag, value, step):
        self.tags.setdefault(tag, []).append((step, float(value)))

    def add_image(self, *a, **k):
        pass

    def flush(self):
        pass


def _val():
    """A validation stream of 4 + 3 samples (a ragged last batch)."""
    return [{k: v[:n] for k, v in b.items()}
            for b, n in zip(_batches(7, 2), (4, 3))]


def _model(job):
    model = build_model(CNNModelConfig(**TINY_CNN), device="cpu",
                        dtype=torch.float32)
    model.load_state_dict(job["state_dict"])
    return model


def test_eval_step_on_two_ranks_splits_a_ragged_batch(job, tmp_path):
    a, b = _batches(9, 2)
    batch = {k: np.concatenate([a[k], b[k][:1]]) for k in a}   # 5 rows
    want, out = tstep.make_eval_step()(create_train_state(_model(job)),
                                       tloop.to_device(batch, "cpu"))
    res = run_ranks(tmp_path, 2, **dict(job, scenario="eval", batch=batch))
    for r in res:
        assert r["out"].shape == out.shape == (5, 17, 3)
        np.testing.assert_allclose(r["out"].numpy(), out.numpy(), rtol=1e-5,
                                   atol=1e-6)
        for k, v in want.items():
            assert r["metrics"][k].shape == (5,)
            np.testing.assert_allclose(r["metrics"][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_two_ranks_gate_writes_stop_together_and_resume_bitwise(job,
                                                                 tmp_path):
    full = run_ranks(tmp_path, 2, **job, cwd=str(tmp_path / "full"))
    assert [r["last"] for r in full] == [STEPS, STEPS]
    assert full[0]["scalars"] > 0 and full[1]["scalars"] == 0
    # the validations at steps 2 and 4 average the whole stream, as one
    # process trained on both ranks' rows does
    state = create_train_state(_model(job), 1e-3)
    both = [{k: np.concatenate([a[k], b[k]]) for k in a}
            for a, b in zip(*job["batches"])]
    rec = _Tags()
    tloop.train_model(state, both, _val(), writer=rec, num_steps=STEPS,
                      eval_interval_steps=2,
                      generator=torch.Generator().manual_seed(42))
    tag = "Metrics/MPJPE_validation_epoch_avg"
    got, want = full[0]["tags"][tag], rec.tags[tag]
    assert [s for s, _ in got] == [s for s, _ in want] == [2, 4]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-4)
    assert any("ck_cnn_step_4" in f for f in full[0]["files"])
    assert full[1]["files"] == []            # process 1 wrote nothing
    for k, v in full[0]["params"].items():
        assert torch.equal(v, full[1]["params"][k]), k

    # a stop that rank 1 alone sees stops both ranks at one step
    stopped = run_ranks(tmp_path, 2, **job, cwd=str(tmp_path / "stop"),
                        stop_rank_after=(1, 2))
    last = stopped[0]["last"]
    assert stopped[1]["last"] == last == 2
    assert stopped[1]["files"] == []
    saved = tmp_path / "stop" / "rank0" / f"ck_cnn_step_{last}"
    assert (saved / "meta.json").exists()

    rest = [b[last:] for b in job["batches"]]
    for strategy in ("replicated", "fsdp"):
        resumed = run_ranks(
            tmp_path, 2, **dict(job, batches=rest),
            cwd=str(tmp_path / f"resume_{strategy}"), resume=str(saved),
            strategy=strategy)
        assert [r["last"] for r in resumed] == [STEPS, STEPS]
        for k, v in full[0]["params"].items():
            assert torch.equal(resumed[0]["params"][k], v), (strategy, k)


def test_fsdp_checkpoint_of_two_ranks_loads_in_one_process(job, tmp_path):
    res = run_ranks(tmp_path, 2, **dict(job, num_steps=2),
                    cwd=str(tmp_path / "fsdp"), strategy="fsdp")
    assert res[1]["files"] == []
    path = tmp_path / "fsdp" / "rank0" / "ck_cnn_step_2"
    model = build_model(CNNModelConfig(**TINY_CNN), device="cpu",
                        dtype=torch.float32)
    state = create_train_state(model)
    ckpt.restore_train_state(state, path)
    assert state.step == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, res[0]["params"][k]), k
    for p in state.trainable():
        assert state.optimizer.state[p]["exp_avg"].shape == p.shape


def test_cli_main_on_two_processes(tmp_path):
    port = free_port()
    argv = ["--chunks-dir", str(FIXTURE_DIR), "--device", "cpu",
            "--model-type", "cnn", "--model-args", json.dumps(TINY_CNN),
            "--batch-size", "2", "--grad-accum", "1", "--num-steps", "2",
            "--eval-interval", "2", "--log-interval", "1",
            "--no-tensorboard", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pose3d_tpu_torch.cli.main", *argv,
         "--process-id", str(i)], cwd=tmp_path, env=child_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    logs = wait_all(procs, 120, "cli.main")
    assert "Collectives warm: 2 devices across 2 hosts" in logs[0]
    assert "Training complete at step 2" in logs[1]
    saved = [p for p in Path(tmp_path).iterdir()
             if p.name.endswith("_cnn_step_2")]
    assert len(saved) == 1 and (saved[0] / "meta.json").exists()


def test_dryrun_multichip_four_ranks():
    line = dryrun_multichip(4, timeout=120)
    assert line.startswith("dryrun_multichip(4): train loss ")
    for leg in ("eval MPJPE", "fsdp loss", "hybrid(2x2) fsdp loss",
                "tp(2x2) loss", "tp+sp loss", "pp(2x2) loss"):
        assert leg in line
    assert line.endswith("— OK")

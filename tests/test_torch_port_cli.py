"""pose3d_tpu_torch's training and evaluation CLIs on synthetic chunks, on
the CPU (``--device cpu``): a run stopped by SIGTERM and resumed with
``--checkpoint auto`` equals an uninterrupted one bit for bit;
``cli.evaluate`` of a reference-schema ``.pth`` gives the MPJPE and
PA-MPJPE of ``pose3d_tpu.cli.evaluate`` on the same ``.pth`` and chunks
(both in fp32); TensorBoard, the profiler window and the memory report
from the command line; flags of features not ported yet are refused, and
``--device cuda`` raises without a card."""

import functools
import json
import os
import signal
import sys

import numpy as np
import pytest
import torch

from helpers_synthetic import make_synthetic_chunk

from pose3d_tpu_torch.checkpoint import save_pose_model
from pose3d_tpu_torch.cli import evaluate as port_eval, main as port_main
from pose3d_tpu_torch.core.config import CNNModelConfig, GlobalConfig
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.train import checkpoint as ckpt, loop

TINY_CNN = dict(
    image_size=[32, 32], heatmap_size=32, heatmap_sigma=2.0,
    stage_channels=[8, 16, 32], stage_depths=[1, 1, 1], initial_channels=8,
    global_pool_size=2, global_feature_dim=16, regression_dims=[16],
)
PREFIX = GlobalConfig().checkpoint_prefix


@pytest.fixture(scope="module")
def chunks_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("chunks")
    for i in range(2):
        make_synthetic_chunk(d, i, num_samples=7, image_hw=(40, 48), seed=2,
                             num_actions=3)
    make_synthetic_chunk(d, 4, num_samples=6, image_hw=(40, 48),
                         prefix="test", seed=3, num_actions=2)
    return d


def _argv(chunks_dir, *extra, steps=6):
    return ["--chunks-dir", str(chunks_dir), "--device", "cpu",
            "--model-type", "cnn", "--model-args", json.dumps(TINY_CNN),
            "--batch-size", "2", "--grad-accum", "2", "--num-steps",
            str(steps), "--eval-interval", "2", "--log-interval", "1",
            "--augment-device", "--augment-device-rotation",
            "--ema-decay", "0.9", "--lr-schedule", "cosine",
            "--warmup-steps", "2", "--schedule-steps", "10",
            "--clip-grad-norm", "5",
            "--checkpoint", "auto", *extra]


def _sigterm_after(monkeypatch, step):
    """SIGTERM to this process right after the checkpoint of ``step`` is
    written: the CLI's handler asks ``train_model`` to stop, as a
    preemption would."""
    real = ckpt.save_checkpoint

    def save(path, *a, **kw):
        out = real(path, *a, **kw)
        if str(path).endswith(f"_step_{step}"):
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(ckpt, "save_checkpoint", save)


def test_stopped_and_resumed_run_equals_an_uninterrupted_one(
        chunks_dir, tmp_path, monkeypatch):
    """Six steps in one run, against a run SIGTERM stops after its step-4
    checkpoint and the same command line resumes (``--checkpoint auto``):
    the state after step 6 (model, AdamW, schedule, EMA) and the data
    position are bit for bit equal; the SIGTERM handler is restored after
    each run."""
    argv = _argv(chunks_dir, "--no-tensorboard")
    before = signal.getsignal(signal.SIGTERM)
    for name in ("full", "part"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "full")
    assert port_main.main(argv) == 6
    monkeypatch.chdir(tmp_path / "part")
    with monkeypatch.context() as m:
        _sigterm_after(m, 4)
        assert port_main.main(argv) == 4
    assert signal.getsignal(signal.SIGTERM) == before
    assert ckpt.latest_checkpoint(PREFIX, "cnn").name \
        == f"{PREFIX}_cnn_step_4"
    assert port_main.main(argv) == 6
    trees = [ckpt.load_checkpoint(tmp_path / name / f"{PREFIX}_cnn_step_6")
             for name in ("full", "part")]
    (a, meta_a), (b, meta_b) = trees
    assert meta_a["data_state"] == meta_b["data_state"]
    assert meta_a["data_state"]["epoch"] >= 1

    def equal(x, y):
        if isinstance(x, dict):
            return set(x) == set(y) and all(equal(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(map(equal, x, y))
        if torch.is_tensor(x):
            return torch.equal(x, y)
        return x == y

    assert equal(a, b)
    for name in ("full", "part"):
        assert (tmp_path / name / f"{PREFIX}_cnn_best.json").is_file()


def test_cli_evaluate_matches_the_jax_cli(chunks_dir, tmp_path, monkeypatch):
    """One reference-schema ``.pth`` of the tiny CNN (BatchNorm statistics
    moved off 0 and 1) through ``pose3d_tpu.cli.evaluate`` and through the
    port's ``cli.evaluate``, both computing in fp32 and with
    ``--per-action``: the same MPJPE, PA-MPJPE and per-action numbers to
    1e-4, and the same printed keys."""
    from pose3d_tpu.cli import evaluate as jax_eval
    from pose3d_tpu.models import factory as jfactory
    import jax.numpy as jnp

    cfg = CNNModelConfig(**{**TINY_CNN, "image_size": (32, 32),
                            "stage_channels": (8, 16, 32),
                            "stage_depths": (1, 1, 1),
                            "regression_dims": (16,)})
    model = build_model(cfg, device="cpu", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for n, b in model.named_buffers():
            if n.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.05)
            elif n.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) * 0.5 + 0.7)
    pth = tmp_path / "tiny.pth"
    save_pose_model(model, pth, step=7)
    common = ["--chunks-dir", str(chunks_dir), "--batch-size", "4",
              "--per-action", "--compat-pa-metric"]
    monkeypatch.setattr(jfactory, "build_model", functools.partial(
        jfactory.build_model, dtype=jnp.float32))
    want = jax_eval.main(["--checkpoint", str(pth), "--cache-dir",
                          str(tmp_path / "jc"), *common])
    monkeypatch.setattr(port_eval, "GlobalConfig", functools.partial(
        GlobalConfig, compute_dtype="float32"))
    got = port_eval.main(["--checkpoint", str(pth), "--device", "cpu",
                          "--json", str(tmp_path / "m.json"), *common])
    assert set(got) == set(want)
    assert json.loads((tmp_path / "m.json").read_text()) == got
    assert got["checkpoint_step"] == want["checkpoint_step"] == 7
    np.testing.assert_allclose([got["mpjpe"], got["pa_mpjpe"]],
                               [want["mpjpe"], want["pa_mpjpe"]], rtol=1e-4)
    assert set(got["per_action"]) == set(want["per_action"]) == {"2", "3"}
    for a, m in want["per_action"].items():
        assert got["per_action"][a]["count"] == m["count"]
        np.testing.assert_allclose(
            [got["per_action"][a]["mpjpe"], got["per_action"][a]["pa_mpjpe"]],
            [m["mpjpe"], m["pa_mpjpe"]], rtol=1e-4)


def test_tensorboard_profile_and_memory_report(chunks_dir, tmp_path,
                                               monkeypatch, caplog):
    """With TensorBoard on, the run writes event files under the config's
    log directory; ``--profile-steps 1 --profile-at 1`` writes a
    ``torch.profiler`` trace of step 2 there; ``--memory-report`` says on
    the CPU that there is no card to report on. ``cli.evaluate --ema`` of
    the checkpoint evaluates its EMA weights."""
    pytest.importorskip("tensorboard")
    monkeypatch.chdir(tmp_path)
    with caplog.at_level("INFO"):
        port_main.main(_argv(chunks_dir, "--profile-steps", "1",
                             "--profile-at", "1", "--memory-report",
                             steps=2))
    runs = list((tmp_path / "logs").iterdir())
    assert len(runs) == 1
    assert list(runs[0].glob("events.out.tfevents.*"))
    assert list(runs[0].glob("*.pt.trace.json"))
    assert "Train-step memory: memory report unavailable (no card)" \
        in caplog.text
    out = port_eval.main(["--checkpoint", f"{PREFIX}_cnn_step_2", "--ema",
                          "--chunks-dir", str(chunks_dir), "--device", "cpu"])
    assert np.isfinite(out["mpjpe"]) and out["checkpoint_step"] == 2


def test_summary_writer_needs_a_tensorboard_package(tmp_path, monkeypatch):
    from pose3d_tpu_torch.train import tb

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with pytest.raises(ImportError, match="--no-tensorboard"):
        tb.SummaryWriter(tmp_path)


@pytest.mark.parametrize("flag", [
    ["--vit-weights", "vit.pth"], ["--param-sharding", "fsdp"],
    ["--multislice"], ["--coordinator", "localhost:1234"],
    ["--num-processes", "2"], ["--process-id", "0"],
])
def test_flags_not_ported_are_refused(chunks_dir, flag, capsys, tmp_path,
                                      monkeypatch):
    """Each flag is refused before anything is trained or logged: the
    parallelism flags with ROADMAP.md named; ``--vit-weights``, ported,
    is accepted and meets the JAX CLI's check that it applies to the
    transformer only (these arguments train the CNN; the transformer's
    case: ``test_torch_port_stage1_cli.py``)."""
    monkeypatch.chdir(tmp_path)
    if flag[0] == "--vit-weights":
        with pytest.raises(SystemExit, match="only applies to the "
                                             "transformer"):
            port_main.main(_argv(chunks_dir, *flag))
        assert list(tmp_path.iterdir()) == []
        return
    with pytest.raises(SystemExit) as e:
        port_main.main(_argv(chunks_dir, *flag))
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert flag[0] in err and "ROADMAP.md" in err
    assert list(tmp_path.iterdir()) == []       # nothing trained or logged


def test_transformer_remat_and_rotation_alone_are_refused(
        chunks_dir, capsys, tmp_path, monkeypatch):
    """The transformer's ``--remat`` is ported: one step of a small
    transformer from the CLI runs with every encoder and fusion block
    rematerialised and writes its checkpoint. Device rotation without
    ``--augment-device`` is still refused."""
    from pose3d_tpu_torch.models import transformer

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        port_main.main(["--chunks-dir", str(chunks_dir), "--device", "cpu",
                        "--augment-device-rotation"])
    assert "requires --augment-device" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []
    calls = []
    real = transformer.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(transformer, "checkpoint", counted)
    tiny = dict(image_size=[32, 32], heatmap_size=32, heatmap_patch_size=16,
                transformer_embed_dim=32, transformer_heads=2, vit_depth=1,
                vit_heads=2, final_encoder_depth=1, num_cross_modal_layers=1,
                regression_hidden_dims=[16])
    port_main.main(["--chunks-dir", str(chunks_dir), "--device", "cpu",
                    "--model-type", "transformer", "--model-args",
                    json.dumps(tiny), "--remat", "--batch-size", "2",
                    "--grad-accum", "2", "--num-steps", "1",
                    "--eval-interval", "100", "--no-tensorboard"])
    assert len(calls) == 3              # 1 ViT + 1 fusion + 1 final block
    meta = ckpt.load_checkpoint_meta(tmp_path / f"{PREFIX}_transformer_step_1")
    assert meta["step"] == 1 and meta["model_type"] == "transformer"


def test_device_cuda_raises_without_a_card(chunks_dir, tmp_path):
    """Both CLIs default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main.main(["--chunks-dir", str(chunks_dir)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_eval.main(["--checkpoint", str(tmp_path),
                        "--chunks-dir", str(chunks_dir)])


def test_ema_needs_an_ema_checkpoint(chunks_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = [a for a in _argv(chunks_dir, "--no-tensorboard", steps=2)]
    i = argv.index("--ema-decay")
    port_main.main(argv[:i] + argv[i + 2:])
    with pytest.raises(SystemExit, match="no EMA"):
        port_eval.main(["--checkpoint", f"{PREFIX}_cnn_step_2", "--ema",
                        "--chunks-dir", str(chunks_dir), "--device", "cpu"])
    assert loop.ema_pth_path("a/b.pth").name == "b_ema.pth"


def test_plots_match_jax():
    """``visualize_3d_pose`` (with a NaN pose too) and
    ``visualize_comparison`` render the JAX package's images pixel for
    pixel."""
    pytest.importorskip("matplotlib")
    from pose3d_tpu.viz import plots as jplots
    from pose3d_tpu_torch.viz import plots

    rng = np.random.default_rng(0)
    joints = rng.normal(size=(17, 3))
    bad = joints.copy()
    bad[3, 1] = np.nan
    image = rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)
    for args, fn in (((joints,), "visualize_3d_pose"),
                     ((bad,), "visualize_3d_pose"),
                     ((image, joints, bad), "visualize_comparison")):
        imgs = []
        for mod in (plots, jplots):
            fig = getattr(mod, fn)(*args, title="t")
            imgs.append(np.asarray(mod.fig_to_image(fig)))
            plots.pyplot().close(fig)
        assert imgs[0].shape[2] == 3
        np.testing.assert_array_equal(imgs[0], imgs[1])


def test_step_timer_matches_jax(monkeypatch):
    """``StepTimer`` leaves its warmup steps out of the EMA and reports the
    JAX package's scalars on the same clock."""
    from pose3d_tpu.utils import profiling as jprof
    from pose3d_tpu_torch.utils import profiling

    ticks = iter(np.cumsum([0.0, 0.5, 0.1, 0.2, 0.1, 0.3, 0.1, 0.25] * 2))
    monkeypatch.setattr("time.perf_counter", lambda: float(next(ticks)))
    out = []
    for mod in (profiling, jprof):
        t = mod.StepTimer(alpha=0.5, warmup=1)
        assert t.scalars(10) == {}
        for _ in range(4):
            t.start()
            t.stop()
        out.append(t.scalars(10))
    assert out[0] == out[1] and out[0]["Perf/step_time_ms"] > 0

"""The port's measurement scripts with ``--device cpu`` at tiny sizes, each
run to its JSON line (``torch_serve_bench``, ``torch_loader_bench``,
``torch_stage1_bench --tiny``, ``torch_profile_step`` in its three CNN and
transformer configurations, ``torch_e2e_train_run``); without a card and
without ``--device cpu`` each that drives the card refuses to run; and no
script of the port imports JAX, flax or the JAX package."""

import ast
import importlib.util
import json
from pathlib import Path

import pytest
import torch

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
PORT_SCRIPTS = sorted(p.stem for p in SCRIPTS.glob("torch_*.py"))

TINY_CNN = json.dumps({
    "image_size": [32, 32], "heatmap_size": 32, "initial_channels": 8,
    "stage_channels": [8, 16, 32], "stage_depths": [1, 1, 1],
    "global_pool_size": 2, "global_feature_dim": 16,
    "regression_dims": [16]})
TINY_VIT = json.dumps({
    "image_size": [32, 32], "heatmap_size": 32, "heatmap_patch_size": 16,
    "transformer_embed_dim": 32, "transformer_heads": 2, "vit_depth": 1,
    "vit_heads": 2, "final_encoder_depth": 1, "num_cross_modal_layers": 1,
    "regression_hidden_dims": [16]})
# argv that reach each script's first use of the device
CARD_ARGV = {
    "torch_overfit_demo": [],
    "torch_quantize_accuracy": ["missing_checkpoint"],
    "torch_lifecycle_e2e": [],
    "torch_serve_bench": [],
    "torch_stage1_bench": [],
    "torch_profile_step": ["cnn"],
    "torch_e2e_train_run": [],
    "torch_startup_split": [],
}


def _script(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_the_scripts_are_the_ones_named():
    assert set(PORT_SCRIPTS) == set(CARD_ARGV) | {"torch_loader_bench"}


@pytest.mark.parametrize("name", PORT_SCRIPTS)
def test_script_imports_nothing_of_jax(name):
    """Every import statement of the script, and the code it hands a child
    process, names the port, the standard library, numpy, cv2, torch or the
    JAX-free chunk writer of the tests; never jax, flax or pose3d_tpu."""
    def imported(source):
        out = set()
        for node in ast.walk(ast.parse(source)):
            if isinstance(node, ast.Import):
                out |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                out.add(node.module)
        return out

    mods = imported((SCRIPTS / f"{name}.py").read_text())
    for value in vars(_script(name)).values():
        if isinstance(value, str) and value.startswith("import "):
            mods |= imported(value)      # code run in a child process
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "pose3d_tpu", "optax"}, mods
    assert "pose3d_tpu_torch" in tops


@pytest.mark.parametrize("name", sorted(CARD_ARGV))
def test_script_needs_the_card_unless_told_cpu(name):
    """Without ``--device cpu`` a script that drives the card raises before
    doing any work when there is none: no quiet run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _script(name).main(CARD_ARGV[name])


def test_serve_bench_on_the_cpu(capsys):
    out = _script("torch_serve_bench").main(
        ["--device", "cpu", "--batch", "2", "--calls", "2", "--reps", "1",
         "--model-args", TINY_CNN])
    assert _json_line(capsys) == json.loads(json.dumps(out))
    assert out["card"] == "cpu" and out["timing"] == "host clock"
    assert out["live_ms"] > 0 and out["artifact_ms"] > 0
    assert out["artifact_mb"] > 0 and out["batch"] == 2


def test_loader_bench(capsys):
    out = _script("torch_loader_bench").main(
        ["--samples", "4", "--size", "32", "--reps", "1"])
    assert _json_line(capsys)["route"] == out["route"]
    assert out["route"] in ("native", "cv2")
    for mode in ("extract", "stream", "stream-py", "stream-u8"):
        assert out[f"{mode}_samples_per_sec"] > 0


def test_stage1_bench_on_the_cpu(capsys):
    out = _script("torch_stage1_bench").main(
        ["--tiny", "--device", "cpu", "--reps", "1", "--yolo-batch", "1",
         "--depth-batch", "1"])
    assert _json_line(capsys)["card"] == "cpu"
    for net in ("yolo", "depthpro"):
        for backend in ("xla", "pallas"):
            assert out[net][f"{backend}_ms"] > 0
            assert out[net][f"{backend}_launches"] == 0   # the plain version


@pytest.mark.parametrize("argv", [
    ["cnn10", "--batch", "4", "--accum", "2", "--model-args", TINY_CNN],
    ["cnn10", "--normalization", "batch_pallas", "--batch", "4", "--accum",
     "2", "--model-args", TINY_CNN],
    ["vit", "--batch", "2", "--model-args", TINY_VIT],
], ids=["cnn10", "cnn10-batch_pallas", "vit"])
def test_profile_step_on_the_cpu(argv, capsys):
    """One profiled step split into categories (on the CPU: the operators'
    own time); the grouped CNN's BatchNorm Function and the scan CNN's
    marked BatchNorm passes both land in "batchnorm elementwise", the
    AdamW step in "optimizer"."""
    out = _script("torch_profile_step").main(
        [*argv, "--device", "cpu", "--warmup", "1"])
    assert _json_line(capsys)["config"] == argv[0]
    cats = out["categories"]
    assert out["device_ms"] == pytest.approx(sum(v["ms"] for v in
                                                 cats.values()))
    assert cats["optimizer"]["ms"] > 0
    if argv[0] == "cnn10":
        assert out["accum_mode"] == ("scan" if "batch_pallas" in argv
                                     else "grouped")
        assert cats["batchnorm elementwise"]["ms"] > 0
        assert cats["convolution"]["ms"] > 0
    else:
        assert cats["matmul (cuBLAS)"]["ms"] > 0


def test_e2e_train_run_on_the_cpu(capsys):
    out = _script("torch_e2e_train_run").main(
        ["--device", "cpu", "--steps", "4", "--warmup-steps", "1",
         "--samples", "8", "--chunks", "1", "--size", "32", "--batch-size",
         "4", "--grad-accum", "2", "--model-args", TINY_CNN])
    assert _json_line(capsys)["steps"] == 4
    assert out["steady_steps"] == 2 and out["steady_images_per_sec"] > 0
    assert out["first_loss"] > 0 and out["last_loss"] > 0

"""``pose3d_tpu_torch.cli.doctor`` on the CPU, the port's console scripts
and its installable package: the doctor's report with ``--device cpu
--probe`` (every section, the eight kernels with their library paths,
``nvcc`` reported missing rather than raised, ``cli()`` returning 0, and in
a process of its own nothing of JAX or the JAX package imported); without a
card and without ``--device cpu``, ``--probe`` exits nonzero; every header
a kernel source includes ships as package data; each ``pose3d_tpu_torch.``
console script resolves, answers ``--help`` with 0, and returns 0 from a
real run through its wrapper."""

import fnmatch
import json
import os
import re
import subprocess
import sys
from importlib.metadata import entry_points
from pathlib import Path

import pytest
import torch

from helpers_synthetic import make_synthetic_chunk
from test_torch_port_chunk_tools import _make_raw_h36m

from pose3d_tpu_torch.checkpoint import save_pose_model
from pose3d_tpu_torch.cli import chunker, convert, doctor, export, \
    rechunker, split
from pose3d_tpu_torch.core.config import CNNModelConfig
from pose3d_tpu_torch.models import build_model
from pose3d_tpu_torch.ops.kernels import _build

ROOT = Path(__file__).resolve().parent.parent
PYPROJECT = ROOT / "pyproject.toml"
KERNELS = ("bn_stats", "flash_attention_bwd", "flash_attention_fwd",
           "lane_resample", "layer_norm_bwd", "layer_norm_fwd",
           "mlp_block_bwd", "mlp_block_fwd")
SECTIONS = ("versions", "devices", "toolchain", "kernels", "install",
            "probe", "warnings")


def _nvcc_missing() -> bool:
    try:
        _build._nvcc()
    except RuntimeError:
        return True
    return False


def test_doctor_reports_every_section_on_the_cpu(tmp_path):
    """``--device cpu --probe --json``: every section, in the report
    returned and in the JSON written; the eight kernels listed with the
    library path ``_build`` would load; the host named as what was
    probed; without the toolkit, ``nvcc`` reported missing, each library's
    load reported failed, none raised; ``cli`` returns 0."""
    out = tmp_path / "doctor.json"
    rep = doctor.main(["--device", "cpu", "--probe", "--json", str(out)])
    assert tuple(rep) == SECTIONS
    assert json.loads(out.read_text())["versions"]["torch"] == \
        torch.__version__
    assert {"python", "torch", "torch_cuda", "cudnn", "nccl", "numpy",
            "cv2"} <= set(rep["versions"])
    assert rep["devices"]["requested"] == "cpu"
    assert "note" in rep["devices"] and "error" not in rep["devices"]
    assert doctor.kernel_names() == list(KERNELS)
    for name in KERNELS:
        entry = rep["kernels"][name]
        assert entry["library_path"] == str(_build.library_path(name))
        assert entry["built"] == _build.library_path(name).is_file()
    assert rep["kernels"]["build_dir"] == str(_build.BUILD_DIR)
    assert isinstance(rep["kernels"]["build_dir_writable"], bool)
    tool = rep["toolchain"]
    assert tool["decode_route"] in ("native", "cv2")
    assert rep["probe"]["probed_device"] == "cpu (host)"
    assert rep["probe"]["matmul_tflops_fp32_host"] > 0
    assert rep["probe"]["host_decode_route"] == tool["decode_route"]
    assert rep["probe"]["host_decode_imgs_per_sec"] > 0
    installed = [ep.name for ep in entry_points(group="console_scripts")
                 if ep.value.startswith("pose3d_tpu_torch.")]
    assert rep["install"]["console_scripts_expected"] == len(installed)
    if not installed:
        assert "not installed" in rep["install"]["console_scripts_note"]
        assert any("console scripts unknown" in w for w in rep["warnings"])
    if _nvcc_missing():
        assert tool["nvcc"].startswith("missing")
        assert rep["probe"]["kernels_loaded"] == f"0 of {len(KERNELS)}"
        assert all(rep["probe"][f"kernel_{k}"].startswith("FAILED: nvcc")
                   for k in KERNELS)
        assert any("nvcc not found" in w for w in rep["warnings"])
    assert doctor.cli(["--device", "cpu"]) == 0


def test_doctor_imports_no_jax_in_its_own_process():
    """The doctor's report, in a process of its own, leaves nothing of
    JAX, flax or the JAX package in ``sys.modules``."""
    code = ("import sys, json\n"
            "from pose3d_tpu_torch.cli import doctor\n"
            "doctor.main(['--device', 'cpu'])\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')"
            "[0] in ('jax', 'jaxlib', 'flax', 'pose3d_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_probe_without_a_card_exits_nonzero(tmp_path):
    """With no card and no ``--device cpu`` the devices section says so and
    ``--probe`` exits nonzero, in process and from the shell; without
    ``--probe`` the report is still produced."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the probe has one to probe")
    with pytest.raises(SystemExit) as e:
        doctor.main(["--probe", "--json", str(tmp_path / "r.json")])
    assert e.value.code not in (0, None)
    rep = json.loads((tmp_path / "r.json").read_text())
    assert "CUDA is not available" in rep["devices"]["error"]
    assert "probe" not in rep
    assert "no CUDA device visible" in rep["warnings"]
    assert doctor.main([])["devices"]["device_count"] == 0
    out = subprocess.run(
        [sys.executable, "-m", "pose3d_tpu_torch.cli.doctor", "--probe"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(ROOT)},
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "--device cpu" in out.stderr


def _package_data() -> list:
    text = PYPROJECT.read_text()
    section = text.split("[tool.setuptools.package-data]", 1)[1]
    line = next(x for x in section.splitlines()
                if x.startswith("pose3d_tpu_torch"))
    return re.findall(r'"([^"]+)"', line)


def test_every_included_header_ships_as_package_data():
    """Each ``#include "…"`` of a kernel source (and of the headers) names
    a file of ``csrc`` that a ``[tool.setuptools.package-data]`` glob
    ships, so an installed package builds every kernel; and every kernel
    source ships."""
    globs = _package_data()
    csrc = ROOT / "pose3d_tpu_torch" / "csrc"
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    included = set()
    for src in sources:
        assert any(fnmatch.fnmatch(f"csrc/{src.name}", g) for g in globs), src
        included |= set(re.findall(r'#include "([^"]+)"', src.read_text()))
    assert {"row_reduce.cuh", "hopper_mma.cuh", "flash_attention_common.cuh",
            "layer_norm_common.cuh", "mlp_block_common.cuh"} <= included
    for name in included:
        assert (csrc / name).is_file(), name
        assert any(fnmatch.fnmatch(f"csrc/{name}", g) for g in globs), name


def _scripts() -> dict:
    section = PYPROJECT.read_text().split("[project.scripts]", 1)[1]
    section = section.split("[", 1)[0]
    return dict(re.findall(r'(\S+)\s*=\s*"([\w.:]+)"', section))


def test_console_scripts_mirror_the_jax_ones():
    """Eleven ``pose3d-torch-*`` entries, one for each ``pose3d-*`` entry of
    the JAX package, on the port's module of the same name; each resolves
    and answers ``--help`` with 0."""
    scripts = _scripts()
    jax_names = {k for k, v in scripts.items() if v.startswith("pose3d_tpu.")}
    port = {k: v for k, v in scripts.items()
            if v.startswith("pose3d_tpu_torch.")}
    assert len(port) == 11
    assert set(port) == {n.replace("pose3d-", "pose3d-torch-")
                         for n in jax_names}
    for name, target in port.items():
        jax_target = scripts[name.replace("pose3d-torch-", "pose3d-")]
        assert target.split(":")[0].replace("pose3d_tpu_torch.", "") == \
            jax_target.split(":")[0].replace("pose3d_tpu.", ""), name
        module, func = target.split(":")
        fn = getattr(__import__(module, fromlist=[func]), func)
        with pytest.raises(SystemExit) as e:
            fn(["--help"])
        assert e.value.code == 0, name


def test_wrappers_return_zero_from_real_runs(tmp_path):
    """The wrappers whose ``main`` returns a value (an artifact path, a
    sample count, the split's counters) return 0 from real runs, as the
    console-script wrapper ``sys.exit(target())`` needs; ``main`` keeps its
    value. ``cli.convert`` (its ``main`` is the entry) returns 0 too."""
    cfg = CNNModelConfig(image_size=(32, 32), heatmap_size=32,
                         stage_channels=(8, 16, 32), stage_depths=(1, 1, 1),
                         initial_channels=8, global_pool_size=2,
                         global_feature_dim=16, regression_dims=(16,))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    pth = save_pose_model(model, tmp_path / "m.pth", step=3)
    assert export.cli(["--checkpoint", str(pth), "--output",
                       str(tmp_path / "art"), "--device", "cpu",
                       "--batch-size", "2"]) == 0
    assert (tmp_path / "art" / "model.pt2").is_file()
    assert isinstance(export.main(["--checkpoint", str(pth), "--output",
                                   str(tmp_path / "art2"), "--device",
                                   "cpu"]), str)
    assert convert.main([str(pth), str(tmp_path / "ckpt")]) == 0

    raw = tmp_path / "raw"
    _make_raw_h36m(raw, subjects=(1, 5), frames_per_subject=2)
    assert chunker.cli(["--subjects", "1", "5", "--output",
                        str(tmp_path / "chunks"), "--chunk-size", "2",
                        "--annotations-path", str(raw / "annotations"),
                        "--images-path", str(raw / "images"),
                        "--processed-path", str(raw / "processed")]) == 0
    assert split.cli(["--input-dir", str(tmp_path / "chunks"),
                      "--output-dir", str(tmp_path / "split"),
                      "--train-subjects", "1", "--test-subjects", "5",
                      "--new-chunk-size", "2"]) == 0
    assert rechunker.cli(["--input-dir", str(tmp_path / "split" / "train"),
                          "--output-dir", str(tmp_path / "shuf"),
                          "--chunk-size", "2"]) == 0
    make_synthetic_chunk(tmp_path / "more", 0, num_samples=3,
                         image_hw=(16, 16), prefix="train")
    assert rechunker.main(["--input-dir", str(tmp_path / "more" / "train"),
                           "--output-dir", str(tmp_path / "shuf2")]) == 3

"""One-run full-lifecycle acceptance of the PyTorch/CUDA port on the card
(counterpart of ``scripts/lifecycle_e2e.py``).

Chains what the test suite proves piecewise, through the port's command-line
entry points (``python -m pose3d_tpu_torch.cli.*`` and ``serve_http``), each
in its own process, on synthetic chunks (``tests/helpers_synthetic.py``):

  1. train  — grouped ghost-BN accumulation, EMA, cosine LR, device
     augmentation with rotation (the ``lane_resample`` kernel);
  2. SIGTERM after step 3 → graceful checkpoint-and-exit (rc 0);
  3. ``--checkpoint auto`` restart → resumes the SIGTERM checkpoint and
     finishes; an uninterrupted control run to the same step. Both families
     must come out bit for bit equal (parameters, EMA, BatchNorm statistics,
     AdamW moments, schedule). The attention backward sums dQ by atomic adds
     across 64-key blocks in no fixed order, but every attention of the tiny
     transformer has at most 21 keys: one block, one add for each element
     of dQ, so its runs repeat bit for bit on the card too;
  4. ``cli.evaluate --per-action`` on the final checkpoint;
  5. ``cli.export --ema`` → the artifact against the live model on the same
     batch (relative L2 within the bound the export phase of
     ``chip_smoke.py`` holds artifacts to; where the two are not bitwise
     equal, both answers and their max |Δ| are kept in
     ``export_mismatch.npz`` in the working directory, named in the
     summary);
  6. ``serve_http --artifact`` round trip (npz over HTTP) answering what
     the artifact answers.

The control run goes beside the interrupted one, 4 beside 5, and the
server's start-up beside the artifact's own answer, each CLI in its own
process and working directory. The tiny configs of the JAX script
(``MODEL_ARGS``); the transformer's
embed 64 over 4 heads gives head depth 16, on the attention kernels' WMMA
(bf16) and scalar (fp32) paths. Each CLI process reports its kernel
launches at exit; the summary sums them. Prints one line ``LIFECYCLE
{json}`` and exits nonzero on any failed stage.

Each CLI process is killed after :data:`CHILD_TIMEOUT` seconds, the run
then failing; :data:`DUMP_BEFORE_KILL` seconds before, the process writes
every thread's stack to its output, which the run prints.

Runs on the card unless ``--device cpu`` is given:
  python scripts/torch_lifecycle_e2e.py [--model-type cnn|transformer]
      [--workdir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import queue
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# The JAX script's tiny configs: the lifecycle exercises the CLIs and the
# runtime plumbing, not model capacity.
MODEL_ARGS = {
    "cnn": json.dumps({
        "image_size": [64, 64], "heatmap_size": 64, "heatmap_sigma": 2.0,
        "stage_channels": [8, 16, 32], "stage_depths": [1, 1, 1],
        "initial_channels": 8, "global_pool_size": 2,
        "global_feature_dim": 16, "regression_dims": [16],
    }),
    "transformer": json.dumps({
        "image_size": [64, 64], "heatmap_size": 32,
        "heatmap_patch_size": 16, "heatmap_sigma": 2.0,
        "transformer_embed_dim": 64, "transformer_heads": 4,
        "vit_depth": 2, "vit_heads": 4, "final_encoder_depth": 1,
        "num_cross_modal_layers": 1, "regression_hidden_dims": [32],
    }),
}

INTERRUPT_AFTER_STEP = 3
FINAL_STEP = 6
EXPORT_BATCH = 4
# the artifact against the live model: relative L2, the bound chip_smoke.py
# holds every artifact of the export phase to
TOL_EXPORT_REL_L2 = 2e-2
LAUNCH_MARK = "KERNEL_LAUNCHES "

# Runs a module of the port as ``python -m`` does, and prints its kernels'
# launch counts when the process exits (a graceful SIGTERM stop included).
# A process still running ``sys.argv[1]`` seconds after its start writes
# every thread's stack to its output (which the caller shows when it kills
# it): a hang names its frames.
_RUN_MODULE = """\
import atexit, faulthandler, json, runpy, sys
faulthandler.dump_traceback_later(float(sys.argv[1]), exit=False)
from pose3d_tpu_torch.ops.kernels import launch_counts
atexit.register(lambda: print(%r + json.dumps(launch_counts()), flush=True))
module = sys.argv[2]
sys.argv = [module] + sys.argv[3:]
runpy.run_module(module, run_name="__main__", alter_sys=True)
""" % LAUNCH_MARK
# seconds a CLI process may run before it is killed (the whole run takes
# 35-64 s on the CPU; under the 240 s that the on-card check gives the
# script), and how long before that its stacks are written
CHILD_TIMEOUT = 200
DUMP_BEFORE_KILL = 20


def require(ok, message: str) -> None:
    """A stage's check: the run stops with ``message`` when it fails."""
    if not ok:
        raise SystemExit(f"lifecycle check failed: {message}")


def child_env() -> dict:
    """The environment of every child process: this checkout first on the
    import path, installed or not, and two CPU threads for PyTorch's
    operators unless the caller set a count (up to four of the processes
    run at once, each with little host work)."""
    path = os.environ.get("PYTHONPATH")
    return {"OMP_NUM_THREADS": "2", **os.environ,
            "PYTHONPATH": str(REPO) + (os.pathsep + path if path else "")}


def module_cmd(module: str, *args) -> list:
    """``module`` with ``args`` in a child that dumps its stacks
    :data:`DUMP_BEFORE_KILL` seconds before :data:`CHILD_TIMEOUT`."""
    return [sys.executable, "-c", _RUN_MODULE,
            str(CHILD_TIMEOUT - DUMP_BEFORE_KILL), module, *map(str, args)]


def train_cmd(chunks, cache, num_steps, model_type, device) -> list:
    return module_cmd(
        "pose3d_tpu_torch.cli.main",
        "--chunks-dir", chunks, "--train-chunks", 0, 1, "--val-chunks", 0,
        "--cache-dir", cache, "--model-type", model_type,
        "--model-args", MODEL_ARGS[model_type],
        "--num-steps", num_steps, "--batch-size", 4,
        "--grad-accum", 2, "--accum-mode", "grouped",
        "--ema-decay", 0.999,
        "--lr-schedule", "cosine", "--schedule-steps", FINAL_STEP,
        "--warmup-steps", 1,
        "--augment-device", "--augment-device-rotation",
        "--eval-interval", FINAL_STEP, "--log-interval", 1,
        "--checkpoint", "auto", "--no-tensorboard", "--device", device)


def _iter_lines_deadline(stream, deadline):
    """Lines of ``stream`` until EOF or the deadline: a pump thread feeds a
    queue, so a child that hangs with its pipe open fails the run instead
    of blocking it."""
    q = queue.Queue()

    def pump():
        for line in stream:
            q.put(line)
        q.put(None)

    threading.Thread(target=pump, daemon=True).start()
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError("deadline exceeded reading child output")
        try:
            line = q.get(timeout=min(remaining, 5.0))
        except queue.Empty:
            continue
        if line is None:
            return
        yield line


class Launches:
    """The kernel launches that the CLI processes report, summed (from
    the threads that run them)."""

    def __init__(self):
        self.total: dict = {}
        self._lock = threading.Lock()

    def add(self, out: str) -> None:
        with self._lock:
            for line in out.splitlines():
                if line.startswith(LAUNCH_MARK):
                    for k, v in json.loads(line[len(LAUNCH_MARK):]).items():
                        self.total[k] = self.total.get(k, 0) + v


def run(cmd, cwd, launches: Launches, sigterm_after_step=None):
    """Run a CLI (a :func:`module_cmd`), killed at :data:`CHILD_TIMEOUT`
    seconds with its output's tail and stacks shown; optionally SIGTERM it
    once ``Step N: loss`` appears."""
    timeout = CHILD_TIMEOUT
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=cwd, env=child_env(),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    sent = False
    marker = f"Step {sigterm_after_step}: loss" if sigterm_after_step else None
    try:
        for line in _iter_lines_deadline(proc.stdout,
                                         time.monotonic() + timeout):
            lines.append(line)
            if marker and not sent and marker in line:
                proc.send_signal(signal.SIGTERM)
                sent = True
    except TimeoutError:
        proc.kill()
        out = "".join(lines)
        dump = out.find("Timeout (")     # faulthandler's header
        print(out[-4000:] if dump < 0 else out[max(0, dump - 2000):])
        raise SystemExit(f"{cmd[4]} exceeded {timeout}s — killed")
    rc = proc.wait(timeout=60)
    out = "".join(lines)
    if sigterm_after_step and not sent:
        print(out[-4000:])
        raise SystemExit(f"never saw '{marker}' in train output — cannot "
                         "interrupt")
    if rc != 0:
        print(out[-4000:])
        raise SystemExit(f"{cmd[4]} rc={rc}")
    launches.add(out)
    return out, time.perf_counter() - t0


def state_arrays(ckpt_dir) -> dict:
    """Every tensor of a training checkpoint (model, AdamW state, schedule,
    EMA), flattened to name → numpy."""
    import torch

    tree = torch.load(Path(ckpt_dir) / "state.pt", map_location="cpu",
                      weights_only=True)
    flat = {}

    def walk(prefix, x):
        if isinstance(x, torch.Tensor):
            flat[prefix] = x.detach().float().numpy() if x.is_floating_point() \
                else x.numpy()
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}.{k}", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{prefix}[{i}]", v)
        elif isinstance(x, (int, float)):
            flat[prefix] = np.asarray(x)

    walk("", tree)
    return flat


def l2_distance(a: dict, b: dict) -> float:
    """L2 norm of the difference over every floating array of two states."""
    return float(np.sqrt(sum(
        np.sum((a[k].astype(np.float64) - b[k]) ** 2) for k in a
        if a[k].dtype.kind == "f")))


def _final(run_dir: Path, mt: str) -> Path:
    path = run_dir / f"model_epoch__{mt}_step_{FINAL_STEP}"
    require((path / "meta.json").exists(), f"{path} missing")
    return path


def lifecycle(mt: str, work: Path, device: str) -> dict:
    import torch

    summary = {"workdir": str(work), "model_type": mt, "device": device}
    launches = Launches()
    sys.path.insert(0, str(REPO / "tests"))
    from helpers_synthetic import make_synthetic_dataset

    chunks = work / "chunks"
    if not chunks.exists():
        make_synthetic_dataset(chunks, num_chunks=2, num_samples=16,
                               image_hw=(64, 64), prefix="train")
        make_synthetic_dataset(chunks, num_chunks=1, num_samples=8,
                               image_hw=(64, 64), prefix="test")
    def cmd(run_dir):
        return train_cmd(chunks, run_dir / "cache", FINAL_STEP, mt, device)

    # ---- 1+2: train, SIGTERM after step 3, graceful exit ----------------
    # ---- 3b (beside it): the uninterrupted control run -----------------
    run_a, run_b = work / "run_a", work / "run_b"
    for d in (run_a, run_b):
        d.mkdir(exist_ok=True)
    with ThreadPoolExecutor(2) as ex:
        interrupted = ex.submit(run, cmd(run_a), run_a, launches,
                                sigterm_after_step=INTERRUPT_AFTER_STEP)
        control = ex.submit(run, cmd(run_b), run_b, launches)
        out, dt = interrupted.result()
        control.result()
    require("SIGTERM" in out, "graceful-stop path not taken")
    steps = [int(p.name.rsplit("_", 1)[1])
             for p in run_a.glob(f"model_epoch__{mt}_step_*")]
    require(steps, "no checkpoint after SIGTERM")
    summary["sigterm_checkpoint_step"] = max(steps)
    summary["train_phase1_s"] = dt
    require(max(steps) < FINAL_STEP, "SIGTERM stopped no step early")

    # ---- 3a: auto-resume to completion ---------------------------------
    out, dt = run(cmd(run_a), run_a, launches)
    found = re.search(r"Auto-resume: (\S+)", out)
    require(found and "step_" in found.group(1), "did not auto-resume")
    summary["train_phase2_s"] = dt
    resumed = state_arrays(_final(run_a, mt))
    control = state_arrays(_final(run_b, mt))
    require(set(resumed) == set(control), "state trees differ")
    summary["compared_arrays"] = len(resumed)
    diffs = [k for k in resumed if not np.array_equal(resumed[k], control[k])]
    summary["resume_bit_exact"] = not diffs
    summary["resume_l2_to_control"] = l2_distance(resumed, control)
    first = state_arrays(run_a / f"model_epoch__{mt}_step_"
                         f"{summary['sigterm_checkpoint_step']}")
    summary["update_l2_after_sigterm"] = l2_distance(control, first)
    require(not diffs, f"resume NOT bit-exact: {diffs[:10]}")

    # ---- 4 and 5 side by side: eval --per-action; export --ema, and the
    # live model's answers on a batch meanwhile ---------------------------
    from pose3d_tpu_torch import serve
    from pose3d_tpu_torch.checkpoint import load_pose_model
    from pose3d_tpu_torch.core.config import GlobalConfig

    final = _final(run_a, mt)
    art = work / "artifact"
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(EXPORT_BATCH, 64, 64, 3)).astype(np.float32)
    dep = rng.uniform(1, 8, size=(EXPORT_BATCH, 64, 64, 1)).astype(
        np.float32)
    kp = rng.uniform(0.1, 0.9, size=(EXPORT_BATCH, 17, 2)).astype(np.float32)
    with ThreadPoolExecutor(2) as ex:
        evaluated = ex.submit(run, module_cmd(
            "pose3d_tpu_torch.cli.evaluate", "--checkpoint", final,
            "--chunks-dir", chunks, "--val-chunks", 0, "--cache-dir",
            work / "cache_eval", "--per-action", "--json",
            work / "eval.json", "--device", device), work, launches)
        exported = ex.submit(run, module_cmd(
            "pose3d_tpu_torch.cli.export", "--checkpoint", final, "--output",
            art, "--batch-size", EXPORT_BATCH, "--ema", "--device", device),
            work, launches)
        model, _ = load_pose_model(
            final, device, dtype=getattr(torch, GlobalConfig().compute_dtype),
            ema=True, attention_impl="reference")
        direct = serve.make_serving_fn(model)(img, dep, kp)
        evaluated.result()
        exported.result()
    ev = json.loads((work / "eval.json").read_text())
    summary["eval_mpjpe_mm"] = float(ev["mpjpe"])
    require(ev.get("per_action"), "per-action breakdown missing")

    # ---- 6: serve round trip; 5's artifact answers while it starts -----
    srv = subprocess.Popen(
        [sys.executable, "-m", "pose3d_tpu_torch.serve_http", "--artifact",
         str(art), "--host", "127.0.0.1", "--port", "0"],
        cwd=work, env=child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        via_artifact = serve.make_serving_fn(
            serve.load_exported(art).module())(img, dep, kp)
        rel = float(np.linalg.norm(direct - via_artifact)
                    / max(np.linalg.norm(direct), 1e-12))
        require(rel <= TOL_EXPORT_REL_L2,
                f"artifact deviates from the live model by rel L2 {rel:.3e} "
                f"(bound {TOL_EXPORT_REL_L2})")
        summary["export_rel_l2"] = rel
        summary["export_bit_identical"] = bool(np.array_equal(direct,
                                                              via_artifact))
        if not summary["export_bit_identical"]:
            # keep the evidence: both answers and where they differ most
            diff = np.abs(direct.astype(np.float64) - via_artifact)
            kept = work / "export_mismatch.npz"
            np.savez(kept, direct=direct, artifact=via_artifact,
                     max_abs_diff=diff.max(),
                     argmax=np.unravel_index(diff.argmax(), diff.shape))
            summary["export_mismatch_npz"] = str(kept)
            summary["export_max_abs_diff"] = float(diff.max())
        port = None
        try:
            for line in _iter_lines_deadline(srv.stdout,
                                             time.monotonic() + 300):
                m = re.search(r"serving on \S+:(\d+)", line)
                if m:
                    port = int(m.group(1))
                    break
        except TimeoutError:
            pass
        require(port, "server did not report a port within 300 s")
        buf = io.BytesIO()
        np.savez(buf, image=img, depth=dep, keypoints_2d=kp)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            require(resp.status == 200, f"/predict answered {resp.status}")
            got = np.load(io.BytesIO(resp.read()))["joints_3d"]
        # the same program on the same device in another process
        require(np.allclose(got, via_artifact, atol=1e-6),
                "server output differs from the artifact it serves")
        summary["serve_roundtrip"] = True
        summary["serve_bit_identical"] = bool(np.array_equal(got,
                                                             via_artifact))
    finally:
        srv.terminate()
        try:
            srv.wait(timeout=30)
        except subprocess.TimeoutExpired:
            srv.kill()
    summary["launches"] = launches.total
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", type=str, default=None)
    ap.add_argument("--model-type", choices=("cnn", "transformer"),
                    default="cnn")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from pose3d_tpu_torch.cli.main import resolve_device

    resolve_device(args.device)
    work = Path(args.workdir or tempfile.mkdtemp(prefix="lifecycle_"))
    work.mkdir(parents=True, exist_ok=True)
    summary = lifecycle(args.model_type, work, args.device)
    print("LIFECYCLE " + json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()

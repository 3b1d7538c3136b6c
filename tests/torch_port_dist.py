"""Spawning the ranks of a gloo run of ``pose3d_tpu_torch`` on the CPU for
the multi-process tests: each rank is its own process running
``torch_port_dist_worker.py`` (no JAX there), with one thread, a free
port, and a timeout that fails the test instead of hanging the suite."""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).parent
WORKER = HERE / "torch_port_dist_worker.py"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env() -> dict:
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent), str(HERE), env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    return env


def wait_all(procs, timeout: float, what: str):
    """Wait for every process; kill them all and fail at the timeout or
    at the first that fails."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    for i, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(
                f"{what}: rank {i} exited {p.returncode} "
                f"(timeout {timeout} s)\n{log[-4000:]}")
    return logs


def run_ranks(tmp_path, world: int, timeout: float = 90, **job):
    """Run ``job`` on ``world`` gloo ranks; returns each rank's result."""
    out = Path(tmp_path) / f"ranks_{job['scenario']}_{time.monotonic_ns()}"
    out.mkdir(parents=True)
    job = dict(job, world=world, port=free_port(), out=str(out))
    path = out / "job.pt"
    torch.save(job, path)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(path), str(r)], env=child_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    wait_all(procs, timeout, job["scenario"])
    res = [torch.load(out / f"{r}.pt", weights_only=False)
           for r in range(world)]
    assert not any(r["jax_loaded"] for r in res), "a rank imported JAX"
    return res

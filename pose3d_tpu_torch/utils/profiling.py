"""Profiling and memory reports (counterpart of
``pose3d_tpu/utils/profiling.py``).

* :func:`trace` — a ``torch.profiler`` window (CPU, and CUDA where there
  is a card) written as a Chrome / TensorBoard trace into ``log_dir``
  (``*.pt.trace.json``, read by TensorBoard's profiler plugin or
  ``chrome://tracing``).
* :class:`StepTimer` — wall-clock per-step timing with an EMA.
* :func:`memory_report` / :func:`format_memory_report` — the card's
  allocator counters (``torch.cuda.memory_stats``,
  ``max_memory_allocated``).
* :func:`card_label` / :func:`time_calls` — what the measurement scripts
  write beside every number: the card's name and power limit, and ms a
  call between CUDA events (the host's clock on the CPU).
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Callable, Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block into ``log_dir``; the card is synchronised before
    the window closes, so the trace holds the block's device work."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()


class StepTimer:
    """Exponential-moving-average step timer. The first ``warmup`` steps
    (kernel builds, allocator growth) are left out of the EMA."""

    def __init__(self, alpha: float = 0.1, warmup: int = 3):
        self.alpha = alpha
        self.warmup = warmup
        self._seen = 0
        self.ema_s: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen <= self.warmup:
            return dt
        self.ema_s = (
            dt if self.ema_s is None
            else self.alpha * dt + (1 - self.alpha) * self.ema_s
        )
        return dt

    def scalars(self, batch_size: int) -> Dict[str, float]:
        if self.ema_s is None:
            return {}
        return {
            "Perf/step_time_ms": self.ema_s * 1e3,
            "Perf/images_per_sec": batch_size / self.ema_s,
        }


def memory_report(device) -> Dict[str, float]:
    """Bytes of the card's caching allocator on ``device``: what is
    allocated and reserved now, and their peaks since the last
    ``torch.cuda.reset_peak_memory_stats``; ``{}`` for a device that is
    not a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "allocated_bytes": float(stats.get("allocated_bytes.all.current", 0)),
        "peak_allocated_bytes": float(torch.cuda.max_memory_allocated(device)),
        "reserved_bytes": float(stats.get("reserved_bytes.all.current", 0)),
        "peak_reserved_bytes": float(torch.cuda.max_memory_reserved(device)),
    }


def format_memory_report(report: Dict[str, float]) -> str:
    if not report:
        return "memory report unavailable (no card)"

    def fmt(v: float) -> str:
        return f"{v / 2**30:.2f} GiB" if v >= 2**27 else f"{v / 2**20:.1f} MiB"

    return ", ".join(f"{k.replace('_bytes', '')}={fmt(v)}"
                     for k, v in report.items())


def card_label(device) -> str:
    """``nvidia-smi``'s ``name, power.limit`` of the card ``device`` is
    on (its name alone where ``nvidia-smi`` cannot say), or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or torch.cuda.get_device_name(index)


def time_calls(fn: Callable[[], object], device, iters: int,
               warmup: int = 2) -> float:
    """ms a call of ``fn`` over ``iters`` calls after ``warmup``: between
    two CUDA events on a card (the calls queue on the stream; the events
    read the device's time), on the host's clock otherwise."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters

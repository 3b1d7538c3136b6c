"""Reading a ``torch.profiler`` trace of the card: device time by category,
the busy share of a stretch, and its breakdown.

A kernel is placed by its symbol (the port's hand-written kernels by their
prefixes), else by the operators that launched it: convolutions,
matrix products, the optimizer, BatchNorm (its forward inside the ranges
:func:`mark_batchnorms` opens, and the backward operators autograd links
to those forwards), copies, and the other elementwise work."""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Tuple

# symbol prefixes of the port's hand-written kernels (csrc/*.cu)
KERNEL_PREFIXES = (
    ("attn_fwd", "attention"), ("attn_bwd", "attention"),
    ("bwd_prologue", "attention"), ("bwd_rows", "attention"),
    ("cast_to_bf16", "attention"),
    ("bn_stats", "bn_stats"), ("lane_resample", "lane_resample"),
    ("layer_norm_fwd", "layer_norm"), ("layer_norm_bwd", "layer_norm"),
    ("mlp_fwd", "mlp_block"), ("mlp_bwd", "mlp_block"),
)
CONV_OPS = ("aten::convolution", "aten::_convolution",
            "aten::convolution_backward", "aten::cudnn_convolution")
CONV_WORDS = ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm", "cudnn",
              "winograd")
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
              "aten::linear", "aten::matmul")
MATMUL_WORDS = ("gemm", "nvjet", "cutlass", "xmma")
BN_MARK = "perfbench.batchnorm"


def kernel_module(name: str):
    for prefix, module in KERNEL_PREFIXES:
        if name.startswith(prefix) or f" {prefix}" in name \
                or f"::{prefix}" in name:
            return module
    return None


def mark_batchnorms(model, names=("BatchNorm", "DotStatsBatchNorm")):
    """Open a profiler range around each BatchNorm module's forward;
    returns the hooks' handles (remove them after the trace)."""
    import torch

    open_ranges = []

    def pre(module, args):
        rf = torch.autograd.profiler.record_function(BN_MARK)
        rf.__enter__()
        open_ranges.append(rf)

    def post(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    handles = []
    for m in model.modules():
        if type(m).__name__ in names:
            handles.append(m.register_forward_pre_hook(pre))
            handles.append(m.register_forward_hook(post))
    return handles


def _ancestors(e):
    while e is not None:
        yield e
        e = e.cpu_parent


def categories(events) -> Dict[str, float]:
    """Seconds of device kernels by category over ``prof.events()``."""
    events = list(events)
    bn_seq = set()
    for e in events:
        if e.sequence_nr >= 0 and any(a.name == BN_MARK
                                      for a in _ancestors(e)):
            bn_seq.add(e.sequence_nr)
    by: Dict[str, float] = collections.Counter()
    for e in events:
        for k in e.kernels:
            chain = list(_ancestors(e))
            names = [a.name for a in chain]
            low = k.name.lower()
            module = kernel_module(k.name)
            if module:
                cat = module
            elif k.name.startswith(("Memcpy", "Memset")):
                cat = "copies"
            elif any(n in CONV_OPS for n in names) or any(
                    w in low for w in CONV_WORDS):
                cat = "convolution"
            elif any(n.startswith("Optimizer.") for n in names):
                cat = "optimizer"
            elif any(n == BN_MARK or "BatchNorm" in n for n in names) or any(
                    a.sequence_nr in bn_seq and "Backward" in a.name
                    for a in chain):
                cat = "batchnorm"
            elif any(n in MATMUL_OPS for n in names) or any(
                    w in low for w in MATMUL_WORDS):
                cat = "matmul"
            else:
                cat = "elementwise"
            by[cat] += k.duration / 1e6
    return dict(by)


def raw(prof) -> Tuple[List[tuple], List[tuple]]:
    """(kernels, host ops) of a trace as (name, start_ns, end_ns)."""
    kernels, host = [], []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type())
        item = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if dev.endswith("CUDA"):
            # a range on the device's timeline is not an operation
            if not (e.is_user_annotation() or e.name() == BN_MARK):
                kernels.append(item)
        elif dev.endswith("CPU"):
            host.append(item)
    return kernels, host


def busy_seconds(kernels: List[tuple], lo: int, hi: int) -> float:
    """Seconds of [lo, hi] in which some device operation ran."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in kernels
                   if e > lo and s < hi)
    total, end = 0, lo
    for s, e in spans:
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e9


def breakdown(kernels: List[tuple], host: List[tuple], lo: int, hi: int,
              top: int = 10) -> dict:
    """The device operations that took most time in [lo, hi], and the
    idle time summed by the innermost host operation running in the middle
    of each gap."""
    by = collections.Counter()
    for name, s, e in kernels:
        if e > lo and s < hi:
            by[name[:160]] += (min(e, hi) - max(s, lo)) / 1e9
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in kernels
                   if e > lo and s < hi)
    gaps, end = [], lo
    for s, e in spans:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if end < hi:
        gaps.append((end, hi))
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle = collections.Counter()
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid)
        # the innermost host operation running at the gap's middle, among
        # the few hundred that started last before it
        inner = [h for h in host[max(0, i - 300):i] if h[2] >= mid]
        name = min(inner, key=lambda h: h[2] - h[1])[0] if inner \
            else "(no host operation)"
        idle[name[:160]] += (g1 - g0) / 1e9
    return {"device_ops": [[n, v] for n, v in by.most_common(top)],
            "idle_gaps": [[n, v] for n, v in idle.most_common(top)]}

"""The training step's share of the card's bf16 peak: three forwards'
analytic FLOPs (no recompute) for every image the window trained, over the
window's host seconds × 989 TFLOP/s."""

from perfbench.work.flops import PEAK_BF16_FLOPS, forward_flops


def read(trace):
    if trace.get("kind") != "train":
        return None
    flops = 3.0 * forward_flops(trace["model"]) * trace["host_window_samples"]
    return 100.0 * flops / trace["host_window_s"] / PEAK_BF16_FLOPS

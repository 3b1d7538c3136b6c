"""The attention kernels' share of their roofline in the traced training
steps: the least time of every attention call the configuration implies
(forward and backward, over the traced steps' samples), over the device
time of the kernels the port's attention launches."""

from perfbench.work.flops import attention_least_seconds


def read(trace):
    cats = trace.get("categories") or {}
    if trace.get("kind") != "train" or not cats.get("attention"):
        return None
    least = attention_least_seconds(trace["model"], trace["traced_samples"],
                                    backward=True)
    return 100.0 * least / cats["attention"]

"""BatchNorm's share of the traced steps' device kernel time: the kernels
launched inside the ranges the benchmark opens around each BatchNorm
forward, and the backward operators autograd links to them."""


def read(trace):
    cats = trace.get("categories") or {}
    if trace.get("kind") != "train" or not cats.get("batchnorm"):
        return None
    return 100.0 * cats["batchnorm"] / sum(cats.values())

"""The allocator's peak over the training window
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(trace):
    if trace.get("kind") != "train" or not trace.get("peak_bytes"):
        return None
    return trace["peak_bytes"] / 2**30

"""The share of the traced stretch in which no operation ran on the
device (1 − the union of kernel intervals over the stretch)."""


def read(trace):
    if trace.get("kind") != "train" or not trace.get("traced_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["traced_s"])

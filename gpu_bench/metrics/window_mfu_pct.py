"""The whole window's share of the chip's peak: the frozen operations of B1
and B2 (``harness/work.py``) in the traced windows over the traced window's
length times the peak rate of the configuration's precision."""

from harness import trace


def read(record):
    w = record["work"]
    window = trace.window_seconds(record["trace"])
    if w is None or window <= 0:
        return None
    ops = (w["b1_ops"] + w["b2_ops"]) * record["n_windows"]
    return 100.0 * ops / (window * record["peaks"]["flops_per_s"][record["precision"]])

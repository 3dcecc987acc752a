"""B1's share of its roofline: the least time the card could take for the
frozen work of the traced windows (``harness/work.py``: operations over the
precision's peak or bytes over the bandwidth, whichever is longer) over
B1's device time."""

from harness import trace, work


def read(record):
    seconds = trace.device_time(record["trace"], trace.is_b1)
    w = record["work"]
    if seconds <= 0 or w is None:
        return None
    n = record["n_windows"]
    least, _ = work.least_seconds(w["b1_ops"] * n, w["b1_bytes"] * n, record["peaks"],
                                  record["precision"])
    return 100.0 * least / seconds

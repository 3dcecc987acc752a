"""B2's share of its roofline, as ``b1_roofline`` reads B1's."""

from harness import trace, work


def read(record):
    seconds = trace.device_time(record["trace"], trace.is_b2)
    w = record["work"]
    if seconds <= 0 or w is None or w["b2_ops"] <= 0:
        return None
    n = record["n_windows"]
    least, _ = work.least_seconds(w["b2_ops"] * n, w["b2_bytes"] * n, record["peaks"],
                                  record["precision"])
    return 100.0 * least / seconds

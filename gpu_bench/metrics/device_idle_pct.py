"""The share of the traced window in which no kernel, copy or set ran on
the device (the union of their intervals)."""

from harness import trace


def read(record):
    window = trace.window_seconds(record["trace"])
    return 100.0 * (1.0 - trace.busy_seconds(record["trace"]) / window) if window > 0 else None

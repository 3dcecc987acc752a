"""B1's device time a window: the summed time of the kernels named
``rk45_kernel`` in the traced window, over its windows."""

from harness import trace


def read(record):
    seconds = trace.device_time(record["trace"], trace.is_b1)
    return seconds / record["n_windows"] * 1e3 if seconds > 0 else None

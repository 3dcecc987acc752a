"""The entry's other device work a window: every kernel, copy and set that
the call of ``solve()`` launched (initial steps, the stiff hand-off's
gathers, the merge, the float64 retry's casts) other than B1 and B2."""

from harness import trace


def _other(name, step):
    return step == "bench.solve" and not trace.is_b1(name) and not trace.is_b2(name)


def read(record):
    seconds = trace.device_time(record["trace"], _other)
    return seconds / record["n_windows"] * 1e3 if seconds > 0 else None

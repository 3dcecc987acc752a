"""The program's host syncs a window: the ``tiger.sync.*`` marks that start
inside the traced windows, over the windows."""

from harness import spans, trace


def read(record):
    rec = record["trace"]
    if not spans.has_program_spans(rec):
        return None
    lo, hi = trace.window_bounds(rec)
    n = sum(1 for s, _, name in rec["host"] if name.startswith("tiger.sync.") and lo <= s <= hi)
    return n / record["n_windows"]

"""The device's idle time before B1 runs, a window: inside the spans of the
entry's input checks and query dedup, its initial steps, and B1's call
(its layout copies and launch)."""

from harness import spans

PHASES = {"tiger.solve.check", "tiger.solve.initial_step", "tiger.solve.b1"}


def read(record):
    return spans.idle_ms_per_window(record, PHASES)

"""The device's idle time after B1's launch, a window: inside the spans of
the stiff hand-off (its sync and gathers), B2's call, the merge, the float64
retry and the queries' reorder."""

from harness import spans

PHASES = {"tiger.solve.handoff", "tiger.solve.b2", "tiger.solve.merge", "tiger.solve.retry",
          "tiger.solve.reorder"}


def read(record):
    return spans.idle_ms_per_window(record, PHASES)

"""The program's own spans in the traced run's record.

``tiger_tpu_torch.profiling.span`` marks the program's blocks in the
profiler's trace while it records: the phases of ``solve()``
(``tiger.solve`` and its children ``tiger.solve.<phase>``) and each host
sync on the card's path (``tiger.sync.<site>``).  They arrive in the
record's ``host`` events on the benchmark's thread, on one clock with the
device's operations.  A program without these spans (an older commit)
reads None.
"""

from __future__ import annotations

import bisect

from harness import trace

PREFIX = "tiger."


def has_program_spans(record: dict) -> bool:
    return any(name.startswith(PREFIX) for _, _, name in record["host"])


def idle_ms_per_window(run: dict, names) -> float | None:
    """The device's idle time inside the spans named ``names`` that lie in
    the traced window (their union, less the device operations clipped to
    it), in ms over the windows."""
    record = run["trace"]
    if not has_program_spans(record):
        return None
    lo, hi = trace.window_bounds(record)
    spans = [(s, e) for s, e, name in record["host"] if name in names and s >= lo and e <= hi]
    busy = trace.merged((s, e) for s, e, _, _ in record["device"])
    starts = [s for s, _ in busy]
    idle = 0.0
    for a, b in trace.merged(spans):
        idle += b - a
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(busy) and busy[i][0] < b:
            idle -= max(0.0, min(busy[i][1], b) - max(busy[i][0], a))
            i += 1
    return idle / run["n_windows"] * 1e-3

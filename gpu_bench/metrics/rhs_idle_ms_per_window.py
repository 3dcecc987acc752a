"""The device's idle time inside the ``tiger.model.rhs`` spans a window: the
model's right-hand side evaluated in eager torch by the initial step
(``solver/controller.py``), once a window, for every model; each span's
length less the device operations inside it (``harness/spans.py``).  None
where no such span lies in the traced window (a program without it)."""

from harness import spans, trace

SPAN = "tiger.model.rhs"


def read(record):
    rec = record["trace"]
    lo, hi = trace.window_bounds(rec)
    if not any(name == SPAN and s >= lo and e <= hi for s, e, name in rec["host"]):
        return None
    return spans.idle_ms_per_window(record, {SPAN})

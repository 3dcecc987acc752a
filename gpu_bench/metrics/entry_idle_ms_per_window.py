"""The device's idle time inside the program's entry a window: over the
``tiger.solve`` spans of the traced windows, each span's length less the
device operations inside it (``harness/spans.py``)."""

from harness import spans


def read(record):
    return spans.idle_ms_per_window(record, {"tiger.solve"})

"""The traced run's record: the profiler's trace reduced to what the
per-layer metrics read.

``torch.profiler`` traces the measured window with the CPU and the CUDA
activities; the benchmark marks its own steps with ``record_function``:
``bench.window`` around each window, and inside it ``bench.draw`` (the
forcing block), ``bench.solve`` (the call of the program's entry) and
``bench.carry`` (the carry and the benchmark's counters).  The trace is
exported as Chrome trace JSON and read back here:

- device operations: events of the categories ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``, each with the benchmark step it was launched in (found
  through its CUDA runtime call's correlation id and that call's time);
- the windows: the ``bench.window`` spans;
- host events (``cpu_op`` and ``user_annotation``), to name idle gaps.

Device times here are the profiler's, on one clock with the host events.
The arithmetic (interval unions, gaps) is plain and is tested on a
synthetic trace.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
STEPS = ("bench.draw", "bench.solve", "bench.carry")
B1_KERNEL = "rk45_kernel"
B2_KERNEL = "radau_kernel"


def union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def reduce_events(events: list) -> dict:
    """The record of a Chrome trace's ``traceEvents`` (times in us)."""
    launches = {}
    steps = {name: [] for name in STEPS}
    windows, host, raw = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        start = float(ev["ts"])
        end = start + float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            raw.append((start, end, name, args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if args.get("correlation") is not None:
                launches[args["correlation"]] = start
        elif cat == "user_annotation" and name == "bench.window":
            windows.append((start, end))
        elif cat == "user_annotation" and name in steps:
            steps[name].append((start, end))
        if cat in HOST_CATS:
            host.append((start, end, name, ev.get("tid")))
    main = {ev.get("tid") for ev in events
            if ev.get("cat") == "user_annotation" and ev.get("name") == "bench.window"}
    # Outer events before inner ones that start with them.
    host = sorted(((s, e, name) for s, e, name, tid in host if tid in main),
                  key=lambda h: (h[0], -h[1]))
    marks = sorted((s, e, name) for name, spans in steps.items() for s, e in spans)
    starts = [m[0] for m in marks]

    def step_of(t):
        i = bisect.bisect_right(starts, t) - 1
        return marks[i][2] if i >= 0 and marks[i][1] >= t else None

    device = [(s, e, name, step_of(launches.get(corr, s))) for s, e, name, corr in raw]
    windows.sort()
    return {"device": device, "windows": windows, "host": host, "marks": marks}


def read_chrome_trace(path) -> dict:
    with open(path) as fh:
        return reduce_events(json.load(fh)["traceEvents"])


def window_bounds(record: dict) -> tuple[float, float]:
    """(start, end) in us of the traced window: its first window to its last."""
    return record["windows"][0][0], record["windows"][-1][1]


def device_time(record: dict, match) -> float:
    """Summed seconds of the device operations ``match(name, step)`` picks
    inside the traced window."""
    lo, hi = window_bounds(record)
    return sum(e - s for s, e, name, step in record["device"]
               if match(name, step) and s >= lo and e <= hi) * 1e-6


def busy_seconds(record: dict) -> float:
    lo, hi = window_bounds(record)
    return union(clip([(s, e) for s, e, _, _ in record["device"]], lo, hi)) * 1e-6


def window_seconds(record: dict) -> float:
    lo, hi = window_bounds(record)
    return (hi - lo) * 1e-6


def is_b1(name: str, step=None) -> bool:
    return B1_KERNEL in name


def is_b2(name: str, step=None) -> bool:
    return B2_KERNEL in name


def _host_context(record: dict, starts: list, t: float) -> str:
    """'step > innermost host event' around time t on the benchmark's thread."""
    host, marks = record["host"], record["marks"]
    j = bisect.bisect_right([m[0] for m in marks], t) - 1
    step = marks[j][2] if j >= 0 and marks[j][1] >= t else "bench.window"
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and host[i][1] < t:
        i -= 1
    inner = host[i][2] if i >= 0 else "no traced host event"
    return step if inner == step else f"{step} > {inner}"


def breakdown(record: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    of the device named by what the host was doing in their middle."""
    lo, hi = window_bounds(record)
    totals: dict = defaultdict(float)
    spans = []
    for s, e, name, _ in record["device"]:
        if s >= lo and e <= hi:
            totals[name[:160]] += (e - s) * 1e-6
            spans.append((s, e))
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    busy = merged(spans)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
            for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    starts = [h[0] for h in record["host"]]
    idle = [[_host_context(record, starts, (a + b) / 2), length * 1e-6]
            for length, a, b in gaps[:top]]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": idle}

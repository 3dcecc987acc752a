"""Metrics: phase timers, the solve's counters, spans, and a profiler trace.

Port of ``Metrics`` and ``trace`` in ``tiger_tpu/profiling.py``.  The solve
counters are reduced on the solve's device and read with one copy to the
host; ``trace`` records ``torch.profiler`` (CPU, and CUDA where there is a
card) into a Chrome trace.

``span(name)`` marks a block of the program in that trace: while a
``torch.profiler`` records, it enters ``record_function(name)``, so the
block lands on the profiler's clock beside the device's kernels, copies and
sets; otherwise it costs one flag check.  The program's spans are named
``tiger.*``: the phases of ``solver.api.solve`` (``tiger.solve.<phase>``),
the model's right-hand side in eager torch inside the initial step
(``tiger.model.rhs``, ``solver.controller._estimate``: once a call of
``initial_step``), the kernel wrappers' layout copies (``tiger.b1.*``,
``tiger.b2.*``), each host sync on the card's path (``tiger.sync.<site>``)
and the windowed run's ``Metrics.span`` kinds (``tiger.run.<kind>``, so
that the run's ``solve`` block, which also holds the carry and the routing,
is not read as ``solve()``'s own ``tiger.solve``).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks the block as ``name`` in a profiler
    trace: ``record_function(name)`` while a ``torch.profiler`` records
    (in any thread: the flag is the process's), else nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return _autograd_profiler.record_function(name)
    return _NO_SPAN


@dataclass
class Metrics:
    phases: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    # (kind, index, start s, end s) on the host clock, from every thread of
    # a windowed run: "window", "load", "solve", "sink" and the device's
    # "device" spans (chunked.solve_chunked), the windowed writers' "write"
    # and "flush" spans (io.output).  Not in the summary.
    spans: List[Tuple[str, int, float, float]] = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    @contextlib.contextmanager
    def span(self, kind: str, index: int):
        """Record the block's host interval as a span (thread-safe: one
        list append), and mark it ``tiger.run.<kind>`` in a profiler trace."""
        with span(f"tiger.run.{kind}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.spans.append((kind, index, t0, time.perf_counter()))

    def span_list(self, *kinds: str) -> list:
        """(start, end) of the spans of these kinds."""
        return [(a, b) for k, _, a, b in self.spans if k in kinds]

    def record_solve(self, result, wall_s: float) -> None:
        """Derive the step counters from a SolveResult."""
        stats = result.rk_stats
        sums = [stats.n_attempts.sum(), stats.n_accepted.sum()]
        rd = result.radau_stats
        if rd is not None:
            sums.append(rd.n_attempts.sum())
        host = torch.stack([v.to(torch.int64) for v in sums]).cpu().tolist()
        n_att, n_acc = host[0], host[1]
        self.counters.update(
            {
                "num_systems": int(stats.n_attempts.shape[0]),
                "rk_attempted_steps": n_att,
                "rk_accepted_steps": n_acc,
                "solve_wall_s": wall_s,
            }
        )
        if rd is not None:
            self.counters["radau_attempted_steps"] = host[2]
        self.counters["n_stiff"] = int(result.n_stiff)

    def summary(self) -> dict:
        return {"phases_s": dict(self.phases), **self.counters}


def metrics_span(metrics: Optional[Metrics], kind: str, index: int):
    """``metrics.span(kind, index)``, or nothing without ``metrics``."""
    return _NO_SPAN if metrics is None else metrics.span(kind, index)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block, written to ``log_dir/trace.json``
    (a no-op when ``log_dir`` is falsy).  It records every thread, so the
    windowed run's loader and writer threads bring their spans too."""
    if not log_dir:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities, experimental_config=every_thread) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def overlap_share(intervals, others) -> float:
    """The share of the union of ``intervals`` that lies inside the union
    of ``others`` (0 when ``intervals`` is empty)."""
    whole = union_length(intervals)
    if whole <= 0.0:
        return 0.0
    merged, end = [], float("-inf")
    for a, b in sorted(others):
        if merged and a <= end:
            merged[-1] = (merged[-1][0], max(end, b))
        else:
            merged.append((a, b))
        end = max(end, b)
    inside = [(max(a, c), min(b, d)) for a, b in intervals for c, d in merged
              if min(b, d) > max(a, c)]
    return union_length(inside) / whole


def trace_busy(trace_file: str, span_name: str) -> tuple:
    """(device busy s, wall s) of the ``record_function(span_name)`` block
    in a Chrome trace written by ``trace``: the union of the device's
    kernels, copies and sets within the block's wall."""
    import json

    with open(trace_file) as fh:
        events = json.load(fh)["traceEvents"]
    span = next(e for e in events if e.get("name") == span_name
                and e.get("cat") == "user_annotation" and "dur" in e)
    lo, hi = span["ts"], span["ts"] + span["dur"]
    device = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e
              and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    return union_length(device) * 1e-6, (hi - lo) * 1e-6

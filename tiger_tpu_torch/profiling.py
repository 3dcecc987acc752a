"""Metrics: phase timers, the system-steps/s counters, and a profiler trace.

Port of ``Metrics`` and ``trace`` in ``tiger_tpu/profiling.py``.  The solve
counters are reduced on the solve's device and read with one copy to the
host; ``trace`` records ``torch.profiler`` (CPU, and CUDA where there is a
card) into a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch


@dataclass
class Metrics:
    phases: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def record_solve(self, result, wall_s: float) -> None:
        """Derive the throughput counters from a SolveResult."""
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
                # Attempted system-steps per second of the solve's wall.
                "system_steps_per_s": (n_att / wall_s) if wall_s > 0 else 0.0,
            }
        )
        if rd is not None:
            self.counters["radau_attempted_steps"] = host[2]
        self.counters["n_stiff"] = int(result.n_stiff)

    def summary(self) -> dict:
        return {"phases_s": dict(self.phases), **self.counters}


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block, written to ``log_dir/trace.json``
    (a no-op when ``log_dir`` is falsy)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

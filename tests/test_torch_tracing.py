"""The port's spans on the profiler's clock (``tiger_tpu_torch.profiling.span``).

Under ``torch.profiler``, ``solve()`` leaves its phases and its host-sync
marks in the Chrome trace; without a profiler no ``record_function`` is
entered; the answers are the same bit for bit either way; ``Metrics.span``
keeps its host-clock list and reaches the trace too, from the windowed
run's threads as well.
"""

import dataclasses
import io
import json

import pytest
import torch

from tiger_tpu_torch import (DummyModel, ForcingMeta, ForcingSet, SolverConfig, chunked,
                             profiling, solve)
from tiger_tpu_torch.io.output import _OneInFlight
from tiger_tpu_torch.profiling import Metrics
from tiger_tpu_torch.solver.controller import initial_step

PHASES = ["check", "initial_step", "b1", "handoff", "b2", "merge"]
SYNCS = ["check_nan", "query_end", "dedup", "handoff"]


@dataclasses.dataclass(frozen=True)
class StiffMix(DummyModel):
    """Per-system linear decay y' = lam*y: lam << 0 is stiff for RK45."""

    def rhs_tuple(self, t, y, params, forcings=None):
        return tuple(params["lam"] * yi for yi in y)


# B1 flags row 2 stiff and B2 stops it after 10 steps: a short trace.
CFG = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=10)
TF = 5.0


def run_solve(queries, forced=False):
    """The mix's solve; ``forced`` adds two forcings (which the model does
    not read) and a time shift, as a window of the windowed run has."""
    lam = torch.full((4,), -0.1, dtype=torch.float64)
    lam[2] = -1e6
    y0 = torch.ones((4, 5), dtype=torch.float64)
    forcings = ForcingSet(data=torch.zeros((2, 4)),
                          meta=ForcingMeta((0, 1), (1, 1), (60.0, 1440.0)))
    return solve(StiffMix(), y0, 0.0, TF, torch.tensor(queries, dtype=torch.float64),
                 {"lam": lam}, forcings if forced else None, CFG, t_shift=60.0 if forced else 0.0)


def program_spans(path) -> list:
    """(start, end, name) of the trace's ``tiger.*`` spans, by start."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("name", "").startswith("tiger."))


def traced(tmp_path, fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pass  # the profiler's first start in a process is slow; keep it out of the case
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return out, program_spans(path)


def assert_same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert_same(x, y)
        elif torch.is_tensor(x):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
        else:
            assert x == y


@pytest.mark.parametrize("queries, forced, syncs, reorder", [
    ([TF], False, SYNCS, False),
    ([TF / 2, TF], False, ["check_nan", "check_order", "query_end", "dedup", "handoff"], False),
    ([TF, TF], False, ["check_nan", "check_order", "query_end", "dedup", "handoff"], True),
    ([TF], True, ["check_nan", "query_end", "dedup", "t_shift", "forcing_row", "forcing_row",
                  "handoff"], False),
], ids=["one_query", "two_queries", "repeated_query", "forced_and_shifted"])
def test_solve_phases_and_sync_marks_in_the_trace(tmp_path, queries, forced, syncs, reorder):
    res, spans = traced(tmp_path, lambda: run_solve(queries, forced))
    assert res.n_stiff == 1
    roots = [s for s in spans if s[2] == "tiger.solve"]
    assert len(roots) == 1
    lo, hi = roots[0][:2]
    assert all(lo <= s and e <= hi for s, e, _ in spans)
    phases = [s for s in spans if s[2].startswith("tiger.solve.")]
    assert [name.removeprefix("tiger.solve.") for _, _, name in phases] == (
        PHASES + ["reorder"] * reorder)
    # Siblings, one after another.
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))
    marks = [s for s in spans if s[2].startswith("tiger.sync.")]
    assert [name.removeprefix("tiger.sync.") for _, _, name in marks] == syncs
    # Each mark lies in its phase.
    phase_of = {"check_nan": "check", "check_order": "check", "query_end": "check",
                "dedup": "check", "t_shift": "initial_step", "forcing_row": "initial_step",
                "handoff": "handoff"}
    for s, e, name in marks:
        ps, pe, _ = next(p for p in phases if p[2] == "tiger.solve." + phase_of[name[11:]])
        assert ps <= s and e <= pe


@pytest.mark.parametrize("h0_mode", ["per-system", "global-zero-y0"])
def test_initial_step_marks_the_models_rhs_once(tmp_path, h0_mode):
    """``initial_step`` evaluates the model's right-hand side in eager torch
    once a call, inside one ``tiger.model.rhs`` span; in ``solve()`` the
    span lies inside ``tiger.solve.initial_step``."""
    cfg = dataclasses.replace(CFG, h0_mode=h0_mode)
    y0 = torch.ones((4, 5), dtype=torch.float64)
    lam = {"lam": torch.full((4,), -0.1, dtype=torch.float64)}
    _, spans = traced(tmp_path, lambda: [initial_step(StiffMix(), y0, 0.0, lam, config=cfg)
                                         for _ in range(3)])
    assert [name for _, _, name in spans] == ["tiger.model.rhs"] * 3
    _, spans = traced(tmp_path, lambda: run_solve([TF]))
    rhs = [(s, e) for s, e, name in spans if name == "tiger.model.rhs"]
    (lo, hi), = [(s, e) for s, e, name in spans if name == "tiger.solve.initial_step"]
    assert len(rhs) == 1 and lo <= rhs[0][0] and rhs[0][1] <= hi


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.span("tiger.test"):
        pass
    res = run_solve([TF / 2, TF, TF])
    assert res.n_stiff == 1
    m = Metrics()
    with m.span("window", 0):
        pass
    assert [s[:2] for s in m.spans] == [("window", 0)]


def test_answers_same_with_and_without_a_profiler(tmp_path):
    plain = run_solve([TF / 2, TF, TF])
    with_spans, spans = traced(tmp_path, lambda: run_solve([TF / 2, TF, TF]))
    assert spans
    assert_same(plain, with_spans)


def test_metrics_span_on_both_clocks(tmp_path):
    m = Metrics()

    def record():
        with m.span("window", 3):
            with m.span("solve", 3):
                pass

    _, spans = traced(tmp_path, record)
    assert [k for k, *_ in m.spans] == ["solve", "window"]
    assert [i for _, i, *_ in m.spans] == [3, 3]
    assert all(b >= a for _, _, a, b in m.spans)
    assert [name for _, _, name in spans] == ["tiger.run.window", "tiger.run.solve"]


def test_windowed_run_spans_reach_the_profile_dir(tmp_path):
    """``profiling.trace`` (the CLI's ``--profile-dir``) records the
    windowed run's spans, those of its loader and writer threads too."""
    m = Metrics()
    y0 = torch.ones((3, 5), dtype=torch.float64)
    with profiling.trace(str(tmp_path)):
        chunked.solve_chunked(DummyModel(), y0, 0.0, 10.0, 5.0, lambda a, b: None,
                              query_interval=5.0, dense_sink=lambda *a: None, metrics=m)
        pipe = _OneInFlight(m)
        try:
            pipe.submit(0, torch.zeros(4), lambda block: None)
            pipe.flush(io.BytesIO())
        finally:
            pipe.close()
    spans = program_spans(tmp_path / "trace.json")
    names = {name for _, _, name in spans}
    for kind in ("window", "load", "solve", "sink", "write", "flush"):
        assert f"tiger.run.{kind}" in names, kind
    # Each window's block holds solve()'s own root under another name.
    runs = [(s, e) for s, e, name in spans if name == "tiger.run.solve"]
    roots = [(s, e) for s, e, name in spans if name == "tiger.solve"]
    assert len(roots) == len(runs) == 2
    for (rs, re_), (s, e) in zip(runs, roots):
        assert rs <= s and e <= re_
    assert {k for k, *_ in m.spans} == {"window", "load", "solve", "sink", "write", "flush"}

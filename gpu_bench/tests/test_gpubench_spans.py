"""The readers of the program's own spans on a synthetic profiler trace:
the device's idle time inside ``solve()``'s phases, and the host syncs a
window; and nothing read from a trace without the program's spans."""

import _bench_path  # noqa: F401
import pytest
from test_gpubench_trace import synthetic_events, x

from harness import spec, trace

READERS = ("entry_idle_ms_per_window", "lead_in_idle_ms_per_window",
           "handoff_idle_ms_per_window", "host_syncs_per_window")


def program_events():
    """Two 100 us windows.  The host, on the benchmark's thread: the solve
    from 12 to 88 us, its phases check 12-20 (three sync marks, and the
    order check's in window 0 only), initial_step 20-24, b1 24-30, handoff
    30-60 (its sync 31-55), b2 60-64, merge 64-88.  The device: the draw's
    kernel 5-8, the initial step's 21-23, B1 26-56, B2 62-82, the merge's
    84-86.  A sync mark on another thread and a solve span before the first
    window are not read."""
    events = [x("user_annotation", "tiger.solve", -50.0, 20.0),
              x("user_annotation", "tiger.sync.devices", 50.0, 2.0, tid=2)]
    corr = 0
    for w in range(2):
        o = 100.0 * w
        events += [x("user_annotation", "bench.window", o, 100.0),
                   x("user_annotation", "bench.draw", o, 10.0),
                   x("user_annotation", "bench.solve", o + 10, 80.0),
                   x("user_annotation", "bench.carry", o + 90, 10.0)]
        host = [("tiger.solve", 12, 76), ("tiger.solve.check", 12, 8),
                ("tiger.sync.check_nan", 13, 1), ("tiger.sync.query_end", 15, 1),
                ("tiger.sync.dedup", 17, 2), ("tiger.solve.initial_step", 20, 4),
                ("tiger.solve.b1", 24, 6), ("tiger.solve.handoff", 30, 30),
                ("tiger.sync.handoff", 31, 24), ("tiger.solve.b2", 60, 4),
                ("tiger.solve.merge", 64, 24)]
        if w == 0:
            host.append(("tiger.sync.check_order", 14.6, 0.3))
        events += [x("user_annotation", name, o + ts, dur) for name, ts, dur in host]
        for launch, start, dur, name in (
                (4, 5, 3, "distribution_uniform_kernel"),
                (20.5, 21, 2, "elementwise_kernel"),
                (25, 26, 30, "void tt::rk45_kernel<double, 0>(tt::Rk45Args<double>)"),
                (61, 62, 20, "void tt::radau_kernel<double, 0, false>(...)"),
                (83, 84, 2, "index_elementwise_kernel")):
            corr += 1
            events.append(x("cuda_runtime", "cudaLaunchKernel", o + launch, 0.5, correlation=corr))
            events.append(x("kernel", name, o + start, dur, tid=7, correlation=corr))
    return events


def run_record(events):
    return {"trace": trace.reduce_events(events), "n_windows": 2, "precision": "f64",
            "work": None, "peaks": None}


def read(name, record):
    return spec.metric_reader(name)(record)


def test_idle_inside_the_phases():
    record = run_record(program_events())
    # The solve: 76 us, of which the device is busy 2 + 30 + 20 + 2 us.
    assert read("entry_idle_ms_per_window", record) == pytest.approx(0.022)
    # Check, initial step and B1's call, 12-30 us: busy 21-23 and 26-30.
    assert read("lead_in_idle_ms_per_window", record) == pytest.approx(0.012)
    # Hand-off, B2 and merge, 30-88 us: busy 30-56, 62-82 and 84-86.
    assert read("handoff_idle_ms_per_window", record) == pytest.approx(0.010)
    # Four marks a window, and window 0's order check.
    assert read("host_syncs_per_window", record) == pytest.approx(4.5)


def test_phase_idle_within_the_whole():
    record = run_record(program_events())
    lead, handoff, entry = (read(n, record) for n in READERS[1:3] + READERS[:1])
    assert lead + handoff <= entry + 1e-12
    idle_ms = (trace.window_seconds(record["trace"]) - trace.busy_seconds(record["trace"])) * 1e3
    assert entry <= idle_ms / record["n_windows"]


def test_gaps_named_by_the_phase():
    names = dict((round(g[1] * 1e6), g[0]) for g in trace.breakdown(
        run_record(program_events())["trace"])["idle_gaps"])
    # B1 ends at 56 and B2 starts at 62: the host is in the hand-off.
    assert names[6] == "bench.solve > tiger.solve.handoff"
    # 8 to 21 us: the draw, then the solve's checks, between two of their marks at the middle.
    assert names[13] == "bench.solve > tiger.solve.check"


@pytest.mark.parametrize("name", READERS)
def test_nothing_read_without_the_programs_spans(name):
    assert read(name, run_record(synthetic_events())) is None

"""The trace arithmetic on a synthetic profiler trace: unions, the step a
device operation was launched in, the per-layer readers, the breakdown."""

import math

import _bench_path  # noqa: F401
import pytest

from harness import spec, trace, work


def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def synthetic_events():
    """Two 100 us windows: B1 30 us, B2 20 us, another kernel of the solve
    5 us, a copy of the solve 2 us, and the forcing draw's kernel 3 us,
    which runs while the host is already in the solve."""
    events = []
    corr = 0
    for w in range(2):
        o = 100.0 * w
        events += [x("user_annotation", "bench.window", o, 100.0),
                   x("user_annotation", "bench.draw", o, 10.0),
                   x("user_annotation", "bench.solve", o + 10, 80.0),
                   x("user_annotation", "bench.carry", o + 90, 10.0),
                   x("cpu_op", "aten::nonzero", o + 51, 3.0)]
        for launch, start, dur, cat, name in (
                (5, 12, 3, "kernel", "distribution_uniform_kernel"),
                (12, 20, 30, "kernel", "void tt::rk45_kernel<float, 0>(tt::Rk45Args<float>)"),
                (52, 55, 20, "kernel", "void tt::radau_kernel<float, 0, false>(...)"),
                (78, 80, 5, "kernel", "elementwise_kernel"),
                (85.5, 86, 2, "gpu_memcpy", "Memcpy DtoD (Device -> Device)")):
            corr += 1
            events.append(x("cuda_runtime", "cudaLaunchKernel", o + launch, 0.5, correlation=corr))
            events.append(x(cat, name, o + start, dur, tid=7, correlation=corr))
    events.append({"ph": "i", "name": "marker", "ts": 3.0})
    return events


@pytest.fixture
def record():
    rec = trace.reduce_events(synthetic_events())
    w = {"b1_ops": 1.0e6, "b2_ops": 4.0e5, "b1_bytes": 2.0e6, "b2_bytes": 1.0e3}
    return {"trace": rec, "n_windows": 2, "precision": "f32", "work": w,
            "peaks": {"flops_per_s": {"f32": 1.0e12, "f64": 0.5e12}, "bytes_per_s": 1.0e12}}


def read(name, record):
    return spec.metric_reader(name)(record)


def test_union_and_merge():
    assert trace.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]
    assert trace.clip([(0, 2), (3, 9)], 1, 4) == [(1, 2), (3, 4)]


def test_steps_come_from_the_launch(record):
    steps = {name: step for _, _, name, step in record["trace"]["device"]}
    assert steps.pop("distribution_uniform_kernel") == "bench.draw"
    assert set(steps.values()) == {"bench.solve"}


def test_layer_times(record):
    assert read("b1_ms_per_window", record) == pytest.approx(0.030)
    assert read("b2_ms_per_window", record) == pytest.approx(0.020)
    assert read("solve_other_ms_per_window", record) == pytest.approx(0.007)
    assert trace.busy_seconds(record["trace"]) == pytest.approx(120e-6)
    assert trace.window_seconds(record["trace"]) == pytest.approx(200e-6)
    assert read("device_idle_pct", record) == pytest.approx(40.0)
    assert read("window_p95_ms", record) == pytest.approx(0.076)


def test_rooflines_and_mfu(record):
    # B1: 2 windows x 1e6 operations at 1e12/s = 2 us, bytes 4 us: bytes bind.
    assert read("b1_roofline", record) == pytest.approx(100 * 4e-6 / 60e-6)
    # B2: 0.8 us of operations over 40 us.
    assert read("b2_roofline", record) == pytest.approx(100 * 0.8e-6 / 40e-6)
    assert read("window_mfu_pct", record) == pytest.approx(100 * 2.8e6 / (200e-6 * 1e12))


def test_readers_without_their_work(record):
    record["trace"]["device"] = [d for d in record["trace"]["device"] if "radau" not in d[2]]
    assert read("b2_ms_per_window", record) is None
    assert read("b2_roofline", record) is None
    record["work"] = None
    assert read("b1_roofline", record) is None
    assert read("window_mfu_pct", record) is None


def test_breakdown(record):
    b = trace.breakdown(record["trace"], top=3)
    assert b["device_ops"][0][0].startswith("void tt::rk45_kernel")
    assert b["device_ops"][0][1] == pytest.approx(60e-6)
    assert len(b["device_ops"]) == 3
    lengths = [g[1] for g in b["idle_gaps"]]
    assert lengths == sorted(lengths, reverse=True)
    assert lengths[0] == pytest.approx(24e-6)  # 88 us to the next window's first kernel at 112
    names = dict((round(g[1] * 1e6), g[0]) for g in trace.breakdown(record["trace"])["idle_gaps"])
    assert names[12] == "bench.draw"
    assert names[1] == "bench.solve"


def test_frozen_work_counts():
    assert work.b1_step(32) == 578 and work.b2_attempt(32) == 837
    w = work.window_work({"b1_steps": 100.0, "b2_steps": 2.0, "b2_sweeps_per_step": 3.0,
                          "stiff_rows": 10.0}, rhs_ops=32, links=1000, queries=48,
                         forcing_rows=50, elem_bytes=4)
    assert w["b1_ops"] == 1000 * 100 * 578 + 990 * 48 * 141
    assert w["b2_ops"] == 1000 * 2 * (837 + 3 * 550) + 10 * 48 * 58
    assert w["b1_bytes"] == 1000 * (21 * 4 + 50 * 4) + 1000 * (5 + 48 * 5) * 4 + 1000 * 14
    t, bound = work.least_seconds(w["b1_ops"], w["b1_bytes"], spec.load_json(
        spec.BENCH_DIR / "peaks.json"), "f32")
    assert bound == "operations" and math.isclose(t, w["b1_ops"] / 67e12)

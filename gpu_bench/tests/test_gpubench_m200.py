"""The Model 200 cell ``m200f64_1m_stiff_1h``: its files found by name and
the metrics it reports, and the reader of the ``tiger.model.rhs`` span on
hand-built traces.  (``test_gpubench_check.py``
runs its check on a tiny copy of the cell, as it runs every cell's.)"""

import _bench_path  # noqa: F401
import pytest
from test_gpubench_spans import program_events
from test_gpubench_trace import synthetic_events, x

from harness import spec, trace, work

CELL = "m200f64_1m_stiff_1h"
STANDING = "m204f64_1m_stiff_1h"
RHS_IDLE = "rhs_idle_ms_per_window"
PEAKS = {"flops_per_s": {"f32": 1.0e12, "f64": 0.5e12}, "bytes_per_s": 1.0e12}


def read(name, record):
    return spec.metric_reader(name)(record)


def record_of(events, work_=None):
    return {"trace": trace.reduce_events(events), "n_windows": 2, "precision": "f64",
            "work": work_, "peaks": PEAKS}


def rhs_events(with_rhs=True):
    """``program_events`` with a ``tiger.model.rhs`` span over 20.5-23.5 us
    of each window's initial step, whose kernel runs 21-23 us."""
    events = program_events()
    if with_rhs:
        events += [x("user_annotation", "tiger.model.rhs", 100.0 * w + 20.5, 3.0)
                   for w in range(2)]
    return events


def test_rhs_idle_inside_its_spans():
    # 3 us a span, of which the device is busy 2 us.
    assert read(RHS_IDLE, record_of(rhs_events())) == pytest.approx(0.001)


@pytest.mark.parametrize("events", [rhs_events(with_rhs=False), synthetic_events()],
                         ids=["program_spans_without_rhs", "no_program_spans"])
def test_rhs_idle_is_none_without_its_span(events):
    assert read(RHS_IDLE, record_of(events)) is None


def test_cell_resolves_with_its_start_date_and_metrics():
    cell = spec.resolve(CELL)
    assert cell.doy0 == 1.0 and cell.config["precision"] == "f64"
    assert cell.model.READS_TIME and cell.model.RHS_OPS == 72
    assert cell.config["control"]["program"] == {"precision": "f32"}
    assert {m["name"] for m in cell.end_to_end} == {"link_days_per_s", "setup_s"}
    limits = cell.data["limits"]
    assert limits["failed"] == 0 and "plain_static_err" in limits
    # No row reaches B2: no B2 error is limited, and a row handed to B2 fails.
    assert limits["b2_rows_checked"] == 0
    assert not any(k.startswith("b2_") and k.endswith("_err") for k in limits)
    assert work.b1_step(cell.model.RHS_OPS) == 818 and work.B1_QUERY == 141


def test_both_cells_report_every_metric_but_b2s():
    """The Model 200 cell reads what the standing cell reads (the device's
    idle share, the syncs, the entry's phases, B1 and its roofline, the
    right-hand side's idle) but B2's time and roofline, since no row of it
    reaches B2."""
    new = {m["name"] for m in spec.resolve(CELL).per_layer}
    standing = {m["name"] for m in spec.resolve(STANDING).per_layer}
    assert standing - new == {"b2_ms_per_window", "b2_roofline"}
    assert new <= standing
    assert {RHS_IDLE, "device_idle_pct", "host_syncs_per_window", "b1_roofline"} <= new

"""A cell small enough for the CPU: by default 24 links, two planted stiff
rows and the cell's own windows, with the limits of a real cell; the
program's plain versions; the rest of a run as the benchmark makes it."""

import copy

import _bench_path  # noqa: F401

from harness import spec


def tiny_cell(limits_of="m204f64_1m_stiff_1h", links=24, window_minutes=None,
              random_rows=6) -> spec.Cell:
    """The cell ``limits_of`` (its configuration, traffic, frozen work and
    limits) at a test's size."""
    real = spec.resolve(limits_of)
    tr = copy.deepcopy(real.traffic)
    tr.update(links=links, stiff_share=2 / links)
    if window_minutes is not None:
        tr["window_minutes"] = window_minutes
    tr["check"] = {"random_rows": random_rows, "stiff_rows": 2, "flagged_rows": 2, "b2_rows": 2,
                   "first_windows": 2, "sampled_windows": 1}
    return spec.Cell(name="tiny", chips=1, config_name=real.config_name, config=real.config,
                     traffic_name="tiny", traffic=tr, data=copy.deepcopy(real.data),
                     end_to_end=real.end_to_end, per_layer=real.per_layer)

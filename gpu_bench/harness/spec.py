"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one ``configs`` gives; the traffic mix is
``gpu_bench/traffic/<traffic>.json``; the plain model the reference
integrates is ``gpu_bench/models/<config["model"]>.py`` (where it reads
time, ``READS_TIME``, the configuration states ``doy0``); the cell's frozen
work counts and check limits are ``gpu_bench/cells/<cell>.json``; a
per-layer metric is read by ``gpu_bench/metrics/<metric>.py``.  A later cell,
configuration, traffic mix or metric is added as such files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    data: dict  # frozen work counts and check limits; {} when the cell has no file
    end_to_end: list  # the end-to-end metric entries this cell reports
    per_layer: list  # the per-layer metric entries this cell reports

    @property
    def model(self):
        """The plain model module the reference integrates."""
        return load_module(BENCH_DIR / "models" / f"{self.config['model']}.py",
                           f"gpu_bench_model_{self.config['model']}")

    @property
    def doy0(self):
        """The day of year at t = 0 where the configuration states it, else None."""
        return float(self.config["doy0"]) if "doy0" in self.config else None


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, benchmark: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = benchmark if benchmark is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    work = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[work["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{work['traffic']}.json")
    data_path = BENCH_DIR / "cells" / f"{name}.json"
    cell = Cell(
        name=name, chips=int(work["chips"]), config_name=work["config"], config=config,
        traffic_name=work["traffic"], traffic=traffic,
        data=load_json(data_path) if data_path.exists() else {},
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )
    if cell.model.READS_TIME and cell.doy0 is None:
        raise ValueError(f"configuration {work['config']!r}: model {config['model']!r} reads "
                         "time, so the file must state 'doy0', the day of year at t = 0")
    return cell


def metric_reader(name: str):
    """``read(record) -> float | None`` of the per-layer metric ``name``."""
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", f"gpu_bench_metric_{name}").read

"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix and per-layer metric found by name."""

import re

import _bench_path  # noqa: F401
import pytest

from harness import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpu_bench"] and BENCH["command"] == ["python3", "gpu_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    cells = len(BENCH["workloads"])
    # 2 + 14 runs a cell, each run_seconds + 60 s, 180 s a cell to compile, 1200 s spare,
    # with the 24 cells later PRs may add.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries(section):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[section]
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"])
        for text in ("why", "layer"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if "workloads" in e:
            assert set(e["workloads"]) <= set(CELLS) and e["workloads"]


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_per_layer_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.resolve(cell)
    assert c.config["precision"] in ("f32", "f64") and "control" in c.config
    assert set(c.traffic["check"]) == {"random_rows", "stiff_rows", "flagged_rows", "b2_rows",
                                       "first_windows", "sampled_windows"}
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert "failed" in c.data["limits"] and len(c.data["limits"]) >= 2
    assert c.data["limits"]["failed"] == 0
    assert c.model.N_EQ == 5


def test_configs_have_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("gpu_bench/") and (spec.ROOT / c["file"]).is_file()
        assert c["name"] in used and c["reduced"] == []
        assert 1 <= len(c["source"]) <= 200


def test_every_traffic_mix_is_a_data_file():
    for path in (spec.BENCH_DIR / "traffic").iterdir():
        assert path.suffix == ".json"
        tr = spec.load_json(path)
        assert {"links", "stiff_share", "window_minutes", "query_minutes", "forcing",
                "params", "check"} <= set(tr)


def test_every_metric_reader_is_named_in_the_benchmark():
    readers = {p.stem for p in (spec.BENCH_DIR / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in BENCH["per_layer"]}

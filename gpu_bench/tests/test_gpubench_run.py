"""The command: no card, no result; the result line's keys; what the
process has loaded."""

import json
import os
import shutil
import subprocess
import sys

import _bench_path  # noqa: F401
import pytest
from _tiny import tiny_cell

from harness import spec

RUN = [sys.executable, "gpu_bench/run.py", "--workload", "m204f64_1m_stiff_1h",
       "--seed", "3000000001", "--seconds", "1", "--trace", "0"]
FORBIDDEN = {"jax", "jaxlib", "flax", "tiger_tpu"}


def env():
    e = dict(os.environ)
    e["CUDA_VISIBLE_DEVICES"] = ""
    return e


def test_refuses_without_a_card():
    proc = subprocess.run(RUN, cwd=spec.ROOT, capture_output=True, text=True, env=env(),
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "gpu_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(RUN, cwd=tmp_path, capture_output=True, text=True, env=env(),
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    import run

    result, info = run.run_cell(tiny_cell(), 4_000_000_007, 0.5, trace, device="cpu")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + ["checks"]
    device = {"platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    assert set(result["device"]) == device
    assert result["attempted"] == 24 * info["windows"] and result["failed"] == 0
    for entry in result["checks"].values():
        assert set(entry) == {"value", "limit"}
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {"link_days_per_s", "setup_s"}
    json.dumps(result)


def loaded_after(code: str) -> set:
    script = ("import sys; sys.path[:0] = ['.', 'gpu_bench']\n" + code +
              "\nprint(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", script], cwd=spec.ROOT, capture_output=True,
                         text=True, env=env(), timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    code = ("import run\nfrom harness import spec, inputs, stream, trace, work, check, reference\n"
            "for m in spec.load_json(spec.ROOT / 'BENCHMARK.json')['per_layer']:\n"
            "    spec.metric_reader(m['name'])\n"
            "sys.path.insert(0, 'gpu_bench/tests')\nfrom _tiny import tiny_cell\n"
            "run.run_cell(tiny_cell(), 5, 0.2, False, device='cpu')")
    assert not loaded_after(code) & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    code = ("from harness import reference, check, spec\n"
            "spec.load_module(spec.BENCH_DIR / 'models' / 'model204.py', 'm')")
    assert not loaded_after(code) & (FORBIDDEN | {"tiger_tpu_torch"})

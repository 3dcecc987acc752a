"""The port's examples run on the CPU, and its top level exports every name
the JAX package's does."""

import os
import subprocess
import sys

import pytest

import tiger_tpu
import tiger_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script,args,expect", [
    ("torch_quickstart.py", ["--links", "50"], "biggest outlet is link"),
    ("torch_calibration.py", ["--links", "8", "--members", "4", "--hours", "6"],
     "4-member ensemble x 8 links = 32 systems on cpu"),
])
def test_example_runs_on_the_cpu(tmp_path, script, args, expect):
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), "--cpu", *args],
        capture_output=True, text=True, timeout=300,
        env={"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": str(tmp_path),
             "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert expect in proc.stdout


def test_top_level_exports_the_jax_packages_names():
    assert set(tiger_tpu.__all__) <= set(tiger_tpu_torch.__all__)
    for name in tiger_tpu_torch.__all__:
        assert getattr(tiger_tpu_torch, name) is not None, name

"""B1's schedule on the CPU: pooled, time-sliced systems against each system
run alone.

No CUDA compiler is needed: g++ builds the body of
``tiger_tpu_torch/kernels/csrc/rk45.cu`` (everything above its launch
section) against the stand-in ``tests/torch_shim/cuda_runtime.h``, with one
``std::thread`` a CUDA thread and a ``std::barrier`` for ``__syncthreads``.
The build is small on purpose (8 lanes a block, 16 pool slots, 4 attempts a
slice, 2 blocks), so that at 100 systems a block's share of 50 passes through
its pool in several admissions, more systems are live than there are lanes
(the least-t order decides who runs), and the drain packs the last systems
into fewer lanes.  The same library runs every system alone, from its start
to its end, through the same attempt function: the schedule must change no
system's result, bit for bit.  (Against ``rk45_plain`` the g++ build differs
where glibc's exp2f/log2f/powf round otherwise than torch's; on the card the
two agree bit for bit, which tests/test_torch_cuda.py checks.)
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from tests.test_torch_cuda import OPTIONS, RK45_INSTANCES
from tiger_tpu_torch import Model204, SolverConfig
from tiger_tpu_torch.kernels import _build
from tiger_tpu_torch.kernels import rk45 as k_rk45
from tiger_tpu_torch.scenario import scenario
from tiger_tpu_torch.solver.controller import initial_step

SHIM = Path(__file__).resolve().with_name("torch_shim")
CFG = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
TF = 360.0
SHAPE = ("-DTT_RK45_THREADS=8", "-DTT_RK45_POOL=16", "-DTT_RK45_SLICE=4", "-DTT_SHIM_BLOCKS=2")


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    work = tmp_path_factory.mktemp("rk45_shim")
    source = (_build.CSRC / "rk45.cu").read_text()
    (work / "rk45_body.h").write_text(source.split("// ---- launch ----")[0])
    (work / "rk45_tableau.cuh").write_text(_build.tableau_header())
    lib_path = work / "librk45_shim.so"
    cmd = ["g++", "-std=c++20", "-O1", "-pthread", "-ffp-contract=off", "-shared", "-fPIC",
           "-x", "c++", *SHAPE, "-I", str(SHIM), "-I", str(work), "-I", str(_build.CSRC),
           "-o", str(lib_path), str(SHIM / "rk45_shim.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(lib_path))
    for name in ("tt_rk45_launch", "tt_rk45_serial"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    lib.tt_rk45_args_size.restype = ctypes.c_int
    return lib


def _run(lib, monkeypatch, entry, model, y0, h0, qt, p, f, cfg):
    """The wrapper's CUDA path on CPU tensors, its launch sent to ``entry``
    of the shim library."""

    def launch(fn_name, size_name, args, device, options):
        assert fn_name == "tt_rk45_launch"
        assert getattr(lib, size_name)() == ctypes.sizeof(args)
        assert getattr(lib, entry)(ctypes.addressof(args), None) == 0

    monkeypatch.setattr(k_rk45, "launch", launch)
    return k_rk45._rk45_cuda(model, y0, h0, 0.0, TF, qt, p, f, cfg)


@pytest.mark.parametrize("name", sorted(OPTIONS))
@pytest.mark.parametrize("n_sys", [1, 31, 100])
def test_schedule_changes_no_result(shim_lib, monkeypatch, n_sys, name):
    options, safe_pow = OPTIONS[name]
    cfg = dataclasses.replace(CFG, **options)
    model = Model204(safe_pow=safe_pow)
    y0, p, f = scenario(n_sys, TF / 1440.0, 0.05, device="cpu")
    qt = torch.arange(0.0, TF + 1e-9, 60.0)
    h0 = initial_step(model, y0, 0.0, p, f, cfg)
    pooled = _run(shim_lib, monkeypatch, "tt_rk45_launch", model, y0, h0, qt, p, f, cfg)
    alone = _run(shim_lib, monkeypatch, "tt_rk45_serial", model, y0, h0, qt, p, f, cfg)
    diff = k_rk45.rk45_mismatch(pooled, alone)
    assert not any(diff.values()), diff
    # The run did something: attempts were made, and where the scenario has
    # stiff rows and the detector is on they were flagged.
    assert int(alone.stats.n_attempts.min()) > 0
    if n_sys >= 31 and cfg.stiff_detect and cfg.max_steps > 40:
        assert bool(alone.stiff[p["Hu"] < 1e-5].all())


@pytest.mark.parametrize("name", sorted(RK45_INSTANCES))
def test_option_instance_schedule_changes_no_result(shim_lib, monkeypatch, name):
    """Each option instance (its pool rows k0, y_c and facold stored and
    loaded between slices) gives every system the result it gets alone,
    and the FSAL instances give the default instances' results: bit for
    bit, 100 systems over 6 hours with stiff rows and hourly rain."""
    cfg = dataclasses.replace(CFG, **RK45_INSTANCES[name])
    model = Model204()
    y0, p, f = scenario(100, TF / 1440.0, 0.05, device="cpu")
    qt = torch.arange(0.0, TF + 1e-9, 60.0)
    h0 = initial_step(model, y0, 0.0, p, f, cfg)
    pooled = _run(shim_lib, monkeypatch, "tt_rk45_launch", model, y0, h0, qt, p, f, cfg)
    alone = _run(shim_lib, monkeypatch, "tt_rk45_serial", model, y0, h0, qt, p, f, cfg)
    diff = k_rk45.rk45_mismatch(pooled, alone)
    assert not any(diff.values()), diff
    assert bool(alone.stiff[p["Hu"] < 1e-5].all())
    if cfg.fsal:
        plain_k1 = _run(shim_lib, monkeypatch, "tt_rk45_launch", model, y0, h0, qt, p, f,
                        dataclasses.replace(cfg, fsal=False))
        diff = k_rk45.rk45_mismatch(pooled, plain_k1)
        assert not any(diff.values()), diff

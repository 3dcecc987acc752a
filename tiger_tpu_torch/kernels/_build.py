"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared library
with a plain C interface, which is loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The library lands in
``build/tiger_tpu_torch/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing but the repository's own sources is compiled, beside one
header that is written here: the Dormand-Prince tableau of
``solver/tableau.py`` as a constexpr initialiser (``rk45_tableau.cuh``), so
B1 can fold its tests for zero entries at compile time without the
tableau ever being retyped by hand.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

from tiger_tpu_torch.solver import tableau

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tiger_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # No FMA contraction: every multiply and add rounds on its own, as the
    # plain versions' torch ops do.  With contraction a system's step
    # sequence drifts from the plain version's by the solver's tolerance,
    # which the ET drain then amplifies beyond any useful check.
    "-fmad=false",
    "-Xptxas", "-v",  # registers, spills and stack per kernel, into the log
)
#: The same build with nvcc's default FMA contraction, to measure what
#: ``-fmad=false`` costs (``python -m tiger_tpu_torch.profile_solve``).
FMAD_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-fmad=false")

_libs: dict[tuple[str, ...], ctypes.CDLL] = {}
_flags_in_use = NVCC_FLAGS


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def tableau_header() -> str:
    """``rk45_tableau.cuh``: tableau.DP_* rounded to float32, as the
    initialiser of ``tt::DpTableau`` (a, c, b, e, p) in hexadecimal floats."""

    def braces(x) -> str:
        if np.ndim(x) == 0:
            return float(np.float32(x)).hex() + "f"
        return "{" + ", ".join(braces(v) for v in x) + "}"

    rows = (tableau.DP_A, tableau.DP_C, tableau.DP_B, tableau.DP_E, tableau.DP_P)
    body = ", \\\n    ".join(braces(np.asarray(r, np.float64)) for r in rows)
    return ("// Written by tiger_tpu_torch/kernels/_build.py from solver/tableau.py.\n"
            "#pragma once\n#define TT_DP_TABLEAU \\\n  { \\\n    " + body + " \\\n  }\n")


def source_hash(flags: tuple[str, ...] = NVCC_FLAGS) -> str:
    """Hash of the kernel sources, the written header and the compiler flags."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(tableau_header().encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(flags: tuple[str, ...] = NVCC_FLAGS) -> tuple[Path, float, str]:
    """Compile the library unless a build of the same sources and flags exists.

    Returns (library path, seconds spent compiling, compiler log); the log
    holds ptxas's per-kernel register/spill report of a fresh build.
    """
    digest = source_hash(flags)
    lib_path = BUILD_DIR / f"libtiger_kernels_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        return lib_path, 0.0, log_path.read_text() if log_path.exists() else ""
    include = BUILD_DIR / f"include_{digest}"
    include.mkdir(parents=True, exist_ok=True)
    (include / "rk45_tableau.cuh").write_text(tableau_header())
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *flags, "-I", str(include), "-o", tmp, *map(str, sorted(CSRC.glob("*.cu")))]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return lib_path, seconds, log


def load() -> ctypes.CDLL:
    """The kernel library of the flags in use (``NVCC_FLAGS`` outside
    ``flags_in_use``), built at first use and cached for the process."""
    lib = _libs.get(_flags_in_use)
    if lib is None:
        path, _, _ = build(_flags_in_use)
        lib = ctypes.CDLL(str(path))
        for name in ("tt_rk45_launch", "tt_radau_launch"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.tt_rk45_geometry.argtypes = [ctypes.c_int64, ctypes.c_void_p]
        lib.tt_rk45_geometry.restype = ctypes.c_int
        for name in ("tt_rk45_args_size", "tt_radau_args_size"):
            fn = getattr(lib, name)
            fn.argtypes = []
            fn.restype = ctypes.c_int
        _libs[_flags_in_use] = lib
    return lib


@contextlib.contextmanager
def flags_in_use(flags: tuple[str, ...]):
    """Launch the kernels from the build of ``flags`` inside the block."""
    global _flags_in_use
    saved, _flags_in_use = _flags_in_use, tuple(flags)
    try:
        yield
    finally:
        _flags_in_use = saved

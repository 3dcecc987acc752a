"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared library
with a plain C interface, which is loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The kernels are built without FMA
contraction.  Each kernel source is compiled six times, all at once: as it
stands, for Model 204's float instances and the C entry points; and as
relocatable device code with ``-DTT_DOUBLE_INSTANCES`` (Model 204's double
instances), ``-DTT_MODEL_200`` (Model 200's float instances), both (its
double ones), ``-DTT_MODEL_DUMMY`` (DummyModel's float instances) and that
with ``-DTT_DOUBLE_INSTANCES`` (its double ones).  The relocatable objects
are device-linked with
``csrc/contracted.cu`` (the double pow, built with contraction so that it
rounds as torch's CUDA pow does).  Model 204's float instances keep the
build they always had.  ``csrc/libm_check.cu`` (Model 200's libm calls,
one an element, for chip_smoke phase 12a) is no kernel of the path: it is
built only on request (``build_libm_check``), into a library of its own,
under the Model 200 instances' flags.  The library lands in
``build/tiger_tpu_torch/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing but the repository's own sources is compiled, beside one
header that is written here: the Dormand-Prince tableau of
``solver/tableau.py`` as constexpr initialisers (``rk45_tableau.cuh``), one
rounded to float32 for the float instances and one with its exact float64
values for the double instances, so B1 can fold its tests for zero entries
at compile time without the tableau ever being retyped by hand.  Every
instance, float and double, is in the one library of one build.
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
#: Built apart from the kernels, with nvcc's default FMA contraction.
CONTRACTED = "contracted.cu"
#: Built on request only, into its own library (``build_libm_check``).
LIBM_CHECK = "libm_check.cu"
#: The relocatable builds of each kernel source beside the one as it
#: stands: Model 204 in double, Model 200 and DummyModel in float and in
#: double.
INSTANCE_DEFINES = {"f64": ("-DTT_DOUBLE_INSTANCES",), "m200": ("-DTT_MODEL_200",),
                    "m200_f64": ("-DTT_MODEL_200", "-DTT_DOUBLE_INSTANCES"),
                    "dummy": ("-DTT_MODEL_DUMMY",),
                    "dummy_f64": ("-DTT_MODEL_DUMMY", "-DTT_DOUBLE_INSTANCES")}
#: The same build with nvcc's default FMA contraction, to measure what
#: ``-fmad=false`` costs (``python -m tiger_tpu_torch.profile_solve``).
FMAD_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-fmad=false")

_libs: dict[tuple[str, ...], ctypes.CDLL] = {}
_flags_in_use = NVCC_FLAGS


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def tableau_header() -> str:
    """``rk45_tableau.cuh``: tableau.DP_* as the initialisers of
    ``tt::DpTableau`` (a, c, b, e, p) in hexadecimal literals:
    ``TT_DP_TABLEAU`` rounded to float32, ``TT_DP_TABLEAU_F64`` the float64
    values themselves (the numbers the plain versions multiply by)."""

    def braces(x, f32: bool) -> str:
        if np.ndim(x) == 0:
            return float(np.float32(x)).hex() + "f" if f32 else float(x).hex()
        return "{" + ", ".join(braces(v, f32) for v in x) + "}"

    rows = (tableau.DP_A, tableau.DP_C, tableau.DP_B, tableau.DP_E, tableau.DP_P)
    out = "// Written by tiger_tpu_torch/kernels/_build.py from solver/tableau.py.\n#pragma once\n"
    for name, f32 in (("TT_DP_TABLEAU", True), ("TT_DP_TABLEAU_F64", False)):
        body = ", \\\n    ".join(braces(np.asarray(r, np.float64), f32) for r in rows)
        out += f"#define {name} \\\n  {{ \\\n    " + body + " \\\n  }\n"
    return out


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
    nvcc, compile_flags = _nvcc(), [f for f in flags if f != "-shared"]
    arch = [f for f in flags if f.startswith(("-gencode", "arch="))] + ["-Xcompiler", "-fPIC"]
    kernels = [p for p in sorted(CSRC.glob("*.cu")) if p.name not in (CONTRACTED, LIBM_CHECK)]
    objects = {p.stem: include / f"{p.stem}.o" for p in kernels}
    common = [nvcc, *compile_flags, "-I", str(include), "-c"]
    # Every compile at once, then the device link of the relocatable code,
    # then the library.
    rdc = {include / "contracted.o": [nvcc, *(f for f in compile_flags if f != "-fmad=false"),
                                      "-rdc=true", "-c", str(CSRC / CONTRACTED)]}
    for p in kernels:
        for suffix, defines in INSTANCE_DEFINES.items():
            rdc[include / f"{p.stem}_{suffix}.o"] = [*common, "-rdc=true", *defines, str(p)]
    dlink = include / "dlink.o"
    compiles = [[*cmd, "-o", str(obj)] for obj, cmd in rdc.items()]
    compiles += [[*common, "-o", str(objects[p.stem]), str(p)] for p in kernels]
    links = (
        [nvcc, *arch, "-dlink", "-o", str(dlink), *map(str, rdc)],
        [nvcc, *flags, "-o", tmp, *map(str, objects.values()), *map(str, rdc), str(dlink)],
    )
    seconds, log = _run(compiles, links, tmp)
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return lib_path, seconds, log


def _run(compiles: list, links: tuple, out: str) -> tuple[float, str]:
    """Every compile at once, then each link in turn; (seconds, log).
    Removes ``out`` and raises if a command fails."""
    start = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    results = [(proc.returncode, out) for proc in procs for out in [proc.communicate()[0]]]
    for cmd in links:
        if all(rc == 0 for rc, _ in results):
            proc = subprocess.run(cmd, capture_output=True, text=True)
            results.append((proc.returncode, proc.stdout + proc.stderr))
    seconds = time.perf_counter() - start
    log = "".join(text for _, text in results)
    failed = [rc for rc, _ in results if rc != 0]
    if failed:
        os.unlink(out)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
    return seconds, log


def build_libm_check(flags: tuple[str, ...] = NVCC_FLAGS) -> tuple[Path, float]:
    """``csrc/libm_check.cu`` alone, as relocatable code under ``flags``
    (the Model 200 instances' build), device-linked into a library of its
    own; reused while the sources and flags stay.  (library path, seconds
    spent compiling)."""
    digest = source_hash(flags + (LIBM_CHECK,))
    lib_path = BUILD_DIR / f"libtiger_libm_check_{digest}.so"
    if lib_path.exists():
        return lib_path, 0.0
    work = BUILD_DIR / f"libm_check_{digest}"
    work.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    nvcc, obj, dlink = _nvcc(), work / "libm_check.o", work / "dlink.o"
    arch = [f for f in flags if f.startswith(("-gencode", "arch="))] + ["-Xcompiler", "-fPIC"]
    compiles = [[nvcc, *(f for f in flags if f != "-shared"), "-rdc=true", "-c", "-o", str(obj),
                 str(CSRC / LIBM_CHECK)]]
    links = ([nvcc, *arch, "-dlink", "-o", str(dlink), str(obj)],
             [nvcc, *flags, "-o", tmp, str(obj), str(dlink)])
    seconds, _ = _run(compiles, links, tmp)
    os.replace(tmp, lib_path)
    return lib_path, seconds


def load() -> ctypes.CDLL:
    """The kernel library of the flags in use (``NVCC_FLAGS`` outside
    ``flags_in_use``), built at first use and cached for the process."""
    lib = _libs.get(_flags_in_use)
    if lib is None:
        path, _, _ = build(_flags_in_use)
        lib = ctypes.CDLL(str(path))
        # The int32 argument of each entry point picks the scalar: 0 float, 1 double.
        for name in ("tt_rk45_launch", "tt_radau_launch"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.tt_rk45_geometry.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                                         ctypes.c_int32, ctypes.c_void_p]
        lib.tt_rk45_geometry.restype = ctypes.c_int
        for name in ("tt_rk45_args_size", "tt_radau_args_size"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_int32]
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

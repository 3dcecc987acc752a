"""Native (C++) host data path bindings via ctypes.

A copy of ``tiger_tpu/native``: single-pass CSV column parsing and the
grid->systems forcing gather, in ``csv_loader.cpp``.  At first use the
library is built with ``make`` into ``build/tiger_tpu_torch/`` at the
repository root (named by a hash of the source, so an edited source
rebuilds), never beside its source.  Every entry point has a numpy
fallback: callers (``params``, ``forcing``) catch ImportError and use it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "tiger_tpu_torch"
_LIB = None


def library_path() -> Path:
    """Where the library of the current ``csv_loader.cpp`` is built."""
    digest = hashlib.sha256((_DIR / "csv_loader.cpp").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libtiger_native_{digest}.so"


def _build(so: Path) -> None:
    """Build ``so`` with the Makefile: into a name of this process's own,
    then renamed, so that processes building side by side never load a
    half-written file."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["make", "-C", str(_DIR), "-s", f"OUT={tmp}"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError) as e:  # no toolchain: numpy
        raise ImportError(f"native library unavailable: {e}")
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not so.exists():
        _build(so)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        # An incompatible or corrupt .so surfaces as the ImportError the
        # module contract promises (callers fall back to numpy on it).
        raise ImportError(f"native library unloadable: {e}")
    lib.tt_csv_count_rows.restype = ctypes.c_long
    lib.tt_csv_count_rows.argtypes = [ctypes.c_char_p]
    lib.tt_csv_parse.restype = ctypes.c_long
    lib.tt_csv_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_long,
    ]
    lib.tt_remap_gather.restype = None
    lib.tt_remap_gather.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    _LIB = lib
    return lib


def load_csv_columns(path: str, columns: Sequence[str]) -> Dict[str, np.ndarray]:
    """Parse the named columns of a header-indexed CSV into float64 arrays."""
    lib = _load()
    n_rows = lib.tt_csv_count_rows(path.encode())
    if n_rows < 0:
        raise IOError(f"Cannot read {path}")
    cols = list(columns)
    arrs = [np.empty(n_rows, np.float64) for _ in cols]
    c_names = (ctypes.c_char_p * len(cols))(*[c.encode() for c in cols])
    c_out = (ctypes.POINTER(ctypes.c_double) * len(cols))(
        *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) for a in arrs]
    )
    parsed = lib.tt_csv_parse(path.encode(), c_names, len(cols), c_out, n_rows)
    if parsed == -2:
        raise ValueError(f"Missing one of columns {cols} in {path}")
    if parsed == -4:
        raise ValueError(
            f"Non-numeric or empty field in a requested column of {path} "
            "(reference std::stod would throw; refusing to load as 0.0)"
        )
    if parsed < 0:
        raise IOError(f"Failed parsing {path} (code {parsed})")
    return {c: a[:parsed] for c, a in zip(cols, arrs)}


def remap_gather(grid: np.ndarray, flat_index: np.ndarray) -> np.ndarray:
    """out[t, s] = grid.reshape(T, -1)[t, flat_index[s]] (native gather)."""
    lib = _load()
    n_t = grid.shape[0]
    flat = np.ascontiguousarray(grid.reshape(n_t, -1), np.float32)
    idx = np.ascontiguousarray(flat_index, np.int64)
    if len(idx) and (idx.min() < 0 or idx.max() >= flat.shape[1]):
        # The C gather is unchecked: an out-of-range index would read past
        # the buffer, so match the numpy path's error.
        raise IndexError(
            f"flat_index outside [0, {flat.shape[1]}) for the given grid"
        )
    out = np.empty((n_t, len(idx)), np.float32)
    lib.tt_remap_gather(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_t,
        flat.shape[1],
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(idx),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out

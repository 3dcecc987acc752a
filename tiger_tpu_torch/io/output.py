"""Result writers: NetCDF (primary) and CSV (legacy/parity artifact format).

The unchunked writers of ``tiger_tpu/io/output.py``, writing the same files
for the same arrays (NETCDF4 where h5py is installed, else classic NetCDF:
``netcdf.open_writer``).  Dense output may be a torch tensor on the card:
the NetCDF writer streams it slab by slab, and the int16 packing runs on
its device.

The windowed writers (``WindowedVarWriter``, ``WindowedPackedWriter``)
fill a file sized up front, window by window, for chunked runs.

NetCDF layouts mirror the reference (src/I_O/output_series.cpp:18-124):
  - final:  dims (system, variable); int coord vars ``system`` (LinkID,
    long_name "LinkID") and ``variable``; data var ``outputs``.
  - dense:  dims (system, time, variable); double coord ``time`` with units
    "minutes since start of simulation"; data var ``outputs``; optional
    gzip deflate.

CSV layouts match the writers that produced the reference's golden
artifacts (src/main.cpp:734-773): final header ``h_snow,var1..var4`` one row
per system; dense header ``time,var{i}_sys{s}...`` with time at fixed 8
decimals and values at 9 significant digits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tiger_tpu_torch.io.netcdf import _to_host, open_writer
from tiger_tpu_torch.profiling import metrics_span


def _def_output_dims(w, link_ids, query_times=None, state_ids=None):
    """Shared dimension/coordinate boilerplate of every output layout."""
    w.def_dim("system", len(link_ids), np.asarray(link_ids, np.int32), np.int32)
    w.set_dim_attrs("system", {"long_name": "LinkID"})
    if query_times is not None:
        w.def_dim("time", len(query_times), np.asarray(query_times, np.float64), np.float64)
        w.set_dim_attrs(
            "time", {"long_name": "Time", "units": "minutes since start of simulation"}
        )
    if state_ids is not None:
        w.def_dim("variable", len(state_ids), np.asarray(state_ids, np.int32), np.int32)
        w.set_dim_attrs(
            "variable", {"long_name": "state variable", "units": "various units"}
        )


def write_final_netcdf(
    path: str,
    y_final,  # [S, N] array or tensor
    link_ids: np.ndarray,  # [S]
    state_ids: Optional[np.ndarray] = None,
    compression_level: int = 0,
    dtype=None,
) -> None:
    """Final-state file: dims (system, variable).

    ``dtype=None`` preserves the input precision; pass ``np.float64`` for
    reference-identical files.
    """
    s_count, n_eq = y_final.shape
    if state_ids is None:
        state_ids = np.arange(n_eq, dtype=np.int32)
    with open_writer(path) as w:
        _def_output_dims(w, link_ids, state_ids=state_ids)
        w.def_var("outputs", y_final, ("system", "variable"), compression_level, dtype=dtype)


def write_dense_netcdf(
    path: str,
    dense,  # [S, Q, N] array or tensor
    query_times: np.ndarray,  # [Q] minutes
    link_ids: np.ndarray,  # [S]
    state_ids: Optional[np.ndarray] = None,
    compression_level: int = 0,
    dtype=None,
) -> None:
    """Dense-output file: dims (system, time, variable).

    ``dtype`` as in write_final_netcdf.  A tensor on the card is not pulled
    here; the writer streams it slab by slab.
    """
    s_count, n_q, n_eq = dense.shape
    if state_ids is None:
        state_ids = np.arange(n_eq, dtype=np.int32)
    with open_writer(path) as w:
        _def_output_dims(w, link_ids, query_times, state_ids)
        w.def_var("outputs", dense, ("system", "time", "variable"), compression_level, dtype=dtype)


def _pack_cf_int16(dense: torch.Tensor):
    """CF quantization on the tensor's device: per-state int16 codes + f32
    scale/offset, the JAX package's codes exactly.

    Non-finite samples map to the CF fill value -32767; codes use the
    symmetric range [-32766, 32766].  Every division is by a tensor: on the
    card torch turns a division by a Python number into a product with its
    reciprocal, which would round otherwise than XLA.
    """
    x = dense.to(torch.float32)
    dev = x.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    finite = torch.isfinite(x)
    big = f32(3.4e38)
    lo = torch.where(finite, x, big).amin(dim=(0, 1))
    hi = torch.where(finite, x, -big).amax(dim=(0, 1))
    lo, hi = torch.minimum(lo, hi), torch.maximum(lo, hi)  # all-NaN state: lo>hi
    # Divide before subtracting: hi-lo overflows float32 to inf when a state
    # spans huge-but-finite magnitudes; hi/65532 - lo/65532 cannot.
    n_codes = f32(65532.0)
    scale = torch.maximum(hi / n_codes - lo / n_codes, f32(1e-30))
    offset = hi * 0.5 + lo * 0.5
    q = torch.clamp(torch.round((x - offset) / scale), -32766.0, 32766.0)
    q = torch.where(finite, q.to(torch.int16), torch.tensor(-32767, dtype=torch.int16, device=dev))
    return q, scale, offset


def write_dense_netcdf_packed(
    path: str,
    dense,  # [S, Q, N] tensor (on the card welcome) or array
    query_times: np.ndarray,  # [Q] minutes
    link_ids: np.ndarray,  # [S]
    state_ids: Optional[np.ndarray] = None,
    compression_level: int = 0,
) -> None:
    """CF int16-packed dense output (``output.precision: i16``).

    scale_factor/add_offset/_FillValue per variable, as ERA5 files carry
    them; since a NetCDF scale is a scalar per variable and the states'
    ranges differ by orders of magnitude, each state is its own var
    ``outputs_<state_id>`` with dims (system, time).  Quantized on the
    dense tensor's device, so the host pull moves 2 bytes a sample.
    """
    s_count, n_q, n_eq = dense.shape
    if state_ids is None:
        state_ids = np.arange(n_eq, dtype=np.int32)
    if not torch.is_tensor(dense):
        dense = torch.as_tensor(np.asarray(dense))
    q, scale, offset = _pack_cf_int16(dense)
    scale = scale.cpu().numpy().astype(np.float64)
    offset = offset.cpu().numpy().astype(np.float64)
    with open_writer(path) as w:
        _def_output_dims(w, link_ids, query_times)
        for v in range(n_eq):
            w.def_var(
                f"outputs_{int(state_ids[v])}",
                q[:, :, v],
                ("system", "time"),
                compression_level,
                attrs={
                    "scale_factor": scale[v],
                    "add_offset": offset[v],
                    "_FillValue": np.int16(-32767),
                    "long_name": f"state variable {int(state_ids[v])}",
                    "units": "various units",
                },
            )


def _pack_cf_int16_declared(dense: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor):
    """CF int16 codes with DECLARED per-state scale/offset, on the tensor's
    device: the streaming variant of ``_pack_cf_int16``.

    Windowed runs cannot derive global ranges from windows not solved yet,
    so the ranges come from the config (output.i16_ranges) and scale and
    offset are constant over the record.  ``scale`` and ``offset`` are
    float32 tensors [N] on the block's device (a division by a tensor, as
    in ``_pack_cf_int16``).  Values outside the declared range saturate at
    the code limits; non-finite samples map to the fill value -32767.
    """
    x = dense.to(torch.float32)
    finite = torch.isfinite(x)
    q = torch.clamp(torch.round((x - offset) / scale), -32766.0, 32766.0)
    return torch.where(finite, q.to(torch.int16),
                       torch.tensor(-32767, dtype=torch.int16, device=x.device))


def _start_pull(block):
    """Start a block's device->host copy: (host tensor or array, event or
    None).  A CUDA tensor is copied on the caller's current stream into
    pinned host memory without waiting; the event marks the copy's end.
    ``record_stream`` keeps the caching allocator from handing the block to
    another stream's allocation before the copy has read it."""
    if torch.is_tensor(block) and block.is_cuda:
        stream = torch.cuda.current_stream(block.device)
        host = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
        host.copy_(block, non_blocking=True)
        block.record_stream(stream)
        done = torch.cuda.Event()
        done.record(stream)
        return host, done
    return block, None


class _OneInFlight:
    """The device->host pull and the file write of one window at a time,
    on one worker thread: ``submit`` waits for the previous window's write
    (backpressure), starts this block's copy and hands the write to the
    worker, which waits for the copy and stores the host array."""

    def __init__(self, metrics=None):
        from concurrent.futures import ThreadPoolExecutor

        self._ex = ThreadPoolExecutor(max_workers=1)
        self._pending = None
        self._metrics = metrics

    def submit(self, q0: int, block, store) -> None:
        self.wait()
        host, done = _start_pull(block)

        def pull_write():
            with metrics_span(self._metrics, "write", q0):
                if done is not None:
                    done.synchronize()
                store(_to_host(host))

        self._pending = self._ex.submit(pull_write)

    def wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def flush(self, f) -> None:
        """Wait for the window in flight, then make the file durable."""
        with metrics_span(self._metrics, "flush", -1):
            self.wait()
            f.flush()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._ex.shutdown(wait=True)


def _check_resumed_coords(f, path, link_ids, query_times) -> None:
    """A re-opened file must hold the run's links and query grid: shapes
    matching is not enough, a changed config can hit the same counts while
    meaning other links or times."""
    for dim, vals in (
        ("system", np.asarray(link_ids, np.int32)),
        ("time", np.asarray(query_times, np.float64)),
    ):
        if dim in f and not np.array_equal(np.asarray(f[dim]), vals):
            raise ValueError(
                f"resume coordinate mismatch for {path}:{dim} — "
                "the run's links/query grid differ from the file's"
            )


class WindowedVarWriter:
    """Incremental NetCDF writer for windowed (chunked) runs.

    Creates the dense layout of write_dense_netcdf (or the 2-D discharge
    layout when ``state_ids is None``) with the full time extent up front,
    then fills time slices window by window with :meth:`write`: the whole
    [S, Q_total, N] array never exists, on the device or on the host.
    NETCDF4 through h5py where it is installed, else classic NetCDF written
    in place (``io.netcdf.ClassicStreamWriter``).

    ``write(q0, block)`` takes a tensor on any device (or an array); the
    copy to pinned host memory starts on the caller's current stream, and
    the wait for it and the file write run on one worker thread with one
    window in flight, so window k's output overlaps window k+1's solve.
    """

    def __init__(
        self,
        path: str,
        var_name: str,
        link_ids: np.ndarray,  # [S]
        query_times: np.ndarray,  # [Q_total] minutes
        state_ids: Optional[np.ndarray] = None,  # None -> 2-D (system, time)
        compression_level: int = 0,
        dtype=np.float32,
        attrs: Optional[dict] = None,
        resume: bool = False,
        metrics=None,
    ):
        """``resume=True`` re-opens an existing file of an interrupted run
        (full time extent already defined; earlier windows kept) and checks
        its shape, type and coordinates instead of recreating it."""
        from tiger_tpu_torch.io.netcdf import open_windowed_writer, reopen_windowed

        s_count, n_q = len(link_ids), len(query_times)
        self._dtype = np.dtype(dtype)
        want = (s_count, n_q) if state_ids is None else (s_count, n_q, len(state_ids))
        if resume:
            f = reopen_windowed(path)
            try:
                if var_name not in f:
                    raise KeyError(f"resume file {path} has no variable {var_name!r}")
                ds = f[var_name]
                if tuple(ds.shape) != want:
                    raise ValueError(
                        f"resume shape mismatch for {path}:{var_name}: file "
                        f"has {tuple(ds.shape)}, run needs {want}"
                    )
                _check_resumed_coords(f, path, link_ids, query_times)
                if ds.dtype != self._dtype:
                    raise ValueError(
                        f"resume dtype mismatch for {path}:{var_name}: file "
                        f"has {ds.dtype}, run writes {self._dtype}"
                    )
            except Exception:
                f.close()
                raise
            self._w, self._ds = f, ds
        else:
            self._w = open_windowed_writer(path)
            _def_output_dims(self._w, link_ids, query_times, state_ids)
            dims = ("system", "time") if state_ids is None else ("system", "time", "variable")
            self._ds = self._w.def_var_empty(var_name, want, dims, self._dtype,
                                             compression_level, attrs)
            self._w.end_define()
        self._pipe = _OneInFlight(metrics)

    def write(self, q0: int, block) -> None:
        """Fill time slice [q0, q0+block.shape[1]) (block: [S, Qw(, N)])."""

        def store(host):
            self._ds[:, q0 : q0 + host.shape[1]] = np.asarray(host, self._dtype)

        self._pipe.submit(q0, block, store)

    def flush(self) -> None:
        """Block until every submitted window is on disk (checkpoint barrier)."""
        self._pipe.flush(self._w)

    def close(self) -> None:
        # Close the file whatever the pending write raised: re-raising first
        # would leak the worker and the handle, and mask the original error
        # when close() runs during exception unwinding.
        try:
            self._pipe.close()
        finally:
            self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class WindowedPackedWriter:
    """Incremental CF int16-packed dense writer for windowed (chunked) runs.

    Streaming counterpart of write_dense_netcdf_packed: one ``outputs_<id>``
    int16 variable per output state with config-declared scale/offset
    (output.i16_ranges), filled time slice by time slice.  The codes are
    computed on the block's device, so the host pull moves 2 bytes a sample.
    Same write/flush/close discipline and backends as WindowedVarWriter.
    """

    def __init__(
        self,
        path: str,
        link_ids: np.ndarray,  # [S]
        query_times: np.ndarray,  # [Q_total] minutes
        state_ids: np.ndarray,
        ranges: dict,  # state id -> (lo, hi), validated by the config loader
        compression_level: int = 0,
        resume: bool = False,
        metrics=None,
    ):
        from tiger_tpu_torch.io.netcdf import open_windowed_writer, reopen_windowed

        s_count, n_q = len(link_ids), len(query_times)
        self._state_ids = np.asarray(state_ids, np.int32)
        lo = np.array([ranges[int(v)][0] for v in self._state_ids], np.float64)
        hi = np.array([ranges[int(v)][1] for v in self._state_ids], np.float64)
        self._scale = np.maximum((hi - lo) / 65532.0, 1e-30)
        self._offset = (hi + lo) / 2.0
        self._consts: dict = {}  # device -> (scale, offset) float32 tensors
        names = [f"outputs_{int(v)}" for v in self._state_ids]
        if resume:
            f = reopen_windowed(path)
            try:
                for name, sc, off in zip(names, self._scale, self._offset):
                    if name not in f:
                        raise KeyError(f"resume file {path} has no {name!r}")
                    ds = f[name]
                    if tuple(ds.shape) != (s_count, n_q) or ds.dtype != np.int16:
                        raise ValueError(
                            f"resume mismatch for {path}:{name}: file has "
                            f"{tuple(ds.shape)}/{ds.dtype}, run needs "
                            f"{(s_count, n_q)}/int16"
                        )
                    if not (np.isclose(ds.attrs["scale_factor"], sc)
                            and np.isclose(ds.attrs["add_offset"], off)):
                        raise ValueError(
                            f"resume packing mismatch for {path}:{name} — "
                            "output.i16_ranges differ from the original run's"
                        )
                _check_resumed_coords(f, path, link_ids, query_times)
            except Exception:
                f.close()
                raise
            self._w = f
            self._ds = [f[name] for name in names]
        else:
            self._w = open_windowed_writer(path)
            _def_output_dims(self._w, link_ids, query_times, self._state_ids)
            self._ds = [
                self._w.def_var_empty(
                    name, (s_count, n_q), ("system", "time"), np.int16, compression_level,
                    attrs={
                        "scale_factor": sc,
                        "add_offset": off,
                        "_FillValue": np.int16(-32767),
                        "long_name": f"state variable {int(v)}",
                        "units": "various units",
                    },
                )
                for name, v, sc, off in zip(names, self._state_ids, self._scale, self._offset)
            ]
            self._w.end_define()
        self._pipe = _OneInFlight(metrics)

    def _pack(self, block: torch.Tensor) -> torch.Tensor:
        dev = block.device
        if dev not in self._consts:
            self._consts[dev] = tuple(
                torch.tensor(a.astype(np.float32), device=dev) for a in (self._scale, self._offset)
            )
        return _pack_cf_int16_declared(block, *self._consts[dev])

    def write(self, q0: int, block) -> None:
        """Quantize and fill time slice [q0, q0+Qw) (block: [S, Qw, N])."""
        if not torch.is_tensor(block):
            block = torch.as_tensor(np.asarray(block))
        codes = self._pack(block)

        def store(host):
            for v, ds in enumerate(self._ds):
                ds[:, q0 : q0 + host.shape[1]] = host[:, :, v]

        self._pipe.submit(q0, codes, store)

    def flush(self) -> None:
        self._pipe.flush(self._w)

    def close(self) -> None:
        try:
            self._pipe.close()
        finally:
            self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_final_csv(path: str, y_final, header: str = "model204") -> None:
    """Legacy final CSV (main.cpp:736-752).  header='model204' -> h_snow,var1..;
    header='vars' -> Var0..Var4 (dummy artifacts)."""
    y_final = _to_host(y_final)
    n_eq = y_final.shape[1]
    if header == "model204":
        cols = ["h_snow"] + [f"var{i}" for i in range(1, n_eq)]
    else:
        cols = [f"Var{i}" for i in range(n_eq)]
    fmt = "{:.6g}".format  # std::ostream default formatting: 6 significant digits
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for row in y_final.tolist():
            f.write(",".join(map(fmt, row)) + "\n")


def write_dense_csv(
    path: str,
    dense,  # [S, Q, N] array or tensor
    query_times: np.ndarray,
    var_prefix: str = "var",
) -> None:
    """Legacy dense CSV (main.cpp:755-773): time fixed 8 decimals, values 9
    significant digits; one row per query time, one column per system and
    state, system-major."""
    dense = _to_host(dense)
    s_count, n_q, n_eq = dense.shape
    # One %-format of a row's values: the text of "{:.9g}".format of each,
    # in C rather than one Python call a value.
    row_fmt = ",%.9g" * (s_count * n_eq) + "\n"
    with open(path, "w") as f:
        cols = ["time"] + [
            f"{var_prefix}{i}_sys{s}" for s in range(s_count) for i in range(n_eq)
        ]
        f.write(",".join(cols) + "\n")
        for q in range(n_q):
            # tolist() gives Python floats of the same values, formatted as
            # numpy's scalars format themselves.
            f.write(f"{query_times[q]:.8f}" + row_fmt % tuple(dense[:, q, :].ravel().tolist()))

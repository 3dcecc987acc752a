"""Time-chunked solving: stream long forcing records through bounded memory.

Port of ``tiger_tpu/chunked.py``.  A year of hourly forcing and dense
output cannot sit on the device beside the solver state, so:

  - the simulation span [t0, tf] is split into windows of ``chunk_minutes``;
  - each window's forcing block is read from NetCDF, remapped and shipped to
    the device on a worker thread while the previous window integrates;
  - each window runs ``solve()`` as a hot start from the previous window's
    final state; window boundaries land on query times, so the dense output
    is seamless;
  - each window's dense and routed blocks go to ``dense_sink`` (the windowed
    writers) on another worker thread instead of piling up on the device.

Forcing gathers inside window k index time relative to the window start,
which equals the absolute zero-order-hold series when ``chunk_minutes`` and
t0 are multiples of every forcing dt (checked).  Step sequences differ from
an unchunked run's (integration restarts at each window edge) within the
controller's tolerance.

On the card the worker threads must not queue behind the solve.  A thread's
current stream is the device's default stream, where the main thread
launches window k+1's kernels, so the loader uploads and remaps on a stream
of its own, and the sink thread's work (state selection, int16 packing, the
copies to pinned host memory) runs on a copy stream that waits only for an
event recorded when window k's outputs are final.  ``record_stream`` keeps
the caching allocator from reusing a block before the other stream is done
with it.  None of this adds a host sync: each window syncs once, at
``solve()``'s stiff count.
"""

from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tiger_tpu_torch.forcing import ForcingSet
from tiger_tpu_torch.profiling import metrics_span
from tiger_tpu_torch.solver.api import SolveResult, solve
from tiger_tpu_torch.solver.config import SolverConfig
from tiger_tpu_torch.solver.rk45 import RKStats

#: Windows whose outputs may wait for the sink thread at once: each pins its
#: dense and routed blocks on the device, so a stalled writer throttles the
#: solve instead of filling the card.
MAX_IN_FLIGHT = 4


def _carry_update(y_prev, y_final, stiff_any, stiff, failed_any, failed, rk_stats, new_stats):
    """Per-window carry: a system with no final state (NaN) keeps the
    previous window's; flags OR-ed, counters summed."""
    y = torch.where(torch.isnan(y_final), y_prev, y_final)
    stats = RKStats(*(a + b for a, b in zip(rk_stats, new_stats)))
    return y, stiff_any | stiff, failed_any | failed, stats


def solve_chunked(
    model,
    y0: torch.Tensor,
    t0: float,
    tf: float,
    chunk_minutes: float,
    load_window: Callable[[float, float], Optional[ForcingSet]],
    query_interval: Optional[float] = None,
    params: Optional[dict] = None,
    config: SolverConfig = SolverConfig(),
    topology=None,
    routed_fn=None,
    dense_sink=None,
    state_sink=None,
    metrics=None,
):
    """Integrate [t0, tf] in windows of ``chunk_minutes`` on ``y0``'s device.

    ``load_window(w_start, w_end)`` returns the ForcingSet covering that
    absolute window on y0's device (its row 0 is time ``w_start``), or None
    for unforced runs.  ``query_interval`` (minutes) gives dense output as
    an unchunked run with queries every interval would.

    With ``topology`` (a routing.Topology) each window's routed discharge is
    computed right after its solve; returns (SolveResult, routed [S, Q]),
    else the SolveResult.  ``routed_fn(dense_w) -> [S, Q_w]``, when given,
    routes each window in place of the topology's routing (several
    processes: ``run._make_cross_rank_routed``, whose collectives every rank
    reaches once a window, in window order); the return is the same pair.

    ``dense_sink(q0, qt_abs, dense_w, routed_w)``, when given, receives each
    window's dense block (and routed block, or None) instead of keeping it
    on the device: ``q0`` is the window's first index on the global query
    grid, ``qt_abs`` its absolute query times.  The result's dense (and
    routed) arrays are then empty.  ``state_sink(t_abs, y)`` is called after
    each window with its absolute end time and the carried state [S, N],
    after that window's ``dense_sink``.  Both run on one worker thread in
    window order, at most MAX_IN_FLIGHT windows behind the solve.

    ``metrics`` (a profiling.Metrics) collects host spans of every thread
    and, on the card, each window's device span (``Metrics.spans``).
    """
    if chunk_minutes <= 0:
        raise ValueError("chunk_minutes must be positive")
    n_windows = max(1, math.ceil((tf - t0) / chunk_minutes - 1e-9))

    y = y0
    dev = y.device
    s_count, n_eq = y.shape
    cuda = dev.type == "cuda"
    all_dense, all_routed = [], []
    stiff_any = torch.zeros((s_count,), dtype=torch.bool, device=dev)
    failed_any = torch.zeros((s_count,), dtype=torch.bool, device=dev)
    n_stiff_total = 0
    rk_stats = None
    load_stream = torch.cuda.Stream(dev) if cuda else None
    copy_stream = torch.cuda.Stream(dev) if cuda else None
    # Device spans on the host clock: an event recorded on an idle device
    # anchors the events' clock to time.perf_counter.
    marks, anchor = [], None
    if cuda and metrics is not None:
        anchor = torch.cuda.Event(enable_timing=True)
        anchor.record()
        anchor.synchronize()
        t_anchor = time.perf_counter()

    def _bounds(w):
        w_start = t0 + w * chunk_minutes
        return w_start, min(tf, w_start + chunk_minutes)

    def _load(w):
        with metrics_span(metrics, "load", w):
            if load_stream is None:
                return load_window(*_bounds(w)), None
            with torch.cuda.stream(load_stream):
                forcings = load_window(*_bounds(w))
                loaded = torch.cuda.Event()
                loaded.record(load_stream)
            return forcings, loaded

    def _sink_call(w, fn, ready, args):
        with metrics_span(metrics, "sink", w):
            if ready is None:
                return fn(*args)
            with torch.cuda.stream(copy_stream):
                copy_stream.wait_event(ready)
                return fn(*args)

    # Window k+1's forcing loads on one worker while window k integrates;
    # window k's outputs are written on another.  One worker each keeps
    # both pipelines in window order.
    executor = ThreadPoolExecutor(max_workers=1)
    sink_executor = ThreadPoolExecutor(max_workers=1)
    sink_futs: list = []

    def _submit_sink(w, ready, fn, *args):
        # Completed futures are drained without blocking, so an output error
        # surfaces within a window or two, not only at the end.
        while sink_futs and sink_futs[0].done():
            sink_futs.pop(0).result()
        while len(sink_futs) >= MAX_IN_FLIGHT:
            sink_futs.pop(0).result()
        sink_futs.append(sink_executor.submit(_sink_call, w, fn, ready, args))

    try:
        fut = executor.submit(_load, 0)
        for w in range(n_windows):
            with metrics_span(metrics, "window", w):
                w_start, w_end = _bounds(w)
                forcings, loaded = fut.result()
                if w + 1 < n_windows:
                    fut = executor.submit(_load, w + 1)
                if loaded is not None:
                    main = torch.cuda.current_stream(dev)
                    main.wait_event(loaded)
                    if forcings is not None:
                        forcings.data.record_stream(main)

                if w == 0 and forcings is not None:
                    # The window-relative gather equals the absolute ZOH series
                    # only when window boundaries land on forcing-sample
                    # boundaries; t0 must itself be dt-aligned (a custom
                    # load_window is not checked per window).
                    for dt_min in forcings.meta.dt_min:
                        for what, val in (("chunk_minutes", chunk_minutes), ("t0", t0)):
                            if abs(val / dt_min - round(val / dt_min)) > 1e-9:
                                raise ValueError(
                                    f"{what}={val} is not a multiple of forcing "
                                    f"dt={dt_min} min; window-relative forcing "
                                    "gathers would diverge from the unchunked series"
                                )

                qt = None
                if query_interval is not None:
                    # Queries in (w_start, w_end], window-relative; window 0 also
                    # carries the t0 query.  The first index is the first
                    # multiple of query_interval strictly after w_start, computed
                    # in float64 on the host before the cast to the solve dtype.
                    lo_idx = (
                        0 if w == 0
                        else math.floor((w_start - t0) / query_interval + 1e-9) + 1
                    )
                    hi_idx = math.floor((w_end - t0) / query_interval + 1e-9)
                    qt_abs = np.arange(lo_idx, hi_idx + 1) * query_interval + t0
                    qt = torch.from_numpy(qt_abs - w_start).to(y.dtype)
                    qt = qt.pin_memory().to(dev, non_blocking=True) if cuda else qt

                if anchor is not None:
                    started = torch.cuda.Event(enable_timing=True)
                    started.record()
                with metrics_span(metrics, "solve", w):
                    res = solve(
                        model, y, 0.0, w_end - w_start, qt, params=params, forcings=forcings,
                        config=config,
                        # Window time is relative; a model that reads t sees the
                        # absolute simulation time.
                        t_shift=w_start,
                    )
                    if rk_stats is None:
                        rk_stats = RKStats(*(torch.zeros_like(v) for v in res.rk_stats))
                    y, stiff_any, failed_any, rk_stats = _carry_update(
                        y, res.y_final, stiff_any, res.stiff, failed_any, res.failed,
                        rk_stats, res.rk_stats,
                    )
                    routed_w = None
                    if qt is not None and routed_fn is not None:
                        routed_w = routed_fn(res.dense)
                    elif qt is not None and topology is not None:
                        from tiger_tpu_torch.routing import routed_discharge

                        routed_w = routed_discharge(res.dense, params, topology)
                    if anchor is not None:
                        finished = torch.cuda.Event(enable_timing=True)
                        finished.record()
                        marks.append((w, started, finished))

                # Window k's outputs are final here: the sink thread's copy
                # stream waits for this event, and nothing else.
                ready = None
                if cuda and (dense_sink is not None or state_sink is not None):
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(dev))
                    for t in (res.dense, routed_w, y):
                        if t is not None:
                            t.record_stream(copy_stream)
                if qt is not None:
                    if dense_sink is not None:
                        _submit_sink(w, ready, dense_sink, lo_idx, qt_abs, res.dense, routed_w)
                    else:
                        all_dense.append(res.dense)
                        if routed_w is not None:
                            all_routed.append(routed_w)
                if state_sink is not None:
                    _submit_sink(w, ready, state_sink, w_end, y)
                n_stiff_total += res.n_stiff
        for f in sink_futs:
            f.result()
    finally:
        executor.shutdown(wait=True)
        sink_executor.shutdown(wait=True)

    if marks:
        marks[-1][2].synchronize()
        for w, started, finished in marks:
            metrics.spans.append(("device", w, t_anchor + anchor.elapsed_time(started) * 1e-3,
                                  t_anchor + anchor.elapsed_time(finished) * 1e-3))
    dense = (
        torch.cat(all_dense, dim=1)
        if all_dense
        else torch.zeros((s_count, 0, n_eq), dtype=y.dtype, device=dev)
    )
    result = SolveResult(
        y_final=y,
        dense=dense,
        stiff=stiff_any,
        failed=failed_any,
        rk_stats=rk_stats,
        radau_stats=None,
        n_stiff=n_stiff_total,
    )
    if topology is not None or routed_fn is not None:
        routed = (
            torch.cat(all_routed, dim=1)
            if all_routed
            else torch.zeros((s_count, 0), dtype=y.dtype, device=dev)
        )
        return result, routed
    return result


def netcdf_window_loader(
    specs: Sequence,
    stream_ids: np.ndarray,
    lookup_csv: str,
    device: torch.device | str = "cuda",
) -> Callable[[float, float], ForcingSet]:
    """Window loader over NetCDF files: reads only the window's time steps.

    Returns a ``load_window`` for solve_chunked: each call reads the time
    steps of [w_start, w_end) of every forcing (NetCDFReader.load_time_chunk),
    checks the lookup against the grid and the cells for missing values on
    the host, and remaps on ``device`` (ForcingSet.from_grid_series).
    """
    from tiger_tpu_torch.forcing import _check_flat_bounds, _check_remap_finite
    from tiger_tpu_torch.io.lookup import LookupTable
    from tiger_tpu_torch.io.netcdf import NetCDFReader

    luts = {
        p: LookupTable.load(p)
        for p in {getattr(s, "lookup", None) or lookup_csv for s in specs}
    }
    flat_cache: dict = {}  # (lookup, lon_size) -> [S] cell index

    def load_window(w_start: float, w_end: float) -> ForcingSet:
        grids, dts, flats = [], [], []
        for spec in specs:
            lut_key = getattr(spec, "lookup", None) or lookup_csv
            dt_min = spec.dt_hours * 60.0
            if abs((w_start / dt_min) - round(w_start / dt_min)) > 1e-9:
                raise ValueError(
                    f"window start {w_start} min not aligned to forcing dt {dt_min} min"
                )
            k0 = int(round(w_start / dt_min))
            k1 = int(math.ceil(w_end / dt_min - 1e-9))
            with NetCDFReader(spec.path, spec.var) as rd:
                k0c = min(k0, rd.time_size - 1)
                k1c = min(max(k1, k0c + 1), rd.time_size)
                chunk = rd.load_time_chunk(k0c, k1c - k0c)
                cache_key = (lut_key, rd.lon_size)
                if cache_key not in flat_cache:
                    flat_cache[cache_key] = luts[lut_key].flat_index(
                        np.asarray(stream_ids), rd.lon_size
                    )
            flat = flat_cache[cache_key]
            # Every spec and every window: grids sharing a cache key can
            # still differ in extent or missing cells, and fill values can
            # appear mid-record.
            _check_flat_bounds(flat, chunk.shape[1] * chunk.shape[2], spec)
            _check_remap_finite(chunk, flat, spec)
            flats.append(flat)
            grids.append(chunk.reshape(chunk.shape[0], -1))
            dts.append(dt_min)
        return ForcingSet.from_grid_series(grids, flats, dts, device=device)

    return load_window

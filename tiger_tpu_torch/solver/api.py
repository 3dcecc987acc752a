"""Two-phase solve: RK45 over all systems, then Radau IIA over the stiff subset.

Port of ``tiger_tpu/solver/api.py::solve`` for one device.  The explicit
phase runs kernel B1 over every system; the stiff flags are read back with
one host sync, which gives the exact subset size; the subset's inputs are
gathered and kernel B2 re-integrates exactly those systems from t0; the
results are merged back.  The TPU package's speculative 256-lane rung with
NaN sentinels and its overflow rung hid a remote-TPU round trip that a local
card does not pay, so this port launches B2 once at the exact count.

A float32 solve on the card then retries the systems B2 failed in float64
(``retry_failed_f64``), as the JAX package's accelerator path does after its
float32 device rung (``tiger_tpu/solver/api.py`` l.526-712): B1's double
instance of the caller's config first, then B2's on the rows it still flags
stiff.  The JAX retry runs on the host's CPU and lands on every query
(``solver/segmented.py``); this one runs the kernels on the card, whose
dense rows interpolate as every other path of the port does.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Sequence

import torch

from tiger_tpu_torch.forcing import ForcingSet
from tiger_tpu_torch.profiling import span
from tiger_tpu_torch.solver.config import SolverConfig
from tiger_tpu_torch.solver.controller import initial_step
from tiger_tpu_torch.solver.radau import RadauStats
from tiger_tpu_torch.solver.rk45 import RKStats, check_inputs, dedup_queries


class Retry(NamedTuple):
    """What ``retry_failed_f64`` gives each row it retried, in float64."""

    rows: torch.Tensor  # [R] the rows of the solve: step 1's resolved, then step 2's
    y_final: torch.Tensor  # [R, N]
    dense: torch.Tensor  # [R, Q, N]
    failed: torch.Tensor  # [R] bool
    # Step 2's rows and its Radau counters; None when step 1 resolved every row.
    radau_rows: Optional[torch.Tensor]
    radau_stats: Optional[RadauStats]


def retries_in_f64(y0: torch.Tensor) -> bool:
    """Whether ``solve`` retries the systems B2 fails in float64: for a
    float32 ``y0`` on the card, as the JAX package retries after its float32
    device rung (``on_accel``, l.538).  On the CPU that package's Radau runs
    in y0's dtype and its failures are final; for a float64 ``y0`` its retry
    would repeat the float64 runs the port has already made."""
    return y0.device.type == "cuda" and y0.dtype == torch.float32


def _take(rows, y0, h0, params, forcings, dtype=None) -> tuple:
    """The systems ``rows`` of a solve's y0, h0, params and forcings; y0, h0
    and params cast to ``dtype`` when given, the forcing data as it is."""

    def take(v):
        return v[rows] if dtype is None else v[rows].to(dtype)

    return (take(y0), take(h0), None if params is None else {k: take(v) for k, v in params.items()},
            None if forcings is None else forcings.take_systems(rows))


def retry_failed_f64(model, y0, h0, t0, tf, qt64, params, forcings, config, t_shift,
                     rows) -> Retry:
    """Re-integrate the systems ``rows`` of the solve in float64 from t0.

    ``y0``, ``params`` and ``h0`` (phase 1's initial steps) are the solve's
    own; their rows are widened to float64, the forcing data stays
    float32, and ``qt64`` are the solve's unique query times in float64.
    Step 1 runs B1 with ``config``; the rows it does not flag stiff take
    its results.  Step 2 runs B2 with ``config`` from the same h0 on the
    rest, which take its results, failed or not (l.630-690).  One host
    sync reads step 1's stiff flags.
    """
    from tiger_tpu_torch.kernels.radau import radau
    from tiger_tpu_torch.kernels.rk45 import rk45

    sub = _take(rows, y0, h0, params, forcings, torch.float64)
    rk = rk45(model, *sub[:2], t0, tf, qt64, *sub[2:], config, t_shift)
    with span("tiger.sync.retry_stiff"):
        stiff = rk.stiff.cpu()  # the retry's own host sync
    with span("tiger.sync.retry_rows"):  # blocking copies of the host's rows to the device
        still, done = (torch.nonzero(m).squeeze(1).to(rows.device) for m in (stiff, ~stiff))
    parts = [(rows[done], rk.y_final[done], rk.dense[done], rk.failed[done])]
    radau_rows = radau_stats = None
    if still.numel():
        s_y0, s_h0, s_params, s_forc = _take(still, *sub)
        rd = radau(model, s_y0, s_h0, t0, tf, qt64, s_params, s_forc, config, t_shift)
        radau_rows, radau_stats = rows[still], rd.stats
        parts.append((radau_rows, rd.y_final, rd.dense, rd.failed))
    return Retry(*(torch.cat(x) for x in zip(*parts)), radau_rows, radau_stats)


class SolveResult(NamedTuple):
    y_final: torch.Tensor  # [S, N]
    dense: torch.Tensor  # [S, Q, N]
    stiff: torch.Tensor  # [S] bool: went through the Radau phase
    failed: torch.Tensor  # [S] bool: did not finish in either phase
    rk_stats: RKStats
    # [S]-shaped per-system Radau counters (zero for systems that never
    # entered the stiff phase); None when no system did.
    radau_stats: Optional[RadauStats]
    n_stiff: int


def solve(
    model,
    y0: torch.Tensor,
    t0: float,
    tf: float,
    query_times: Optional[torch.Tensor] = None,
    params: Optional[dict] = None,
    forcings: Optional[ForcingSet] = None,
    config: SolverConfig = SolverConfig(),
    t_shift: float = 0.0,
    devices: Optional[Sequence] = None,
) -> SolveResult:
    """Integrate ``y0[S, N]`` from t0 to tf with dense output at query_times.

    ``devices`` (a list of torch devices, for example ``["cuda:0",
    "cuda:1"]``) splits the systems over them (``solve_on_devices``); None
    solves on ``y0``'s device.

    ``t_shift`` [min] is added to the time the model's rhs sees: windowed
    runs integrate each window in window-relative time, and a model that
    reads t must see the absolute one.  Forcing gathers are not shifted.
    The kernels take Model 204, whose rhs does not read t.

    Runs on ``y0``'s device, in ``y0``'s dtype; every input tensor must be
    on that device.  CUDA runs the kernels, CPU their plain versions, in
    float32 or float64 with every option set.  The inputs are checked once,
    here (``solver.rk45.check_inputs``), and the phases call the kernels'
    wrappers directly.

    Stiff systems (flagged by the RK45 phase, including those that hit
    ``max_steps``) are re-integrated from t0 by Radau at their RK45 initial
    step.  Those Radau solves take Radau's y_final, dense rows and
    ``failed=False``.  A system Radau fails keeps its RK45 values and
    reports ``failed=True`` (a criteria-stiff system's RK45 result has
    ``failed=False`` with a NaN y_final, so keeping the RK45 flag would
    report it as solved), unless the float64 retry runs.

    The retry runs on the card for a float32 ``y0`` (``retries_in_f64``):
    the systems Radau failed are integrated again from t0 in float64 with
    ``config`` and phase 1's initial steps, by B1 and then, where B1 flags
    them stiff again, by B2 (``retry_failed_f64``).  Each takes the retry's
    y_final, dense rows and ``failed``, cast to y0's dtype.  ``stiff`` and
    ``rk_stats`` stay phase 1's.  ``radau_stats`` stay the float32 Radau's
    when there are query times (the JAX retry then integrates segment by
    segment and keeps no counters) and take the float64 Radau's counters
    without them.  The JAX retry lands on every query; this one
    interpolates, so a retried dense row differs from the JAX package's by
    the interpolant's error, within the tolerance.  The retry costs one
    host sync (reading Radau's failed flags), and when no system failed,
    nothing more.
    """
    if devices is not None:
        return solve_on_devices(model, y0, t0, tf, query_times, params, forcings, config,
                                t_shift, devices)
    with span("tiger.solve"):
        return _solve(model, y0, t0, tf, query_times, params, forcings, config, t_shift)


def _solve(model, y0, t0, tf, query_times, params, forcings, config, t_shift) -> SolveResult:
    """``solve`` on one device, its phases marked ``tiger.solve.<phase>``
    and its host syncs on the card ``tiger.sync.<site>`` (``profiling.span``)."""
    from tiger_tpu_torch.kernels.radau import radau
    from tiger_tpu_torch.kernels.rk45 import rk45

    with span("tiger.solve.check"):
        check_inputs(model, y0, t0, tf, query_times, params, forcings)
        # As tiger_tpu's solve (api.py:248-251); the single-phase solvers
        # accept such queries and leave their rows unfilled.
        if query_times is not None and query_times.numel():
            with span("tiger.sync.query_end"):
                q_end = float(query_times[-1])
            if q_end > float(tf) + 1e-9:
                raise ValueError(f"query_times extend past tf ({q_end} > {tf})")
        t0, tf = float(t0), float(tf)
        qt, inverse = dedup_queries(query_times, y0.dtype)
    with span("tiger.solve.initial_step"):
        h0 = initial_step(model, y0, t0, params, forcings, config, t_shift)
    with span("tiger.solve.b1"):
        rk = rk45(model, y0, h0, t0, tf, qt, params, forcings, config, t_shift)
    y_final, dense, failed = rk.y_final, rk.dense, rk.failed

    with span("tiger.solve.handoff"):
        with span("tiger.sync.handoff"):
            rows = torch.nonzero(rk.stiff).squeeze(1)  # the one host sync
        n_stiff = int(rows.shape[0])
        if n_stiff:
            stiff_in = _take(rows, y0, rk.h0, params, forcings)
    radau_stats = None
    if n_stiff:
        with span("tiger.solve.b2"):
            rd = radau(model, *stiff_in[:2], t0, tf, qt, *stiff_in[2:], config, t_shift)
        with span("tiger.solve.merge"):
            # In-place merge into the RK45 phase's own output tensors.
            ok = ~rd.failed
            y_final[rows] = torch.where(ok[:, None], rd.y_final.to(y_final.dtype), y_final[rows])
            dense[rows] = torch.where(ok[:, None, None], rd.dense.to(dense.dtype), dense[rows])
            failed[rows] = rd.failed
            radau_stats = RadauStats(
                *(
                    torch.zeros(y0.shape[0], dtype=torch.int64, device=y0.device).index_copy_(
                        0, rows, field.to(torch.int64)
                    )
                    for field in rd.stats
                )
            )
        if retries_in_f64(y0):
            with span("tiger.solve.retry"):
                with span("tiger.sync.retry_failed"):
                    lost = rows[torch.nonzero(rd.failed).squeeze(1)]  # the one host sync it adds
                if lost.numel():
                    qt64 = dedup_queries(query_times, torch.float64)[0]
                    retry = retry_failed_f64(model, y0, rk.h0, t0, tf, qt64, params, forcings,
                                             config, t_shift, lost)
                    y_final[retry.rows] = retry.y_final.to(y_final.dtype)
                    dense[retry.rows] = retry.dense.to(dense.dtype)
                    failed[retry.rows] = retry.failed
                    if query_times is None and retry.radau_stats is not None:
                        radau_stats = RadauStats(*(
                            field.index_copy_(0, retry.radau_rows, new.to(torch.int64))
                            for field, new in zip(radau_stats, retry.radau_stats)))
    if inverse is not None:
        with span("tiger.solve.reorder"):
            dense = dense[:, inverse.to(dense.device), :]
    return SolveResult(
        y_final=y_final,
        dense=dense,
        stiff=rk.stiff,
        failed=failed,
        rk_stats=rk.stats,
        radau_stats=radau_stats,
        n_stiff=n_stiff,
    )


def solve_on_devices(model, y0, t0, tf, query_times=None, params=None, forcings=None,
                     config: SolverConfig = SolverConfig(), t_shift: float = 0.0,
                     devices: Sequence = ()) -> SolveResult:
    """``solve`` with the systems split over ``devices``: the counterpart of
    ``tiger_tpu/dist.py::rk45_solve_sharded`` and of the JAX ``solve(mesh=)``.

    The rows are split by ``params.split_even`` (the remainder on the first
    devices).  Each part's whole two-phase solve, its stiff subset and its
    retry included, runs on its device, on a stream of its own on a card, in
    a thread of its own; on the CPU the parts run one after another.  The
    parts are merged on the first device.  Systems are independent, so the
    result equals the one-device solve bit for bit; ``n_stiff`` is the sum,
    and ``radau_stats`` are zero for the rows of a part that flagged none.
    The call is marked ``tiger.solve_on_devices`` and each part's
    ``solve`` ``tiger.solve``, in its own thread (``profiling.span``).
    """
    with span("tiger.solve_on_devices"):
        return _solve_on_devices(model, y0, t0, tf, query_times, params, forcings, config,
                                 t_shift, devices)


def _solve_on_devices(model, y0, t0, tf, query_times, params, forcings, config, t_shift,
                      devices) -> SolveResult:
    from tiger_tpu_torch.params import split_even

    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("devices is empty")
    if any(d.type == "cuda" for d in devs):
        from tiger_tpu_torch.kernels import _build

        _build.load()  # built once, before the threads
    first = devs[0]
    # A device left without rows (fewer systems than devices) takes no part.
    parts, devs = zip(*((sl, d) for sl, d in zip(split_even(y0.shape[0], len(devs)), devs)
                        if sl.stop > sl.start))
    results: list = [None] * len(devs)
    errors: list = []

    def run_part(k: int) -> None:
        sl, dev = parts[k], devs[k]

        def take(v):
            return None if v is None else v[sl].contiguous().to(dev)

        def inputs():
            return (take(y0), None if query_times is None else query_times.to(dev),
                    None if params is None else {n: take(v) for n, v in params.items()},
                    None if forcings is None else ForcingSet(
                        data=forcings.data[:, sl].contiguous().to(dev), meta=forcings.meta))

        if dev.type != "cuda":
            y_k, q_k, p_k, f_k = inputs()
            results[k] = solve(model, y_k, t0, tf, q_k, p_k, f_k, config, t_shift)
            return
        try:
            with torch.cuda.device(dev):
                stream = torch.cuda.Stream(dev)
                # The inputs come from the caller's stream.
                stream.wait_stream(torch.cuda.current_stream(y0.device if y0.is_cuda else dev))
                with torch.cuda.stream(stream):
                    y_k, q_k, p_k, f_k = inputs()
                    results[k] = solve(model, y_k, t0, tf, q_k, p_k, f_k, config, t_shift)
                with span("tiger.sync.devices"):
                    stream.synchronize()
        except Exception as exc:  # raised again in the calling thread
            errors.append(exc)

    if all(d.type != "cuda" for d in devs):
        for k in range(len(devs)):
            run_part(k)
    else:
        threads = [threading.Thread(target=run_part, args=(k,)) for k in range(len(devs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]

    def cat(tensors):
        return torch.cat([t.to(first) for t in tensors])

    rk_stats = RKStats(*(cat(f) for f in zip(*(r.rk_stats for r in results))))
    radau_stats = None
    if any(r.radau_stats is not None for r in results):
        radau_stats = RadauStats(*(
            cat([torch.zeros(sl.stop - sl.start, dtype=torch.int64, device=first)
                 if r.radau_stats is None else r.radau_stats[i] for r, sl in zip(results, parts)])
            for i in range(len(RadauStats._fields))))
    return SolveResult(
        y_final=cat([r.y_final for r in results]),
        dense=cat([r.dense for r in results]),
        stiff=cat([r.stiff for r in results]),
        failed=cat([r.failed for r in results]),
        rk_stats=rk_stats,
        radau_stats=radau_stats,
        n_stiff=sum(r.n_stiff for r in results),
    )

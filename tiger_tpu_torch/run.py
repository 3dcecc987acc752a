"""The CLI run: config -> load -> solve -> write, on one device a process.

Port of ``tiger_tpu/run.py``:

    python -m tiger_tpu_torch.run --config sim.yaml          # on the card
    python -m tiger_tpu_torch.run --config sim.yaml --cpu    # plain versions
    # rank k of N processes (one line each; torchrun's environment also works)
    python -m tiger_tpu_torch.run --config sim.yaml --distributed \\
        --coordinator host:port --num-processes N --process-id k --dist-backend gloo

It reads the YAML config, the per-link parameter CSV, the lookup CSV and the
gridded NetCDF forcings; runs the two-phase solve (kernels B1 and B2 on the
card); and writes the final, dense and routed-discharge files and the
hot-start state file, with the JAX package's names and layouts.  Parameters,
forcings, states and the dense output live on the device; the host reads
the files and writes the results.  With ``time.chunk_days > 0`` the run goes
window by window (``_run_chunked``): forcings read per window, outputs
written per window, checkpoints every ``output.checkpoint_interval``, and
``initial.resume`` continues an interrupted run into its own files.

Every ``solver.precision`` runs on the card and on the CPU, with every
solver option: ``f64``, the default, through the kernels' double
instances, ``f32`` and ``f32c`` (compensated float32) through their float
ones, and on the card a float32 run retries the systems its Radau phase
fails in float64 (``solver.api.solve``).

With several processes (``dist.py``) each rank loads the whole parameter
table, keeps its own rows (``dist.shard_rows_for_process``), reads and
remaps only its own links' forcings, solves them on its device (stiff rows
included), and writes ``final_/dense_/discharge_/state_{prefix}_rank_{k}``
files: concatenated in rank order they are a one-process run's.  ``{rank}``
in ``initial.file`` names each rank's own state file.  Routed discharge
needs the links upstream on other ranks (``_make_cross_rank_routed``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

#: Cold-start defaults per model uid (reference main.cpp:377 for 204).
COLD_STATE_DEFAULTS = {
    204: (0.01, 3.0, 0.0, 5.0, 0.2),
    1: (1.0, 1.0, 1.0, 1.0, 1.0),
}


def _forcing_specs(cfg):
    """The ForcingSpecs of the config, or None when it names no forcing."""
    from tiger_tpu_torch.forcing import ForcingSpec, discover_forcings

    if cfg.forcings.files:
        def _resolve(p):
            # Relative paths resolve against forcings.path.
            return p if p is None or os.path.isabs(p) else os.path.join(cfg.forcings.path, p)

        return [
            ForcingSpec(
                path=_resolve(f["file"]),
                var=f["var"],
                dt_hours=float(f["dt_hours"]),
                lookup=_resolve(f.get("lookup")),
            )
            for f in cfg.forcings.files
        ]
    if cfg.forcings.type == "folder_nc" and cfg.forcings.path:
        return discover_forcings(
            cfg.forcings.path,
            [cfg.forcings.vars.precipitation, cfg.forcings.vars.temperature],
        )
    return None


def run(cfg, device=None, metrics=None) -> dict:
    """Execute one simulation described by a SimulationConfig; returns the
    summary (the keys of the JAX package's ``run``).

    ``device=None`` runs on this process's card
    (``dist.device_for_process``); ``device="cpu"`` runs the kernels' plain
    versions.  In a process group, each rank runs its own rows.
    """
    from tiger_tpu_torch import checkpoint as ckpt
    from tiger_tpu_torch import params as params_mod
    from tiger_tpu_torch.config import parse_interval_minutes
    from tiger_tpu_torch.dist import (device_for_process, process_count, process_index,
                                      shard_rows_for_process)
    from tiger_tpu_torch.forcing import load_forcings
    from tiger_tpu_torch.io import (
        write_dense_csv,
        write_dense_netcdf,
        write_dense_netcdf_packed,
        write_final_csv,
        write_final_netcdf,
    )
    from tiger_tpu_torch.models import get_model
    from tiger_tpu_torch.profiling import Metrics
    from tiger_tpu_torch.solver import solve

    device = device_for_process() if device is None else torch.device(device)
    dtype = torch.float64 if cfg.solver.precision == "f64" else torch.float32

    metrics = metrics or Metrics()
    # doy anchored to time.start: models that use the day of year receive
    # the start date's.
    doy0 = float(cfg.time.start.timetuple().tm_yday)
    model = get_model(cfg.model.uid, doy0=doy0)

    # ---- spatial parameters: this process's rows -----------------------
    with metrics.phase("load_params"):
        sp_full = params_mod.load_spatial_params(cfg.params_file, columns=cfg.params_columns)
        rows = shard_rows_for_process(params_mod.num_systems(sp_full))
        sp = params_mod.slice_rows(sp_full, rows)
        n_sys = params_mod.num_systems(sp)
        link_ids = sp["stream"]
        model_params = {
            k: torch.as_tensor(v, device=device).to(dtype)
            for k, v in params_mod.model_params(sp).items()
        }
        # global_params: scalars broadcast to every system; per-link CSV
        # fields win on collision.
        for name, value in cfg.global_params.items():
            if name not in model_params:
                model_params[name] = torch.full((n_sys,), value, dtype=dtype, device=device)

    # ---- time span / queries -------------------------------------------
    t0, tf = 0.0, cfg.time.duration_minutes
    interval = parse_interval_minutes(cfg.output.print_interval)
    query_times = np.arange(t0, tf + 1e-9, interval)

    # ---- forcings -------------------------------------------------------
    forcings = None
    specs = _forcing_specs(cfg)
    chunked = cfg.time.chunk_days > 0
    if specs and not chunked:
        # Windowed runs never hold the whole record: each window's steps
        # are read on demand (chunked.netcdf_window_loader).
        with metrics.phase("load_forcings"):
            forcings = load_forcings(
                specs, link_ids, cfg.forcings.lookup, duration_days=tf / 1440.0, device=device
            )

    # ---- initial conditions --------------------------------------------
    resume_t = None
    with metrics.phase("init_state"):
        if cfg.initial.mode == "hot":
            # {rank} templating: each rank resumes from its own state file.
            state_file = cfg.initial.file.replace("{rank}", str(process_index()))
            y0, _, t_ckpt = ckpt.load_state(
                state_file, link_ids, require_time=cfg.initial.resume
            )
            if y0.shape[1] != model.N_EQ:
                raise ValueError(
                    f"Hot-start state has {y0.shape[1]} vars, model needs {model.N_EQ}"
                )
            if cfg.initial.resume:
                # Continue the original run from the checkpoint's time: the
                # output files are re-opened, not recreated.
                if not chunked:
                    raise ValueError(
                        "initial.resume requires time.chunk_days > 0 "
                        "(windowed output that can be re-opened)"
                    )
                resume_t = t_ckpt
        else:
            cold = cfg.initial.cold_state or COLD_STATE_DEFAULTS.get(
                cfg.model.uid, (0.0,) * model.N_EQ
            )
            if len(cold) != model.N_EQ:
                raise ValueError(
                    f"initial.cold_state has {len(cold)} vars, model needs {model.N_EQ}"
                )
            y0 = ckpt.cold_state(cold, n_sys)
        y0 = torch.as_tensor(y0, device=device).to(dtype)

    routed_fn = None
    if cfg.output.routed_discharge and process_count() > 1:
        routed_fn = _make_cross_rank_routed(cfg, sp_full, model_params, device, metrics)
    if chunked:
        return _run_chunked(cfg, model, y0, t0, tf, query_times, model_params, specs,
                            sp, metrics, dtype, device, resume_t, routed_fn)

    # ---- solve ----------------------------------------------------------
    t_solve = time.perf_counter()
    with metrics.phase("solve"):
        res = solve(
            model,
            y0,
            t0,
            tf,
            torch.as_tensor(query_times, device=device).to(dtype),
            params=model_params,
            forcings=forcings,
            config=cfg.solver_config(),
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    metrics.record_solve(res, time.perf_counter() - t_solve)

    # ---- select output states ------------------------------------------
    # dense stays on the device: the NetCDF writer streams it to disk slab
    # by slab.
    y_final = res.y_final.cpu().numpy()
    dense = res.dense
    state_ids = np.arange(model.N_EQ, dtype=np.int32)
    if cfg.output.states is not None:
        state_ids = np.asarray(cfg.output.states, np.int32)
        y_final = y_final[:, state_ids]
        dense = dense[:, :, torch.as_tensor(state_ids, dtype=torch.int64, device=device)]

    # ---- write outputs (this rank's files) ------------------------------
    rank = process_index()
    prefix = cfg.output.prefix
    outdir = cfg.output.path
    os.makedirs(outdir, exist_ok=True)
    with metrics.phase("write_output"):
        if cfg.output.format == "csv":
            final_path = os.path.join(outdir, f"final_{prefix}_rank_{rank}.csv")
            dense_path = os.path.join(outdir, f"dense_{prefix}_rank_{rank}.csv")
            write_final_csv(final_path, y_final)
            write_dense_csv(dense_path, dense, query_times)
        else:
            final_path = os.path.join(outdir, f"final_{prefix}_rank_{rank}.nc")
            dense_path = os.path.join(outdir, f"dense_{prefix}_rank_{rank}.nc")
            out_dtype = {None: None, "f32": np.float32, "f64": np.float64,
                         "i16": None}[cfg.output.precision]
            write_final_netcdf(
                final_path, y_final, link_ids, state_ids, cfg.output.compression_level,
                dtype=out_dtype,
            )
            if cfg.output.precision == "i16":
                # CF int16 packing, quantized on the device (the final file
                # is small and stays at solve precision).
                write_dense_netcdf_packed(
                    dense_path, dense, query_times, link_ids, state_ids,
                    cfg.output.compression_level,
                )
            else:
                write_dense_netcdf(
                    dense_path, dense, query_times, link_ids, state_ids,
                    cfg.output.compression_level, dtype=out_dtype,
                )
        # Routed discharge hydrograph over the next_stream topology.
        if cfg.output.routed_discharge:
            from tiger_tpu_torch import routing
            from tiger_tpu_torch.io.netcdf import open_writer
            from tiger_tpu_torch.io.output import _def_output_dims

            if routed_fn is not None:
                q_routed = routed_fn(res.dense)
            else:
                topo = routing.build_topology(sp["stream"], sp["next_stream"])
                q_routed = routing.routed_discharge(res.dense, model_params, topo)
            discharge_path = os.path.join(outdir, f"discharge_{prefix}_rank_{rank}.nc")
            with open_writer(discharge_path) as w:
                _def_output_dims(w, link_ids, query_times)
                w.def_var(
                    "discharge", q_routed, ("system", "time"),
                    cfg.output.compression_level,
                    attrs={"long_name": "routed downstream-accumulated outflow"},
                    dtype=np.float64,
                )

        # Checkpoint for hot restart of the next run.
        state_path = os.path.join(outdir, f"state_{prefix}_rank_{rank}.nc")
        ckpt.save_state(state_path, res.y_final, link_ids, tf)

    return {
        "num_systems": n_sys,
        "n_stiff": res.n_stiff,
        "n_failed": int(res.failed.sum()),
        "final_path": final_path,
        "dense_path": dense_path,
        "state_path": state_path,
        **metrics.summary(),
    }


def _make_cross_rank_routed(cfg, sp_full, model_params, device, metrics):
    """Dense -> routed discharge of this rank's links over the whole basin
    (``model_params``: this rank's, as the solve takes them).

    Downstream links cross rank boundaries, so a topology of the rank's own
    rows would drop what flows in from the others.  Each rank computes its
    own links' runoff [S_local, Q] (``routing.link_runoff_204``, row by
    row); then, by ``output.routed_exchange``:

    - ``ring``: ``routing.exchange_sharded`` over a plan of the whole
      topology split as the ranks' rows are: only each round's outbox
      travels, rank to rank.  Its sums run in another order than the
      one-process routing's, so it agrees with it to rounding.
    - ``allgather``, the oracle: every rank gathers every rank's runoff
      (``all_gather``) and accumulates the whole basin as one process does
      (``routing.accumulate_downstream_log``), keeping its own rows: its
      discharge equals the one-process run's bit for bit.  The JAX package
      gathers the dense block [S_local, Q, N]; the runoff is computed row
      by row, so gathering it gives the same numbers from 5x fewer bytes.

    Topology, plan and parameters are built once; each call moves one
    block's (a window's) data, and adds its seconds to the run's
    ``routed_exchange_s`` counter.  Under ``gloo`` a card's tensors cross
    through host memory.
    """
    import torch.distributed as dist

    from tiger_tpu_torch import params as params_mod
    from tiger_tpu_torch import routing
    from tiger_tpu_torch.dist import process_count, process_index
    from tiger_tpu_torch.params import split_even

    topo = routing.build_topology(sp_full["stream"], sp_full["next_stream"])
    slices = split_even(params_mod.num_systems(sp_full), process_count())
    rows = slices[process_index()]
    n_local = rows.stop - rows.start
    params = {k: v[:, None] for k, v in model_params.items()}
    metrics.counters.setdefault("routed_exchange_s", 0.0)

    def runoff(dense_local):
        return routing.link_runoff_204(torch.nan_to_num(dense_local), params)

    if cfg.output.routed_exchange == "ring":
        plan = routing.plan_sharded_topology(topo, len(slices), bounds=slices)

        def exchange(dense_local):
            return routing.exchange_sharded(runoff(dense_local), plan)
    else:
        max_len = max(sl.stop - sl.start for sl in slices)
        staged = device.type == "cuda" and dist.get_backend() == "gloo"

        def exchange(dense_local):
            q = runoff(dense_local)
            pad = q.new_zeros((max_len,) + tuple(q.shape[1:]))
            pad[:n_local] = q
            if staged:
                pad = pad.cpu()
            parts = [torch.empty_like(pad) for _ in slices]
            dist.all_gather(parts, pad)
            q_full = torch.cat([p[: sl.stop - sl.start] for p, sl in zip(parts, slices)])
            return routing.accumulate_downstream_log(q_full.to(device), topo)[rows]

    def routed(dense_local):
        start = time.perf_counter()
        out = exchange(dense_local)
        metrics.counters["routed_exchange_s"] += time.perf_counter() - start
        return out

    return routed


def _run_chunked(cfg, model, y0, t0, tf, query_times, model_params, specs, sp, metrics,
                 dtype, device, resume_t=None, routed_fn=None) -> dict:
    """Windowed (streaming) execution, ``time.chunk_days`` at a time.

    Forcing steps are read per window (``netcdf_window_loader``) and the
    dense and routed outputs are written per window (the windowed writers),
    so memory stays bounded whatever the record's length.

    ``resume_t`` (``initial.resume``): continue the original run from this
    simulated minute into its own output files, re-opened and filled from
    that point; ``output.checkpoint_interval`` writes the state file along
    the way so that such a point exists.  ``routed_fn`` (several processes)
    routes each window across the ranks in place of the local topology.
    """
    import contextlib

    from tiger_tpu_torch import checkpoint as ckpt
    from tiger_tpu_torch.chunked import netcdf_window_loader, solve_chunked
    from tiger_tpu_torch.config import parse_interval_minutes
    from tiger_tpu_torch.dist import process_index
    from tiger_tpu_torch.io import write_final_netcdf
    from tiger_tpu_torch.io.output import WindowedPackedWriter, WindowedVarWriter

    link_ids = sp["stream"]
    if cfg.output.format != "netcdf":
        raise ValueError("time.chunk_days requires output.format: netcdf")
    if cfg.output.precision == "i16" and cfg.output.i16_ranges is None:
        raise ValueError(
            "output.precision i16 with chunked runs needs DECLARED per-state "
            "packing ranges (the global min/max cannot be derived from "
            "windows not yet solved): set output.i16_ranges "
            "{state_id: [min, max], ...}, or use f32/f64 / solve unchunked"
        )

    interval = parse_interval_minutes(cfg.output.print_interval)
    chunk_minutes = cfg.time.chunk_days * 1440.0
    t_start = t0 if resume_t is None else float(resume_t)
    if resume_t is not None:
        for name, step in (("chunk_days", chunk_minutes), ("print_interval", interval)):
            if abs((t_start - t0) / step - round((t_start - t0) / step)) > 1e-9:
                raise ValueError(
                    f"resume time {t_start} min is not aligned to {name} "
                    f"({step} min); checkpoints are written at window ends"
                )
        if not (t0 <= t_start < tf):
            raise ValueError(f"resume time {t_start} min outside the run span [{t0}, {tf})")
    base_q = int(round((t_start - t0) / interval))
    loader = (
        netcdf_window_loader(specs, link_ids, cfg.forcings.lookup, device=device)
        if specs
        else (lambda w_start, w_end: None)
    )

    topo = None
    if cfg.output.routed_discharge and routed_fn is None:
        from tiger_tpu_torch import routing

        topo = routing.build_topology(sp["stream"], sp["next_stream"])

    state_ids = np.arange(model.N_EQ, dtype=np.int32)
    state_sel = None
    if cfg.output.states is not None:
        state_ids = np.asarray(cfg.output.states, np.int32)
        state_sel = torch.as_tensor(state_ids, dtype=torch.int64, device=device)

    prefix = cfg.output.prefix
    outdir = cfg.output.path
    os.makedirs(outdir, exist_ok=True)
    rank = process_index()
    final_path = os.path.join(outdir, f"final_{prefix}_rank_{rank}.nc")
    dense_path = os.path.join(outdir, f"dense_{prefix}_rank_{rank}.nc")
    state_path = os.path.join(outdir, f"state_{prefix}_rank_{rank}.nc")
    out_dtype = {None: np.float64 if dtype == torch.float64 else np.float32,
                 "f32": np.float32, "f64": np.float64, "i16": np.int16}[cfg.output.precision]
    if cfg.output.precision == "i16":
        missing = [int(v) for v in state_ids if int(v) not in cfg.output.i16_ranges]
        if missing:
            raise ValueError(f"output.i16_ranges is missing output states {missing}")

    t_solve = time.perf_counter()
    resume = resume_t is not None
    with contextlib.ExitStack() as stack, metrics.phase("solve"):
        if cfg.output.precision == "i16":
            dense_w = stack.enter_context(
                WindowedPackedWriter(
                    dense_path, link_ids, query_times, state_ids, cfg.output.i16_ranges,
                    compression_level=cfg.output.compression_level, resume=resume,
                    metrics=metrics,
                )
            )
        else:
            dense_w = stack.enter_context(
                WindowedVarWriter(
                    dense_path, "outputs", link_ids, query_times, state_ids=state_ids,
                    compression_level=cfg.output.compression_level, dtype=out_dtype,
                    resume=resume, metrics=metrics,
                )
            )
        disc_w = None
        if topo is not None or routed_fn is not None:
            discharge_path = os.path.join(outdir, f"discharge_{prefix}_rank_{rank}.nc")
            disc_w = stack.enter_context(
                WindowedVarWriter(
                    discharge_path, "discharge", link_ids, query_times,
                    compression_level=cfg.output.compression_level, dtype=np.float64,
                    attrs={"long_name": "routed downstream-accumulated outflow"},
                    resume=resume, metrics=metrics,
                )
            )

        def sink(q0, qt_abs, dense_blk, routed_blk):
            if resume and q0 == 0 and len(qt_abs) and abs(qt_abs[0] - t_start) < 1e-9:
                # The resume-boundary row was written by the original run
                # (as the last window's dense interpolant); rewriting it
                # with the checkpoint state could change it by rounding.
                q0, dense_blk = 1, dense_blk[:, 1:]
                routed_blk = None if routed_blk is None else routed_blk[:, 1:]
            if state_sel is not None:
                dense_blk = dense_blk[:, :, state_sel]
            dense_w.write(base_q + q0, dense_blk)
            if disc_w is not None:
                disc_w.write(base_q + q0, routed_blk)

        state_cb = None
        if cfg.output.checkpoint_interval is not None:
            ckpt_every = parse_interval_minutes(cfg.output.checkpoint_interval)
            # Checkpoints land at window ends, and a resume must land on the
            # query grid: refuse up front rather than write checkpoints that
            # can never be resumed.
            if abs(chunk_minutes / interval - round(chunk_minutes / interval)) > 1e-9:
                raise ValueError(
                    f"output.checkpoint_interval needs time.chunk_days*1440 "
                    f"({chunk_minutes} min) to be a multiple of "
                    f"output.print_interval ({interval} min): checkpoints are "
                    "written at window ends, and resume must land on the "
                    "query grid"
                )
            next_mark = [t_start + ckpt_every]

            def state_cb(t_abs, y):
                # On the sink thread after this window's dense writes: flush
                # first, so a checkpoint never claims a time whose output a
                # crash right after it could lose.
                if t_abs + 1e-9 < next_mark[0]:
                    return
                dense_w.flush()
                if disc_w is not None:
                    disc_w.flush()
                ckpt.save_state(state_path, y, link_ids, float(t_abs))
                while next_mark[0] <= t_abs + 1e-9:
                    next_mark[0] += ckpt_every

        res = solve_chunked(
            model, y0, t_start, tf, chunk_minutes, loader,
            query_interval=interval, params=model_params, config=cfg.solver_config(),
            topology=topo, routed_fn=routed_fn, dense_sink=sink, state_sink=state_cb,
            metrics=metrics,
        )
        if topo is not None or routed_fn is not None:
            res = res[0]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    metrics.record_solve(res, time.perf_counter() - t_solve)

    with metrics.phase("write_output"):
        y_final = res.y_final.cpu().numpy()
        write_final_netcdf(
            final_path, y_final[:, state_ids], link_ids, state_ids,
            cfg.output.compression_level,
            # i16 packs only the dense record; the final state stays at
            # solve precision (as in the unchunked run).
            dtype={None: None, "f32": np.float32, "f64": np.float64,
                   "i16": None}[cfg.output.precision],
        )
        ckpt.save_state(state_path, y_final, link_ids, tf)

    return {
        "num_systems": len(link_ids),
        "n_stiff": res.n_stiff,
        "n_failed": int(res.failed.sum()),
        "n_windows": max(1, int(np.ceil((tf - t_start) / chunk_minutes - 1e-9))),
        "final_path": final_path,
        "dense_path": dense_path,
        "state_path": state_path,
        **metrics.summary(),
    }


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tiger-tpu-torch",
        description="The hillslope hydrologic engine on PyTorch and CUDA",
    )
    p.add_argument("--config", required=True, help="YAML simulation config")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions) instead of the card")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run into this directory")
    p.add_argument("--distributed", action="store_true",
                   help="join a process group (dist.init_process): each rank runs its rows")
    p.add_argument("--coordinator", default=None,
                   help="the process group's host:port (else MASTER_ADDR:MASTER_PORT)")
    p.add_argument("--num-processes", type=int, default=None, help="else WORLD_SIZE")
    p.add_argument("--process-id", type=int, default=None, help="else RANK")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="torch.distributed backend (needed with --distributed): nccl for a "
                        "card a rank, gloo for the CPU or ranks that share a card")
    args = p.parse_args(argv)
    if args.distributed and args.dist_backend is None:
        p.error("--distributed needs --dist-backend nccl or gloo")

    from tiger_tpu_torch.config import load_config
    from tiger_tpu_torch.dist import device_for_process, init_process
    from tiger_tpu_torch.profiling import Metrics, trace

    cfg = load_config(args.config)
    if args.distributed:
        if args.cpu and args.dist_backend == "nccl":
            p.error("--cpu with --dist-backend nccl: nccl moves CUDA tensors only; use gloo")
        init_process(args.coordinator, args.num_processes, args.process_id, args.dist_backend)
    try:
        metrics = Metrics()
        with trace(args.profile_dir):
            summary = run(cfg, device=device_for_process(cpu=args.cpu), metrics=metrics)
    finally:
        if args.distributed:
            import torch.distributed

            torch.distributed.destroy_process_group()
    print(json.dumps(summary, sort_keys=True, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())

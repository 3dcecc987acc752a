"""The CLI run: config -> load -> solve -> write, on one device.

Port of the unchunked, single-process run of ``tiger_tpu/run.py``:

    python -m tiger_tpu_torch.run --config sim.yaml          # on the card
    python -m tiger_tpu_torch.run --config sim.yaml --cpu    # plain versions

It reads the YAML config, the per-link parameter CSV, the lookup CSV and the
gridded NetCDF forcings; runs the two-phase solve (kernels B1 and B2 on the
card); and writes the final, dense and routed-discharge files and the
hot-start state file, with the JAX package's names and layouts.  Parameters,
forcings, states and the dense output live on the device; the host reads
the files and writes the results.

What the port does not carry yet raises NotImplementedError naming its
ROADMAP item (``_refuse_unported``): windowed runs and resume, several
processes, float64 on the card, and the compensated and PI solver options.
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


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _refuse_unported(cfg, device: torch.device) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for every part of
    the JAX package's run that this port does not carry yet."""
    refusals = (
        (cfg.time.chunk_days > 0,
         "time.chunk_days > 0 (windowed runs) waits for chunked.py, ROADMAP Queue 1 #12"),
        (cfg.initial.resume,
         "initial.resume (crash resume of a windowed run) waits for chunked.py, "
         "ROADMAP Queue 1 #12"),
        (_world_size() > 1,
         "more than one process, and routed_exchange across ranks, wait for dist.py, "
         "ROADMAP Queue 1 #16"),
        (device.type == "cuda" and cfg.solver.precision == "f64",
         "solver.precision f64 on the card waits for float64 kernels, ROADMAP Queue 1 #9 "
         "(the kernels take float32 only; device='cpu' runs f64)"),
        (cfg.solver.precision == "f32c",
         "solver.precision f32c (compensated f32) waits for the solver options, "
         "ROADMAP Queue 1 #17"),
        (cfg.solver.controller == "pi",
         "solver.controller pi waits for the solver options, ROADMAP Queue 1 #17"),
    )
    for refused, why in refusals:
        if refused:
            raise NotImplementedError(why)


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

    ``device=None`` runs on the card ("cuda"); ``device="cpu"`` runs the
    kernels' plain versions.
    """
    from tiger_tpu_torch import checkpoint as ckpt
    from tiger_tpu_torch import params as params_mod
    from tiger_tpu_torch.config import parse_interval_minutes
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

    device = torch.device("cuda" if device is None else device)
    _refuse_unported(cfg, device)
    dtype = torch.float64 if cfg.solver.precision == "f64" else torch.float32

    metrics = metrics or Metrics()
    # doy anchored to time.start: models that use the day of year receive
    # the start date's.
    doy0 = float(cfg.time.start.timetuple().tm_yday)
    model = get_model(cfg.model.uid, doy0=doy0)

    # ---- spatial parameters --------------------------------------------
    with metrics.phase("load_params"):
        sp = params_mod.load_spatial_params(cfg.params_file, columns=cfg.params_columns)
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
    if specs:
        with metrics.phase("load_forcings"):
            forcings = load_forcings(
                specs, link_ids, cfg.forcings.lookup, duration_days=tf / 1440.0, device=device
            )

    # ---- initial conditions --------------------------------------------
    with metrics.phase("init_state"):
        if cfg.initial.mode == "hot":
            # {rank} templating of multi-process runs: one process is rank 0.
            state_file = cfg.initial.file.replace("{rank}", "0")
            y0, _, _ = ckpt.load_state(state_file, link_ids)
            if y0.shape[1] != model.N_EQ:
                raise ValueError(
                    f"Hot-start state has {y0.shape[1]} vars, model needs {model.N_EQ}"
                )
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

    # ---- write outputs (the per-rank file names of one process) --------
    prefix = cfg.output.prefix
    outdir = cfg.output.path
    os.makedirs(outdir, exist_ok=True)
    with metrics.phase("write_output"):
        if cfg.output.format == "csv":
            final_path = os.path.join(outdir, f"final_{prefix}_rank_0.csv")
            dense_path = os.path.join(outdir, f"dense_{prefix}_rank_0.csv")
            write_final_csv(final_path, y_final)
            write_dense_csv(dense_path, dense, query_times)
        else:
            final_path = os.path.join(outdir, f"final_{prefix}_rank_0.nc")
            dense_path = os.path.join(outdir, f"dense_{prefix}_rank_0.nc")
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

            topo = routing.build_topology(sp["stream"], sp["next_stream"])
            q_routed = routing.routed_discharge(res.dense, model_params, topo)
            discharge_path = os.path.join(outdir, f"discharge_{prefix}_rank_0.nc")
            with open_writer(discharge_path) as w:
                _def_output_dims(w, link_ids, query_times)
                w.def_var(
                    "discharge", q_routed, ("system", "time"),
                    cfg.output.compression_level,
                    attrs={"long_name": "routed downstream-accumulated outflow"},
                    dtype=np.float64,
                )

        # Checkpoint for hot restart of the next run.
        state_path = os.path.join(outdir, f"state_{prefix}_rank_0.nc")
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
    args = p.parse_args(argv)

    from tiger_tpu_torch.config import load_config
    from tiger_tpu_torch.profiling import Metrics, trace

    cfg = load_config(args.config)
    metrics = Metrics()
    with trace(args.profile_dir):
        summary = run(cfg, device="cpu" if args.cpu else None, metrics=metrics)
    print(json.dumps(summary, sort_keys=True, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The simulation config: the YAML schema of ``tiger_tpu/config.py``.

A copy of the JAX package's dataclasses and parser (model selection,
ISO-8601 time span, cold/hot initial conditions, forcing discovery, output
interval and state subset, solver tolerances, parallel-run knobs), so that
the port imports no jax.  ``config_from_dict`` does all the parsing of an
already-loaded document; ``load_config`` reads the YAML file (PyYAML is
imported there only, so a caller that builds the document itself needs no
PyYAML).  ``SimulationConfig.solver_config`` returns the port's
``SolverConfig``.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import re
from typing import List, Optional


def _parse_iso8601(s: str) -> _dt.datetime:
    return _dt.datetime.fromisoformat(s)


# 's' plural only on word units: a bare-letter unit with 's' ('ms', 'hs')
# would silently parse as minutes/hours ('500ms' != 500 minutes).
_INTERVAL_RE = re.compile(
    r"^\s*(\d+(?:\.\d+)?)\s*(m|min(?:s)?|h|hr(?:s)?|hour(?:s)?|d|day(?:s)?)\s*$"
)


def parse_interval_minutes(text: str) -> float:
    """'15m' / '1h' / '1d' -> minutes (config.yaml output.print_interval)."""
    m = _INTERVAL_RE.match(str(text))
    if not m:
        raise ValueError(f"Bad interval {text!r}; expected like '15m', '1h', '1d'")
    value, unit = float(m.group(1)), m.group(2)
    minutes = value * {
        "m": 1.0, "min": 1.0, "mins": 1.0,
        "h": 60.0, "hr": 60.0, "hrs": 60.0, "hour": 60.0, "hours": 60.0,
        "d": 1440.0, "day": 1440.0, "days": 1440.0,
    }[unit]
    if minutes <= 0:
        raise ValueError(f"Interval {text!r} must be positive")
    return minutes


@dataclasses.dataclass
class ModelInfo:
    uid: int = 204
    name: str = ""


@dataclasses.dataclass
class TimeInfo:
    start: _dt.datetime = _dt.datetime(2000, 1, 1)
    end: _dt.datetime = _dt.datetime(2000, 1, 3)
    # Windowed (streaming) execution, chunk_days at a time; 0 = solve the
    # whole span in one shot.
    chunk_days: float = 0.0

    @property
    def duration_minutes(self) -> float:
        return (self.end - self.start).total_seconds() / 60.0


@dataclasses.dataclass
class InitialInfo:
    mode: str = "cold"  # "cold" | "hot"
    file: str = ""  # state file (hot mode); NetCDF final-state layout
    cold_state: Optional[List[float]] = None  # per-variable cold-start y0
    # Crash recovery for chunked runs: continue the original simulation from
    # the state file's sim_time_minutes.  Plain hot start (resume: false)
    # begins a new run at t=0 from the saved state.
    resume: bool = False


@dataclasses.dataclass
class ForcingVarInfo:
    precipitation: str = "pr"
    temperature: str = "t2m"


@dataclasses.dataclass
class ForcingInfo:
    type: str = "folder_nc"
    path: str = ""
    lookup: str = ""
    vars: ForcingVarInfo = dataclasses.field(default_factory=ForcingVarInfo)
    # Extension over the reference schema: explicit per-forcing files + dt
    # (the reference hard-codes these in main.cpp:508-515).
    files: List[dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class OutputInfo:
    print_interval: str = "1h"
    states: Optional[List[int]] = None  # None => all states
    path: str = "."
    prefix: str = "example"
    compression_level: int = 0
    format: str = "netcdf"  # "netcdf" | "csv"
    # NetCDF variable precision: None preserves solve precision; "f64"
    # matches the reference's double `outputs` var; "i16" packs the dense
    # output CF-style (per-state scale/offset, quantized on the device).
    precision: Optional[str] = None  # None | "f32" | "f64" | "i16"
    # Declared per-state packing ranges for streamed (chunked) i16 output:
    # {state_id: [min, max], ...}.  Unchunked i16 runs ignore this and
    # derive exact ranges from the data.
    i16_ranges: Optional[dict] = None
    # Also write the routed discharge hydrograph (downstream-accumulated link
    # outflow over the next_stream topology) as discharge_<prefix>_rank_N.nc.
    routed_discharge: bool = False
    # Multi-process routed-discharge exchange ('ring' | 'allgather'); the
    # port runs one process, so it parses and checks this field only.
    routed_exchange: str = "ring"
    # Chunked runs: overwrite state_<prefix>_rank_N.nc every this-many
    # simulated time (e.g. "30d").  None = final state only.
    checkpoint_interval: Optional[str] = None


@dataclasses.dataclass
class SolverInfo:
    method: str = "RK45"
    rtol: float = 1e-6
    atol: float = 1e-9
    safety: float = 0.9
    min_scale: float = 0.2
    max_scale: float = 10.0
    initial_step: Optional[float] = None
    # 'f64' matches the reference (double everywhere; on the card the
    # kernels' double instances, one for every option set);
    # 'f32' is the kernels' float precision (pair it with rtol >= ~1e-5:
    # tolerances below f32 rounding accumulate past them); 'f32c' is f32
    # with compensated (Kahan) state accumulation (SolverConfig.compensated):
    # at rtol 1e-6 / atol 1e-9 it takes out most of f32's rounding drift,
    # not the differences that float32's and float64's own step choices
    # make (PERF.md).
    precision: str = "f64"
    # Forcing precision (SolverConfig.forcing_dtype): 'bf16' rounds the
    # forcing RK45 reads in a float32 solve to bfloat16 (~3 significant
    # digits of the forcing values; the states and steps stay float32).
    forcing_precision: str = "f32"
    # Step-size controller: 'i' (reference parity) or 'pi' (Lund-stabilized;
    # fewer rejected attempts on forcing-kink-heavy runs).
    controller: str = "i"
    # Lund stabilization exponent (controller='pi' only); DOPRI5's beta=0.04.
    pi_beta: float = 0.04


@dataclasses.dataclass
class ParallelInfo:
    # Reference mpi: block carried for compatibility.
    step_storage: int = 30
    transfer_buffer: int = 10
    discontinuity_buf: int = 0


@dataclasses.dataclass
class FlagsInfo:
    uses_dam: bool = False
    convert_area: bool = False


@dataclasses.dataclass
class SimulationConfig:
    model: ModelInfo = dataclasses.field(default_factory=ModelInfo)
    time: TimeInfo = dataclasses.field(default_factory=TimeInfo)
    initial: InitialInfo = dataclasses.field(default_factory=InitialInfo)
    params_file: str = ""
    # local_params.columns (config.yaml:27-31): positional column mapping for
    # headerless/foreign CSVs — see params.load_spatial_params.
    params_columns: Optional[dict] = None
    # global_params (config.yaml:20-22): scalar parameters broadcast to every
    # system; per-link CSV values win on name collision.
    global_params: dict = dataclasses.field(default_factory=dict)
    forcings: ForcingInfo = dataclasses.field(default_factory=ForcingInfo)
    output: OutputInfo = dataclasses.field(default_factory=OutputInfo)
    solver: SolverInfo = dataclasses.field(default_factory=SolverInfo)
    parallel: ParallelInfo = dataclasses.field(default_factory=ParallelInfo)
    flags: FlagsInfo = dataclasses.field(default_factory=FlagsInfo)

    def solver_config(self):
        from tiger_tpu_torch.solver.config import SolverConfig

        return SolverConfig(
            rtol=self.solver.rtol,
            atol=self.solver.atol,
            safety=self.solver.safety,
            min_scale=self.solver.min_scale,
            max_scale=self.solver.max_scale,
            initial_step=self.solver.initial_step,
            forcing_dtype=self.solver.forcing_precision,
            controller=self.solver.controller,
            pi_beta=self.solver.pi_beta,
            compensated=self.solver.precision == "f32c",
        )


def load_config(path: str) -> SimulationConfig:
    """Parse the YAML file into a SimulationConfig."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    return config_from_dict(doc)


def config_from_dict(doc: dict) -> SimulationConfig:
    """Parse a loaded config document (the YAML file's mapping) into a
    SimulationConfig, with every check of the schema."""
    cfg = SimulationConfig()

    if m := doc.get("model"):
        cfg.model = ModelInfo(uid=int(m.get("uid", 204)), name=str(m.get("name", "")))
    if t := doc.get("time"):
        cfg.time = TimeInfo(
            start=_parse_iso8601(str(t["start"])),
            end=_parse_iso8601(str(t["end"])),
            chunk_days=float(t.get("chunk_days", 0.0)),
        )
        if cfg.time.chunk_days < 0:
            raise ValueError(f"time.chunk_days must be >= 0, got {cfg.time.chunk_days}")
        if cfg.time.end <= cfg.time.start:
            raise ValueError(
                f"time.end ({cfg.time.end}) must be after time.start "
                f"({cfg.time.start})"
            )
    if i := doc.get("initial"):
        cfg.initial = InitialInfo(
            mode=str(i.get("mode", "cold")),
            file=str(i.get("file") or "") if i.get("mode") == "hot" else "",
            cold_state=list(i["cold_state"]) if i.get("cold_state") else None,
            resume=bool(i.get("resume", False)),
        )
        if cfg.initial.mode not in ("cold", "hot"):
            raise ValueError(f"initial.mode must be cold|hot, got {cfg.initial.mode}")
        if cfg.initial.mode == "hot" and not cfg.initial.file:
            raise ValueError("initial.mode hot requires initial.file")
        if cfg.initial.resume and cfg.initial.mode != "hot":
            raise ValueError("initial.resume requires initial.mode: hot")
    if lp := doc.get("local_params"):
        cfg.params_file = str(lp.get("file", ""))
        if cols := lp.get("columns"):
            cfg.params_columns = {
                "stream_id": int(cols.get("stream_id", 0)),
                "next_stream_id": int(cols.get("next_stream_id", 1)),
                "params_start": int(cols.get("params_start", 2)),
                # Default = the FULL positional schema (16 columns incl.
                # t_thres); a 15 here silently zeroed the melt threshold for
                # configs that omitted num_params.
                "num_params": int(cols.get("num_params", 16)),
            }
            if "has_header" in cols:
                # Explicit header declaration beats the loader's sniff
                # (ambiguous for numeric-looking headers / empty first cells).
                cfg.params_columns["has_header"] = bool(cols["has_header"])
    if gp := doc.get("global_params"):
        for entry in gp:
            cfg.global_params[str(entry["name"])] = float(entry.get("value", 0.0))
    if f := doc.get("forcings"):
        fv = f.get("vars") or {}
        cfg.forcings = ForcingInfo(
            type=str(f.get("type", "folder_nc")),
            path=str(f.get("path", "")),
            lookup=str(f.get("lookup", "")),
            vars=ForcingVarInfo(
                precipitation=str(fv.get("precipitation", "pr")),
                temperature=str(fv.get("temperature", "t2m")),
            ),
            files=list(f.get("files", [])),
        )
    if o := doc.get("output"):
        cfg.output = OutputInfo(
            print_interval=str(o.get("print_interval", "1h")),
            states=list(o["states"]) if o.get("states") else None,
            path=str(o.get("path", ".")),
            prefix=str(o.get("prefix", "example")),
            compression_level=int(o.get("compression_level", 0)),
            format=str(o.get("format", "netcdf")),
            precision=(None if o.get("precision") is None else str(o["precision"])),
            i16_ranges=(
                None if o.get("i16_ranges") is None else dict(o["i16_ranges"])
            ),
            routed_discharge=bool(o.get("routed_discharge", False)),
            routed_exchange=str(o.get("routed_exchange", "ring")),
            checkpoint_interval=(
                None if o.get("checkpoint_interval") is None
                else str(o["checkpoint_interval"])
            ),
        )
        if cfg.output.checkpoint_interval is not None:
            parse_interval_minutes(cfg.output.checkpoint_interval)  # validate
        if cfg.output.routed_exchange not in ("ring", "allgather"):
            raise ValueError(
                "output.routed_exchange must be ring|allgather, got "
                f"{cfg.output.routed_exchange!r}"
            )
        if cfg.output.precision not in (None, "f32", "f64", "i16"):
            raise ValueError(
                f"output.precision must be f32|f64|i16, got {cfg.output.precision!r}"
            )
        if cfg.output.i16_ranges is not None:
            if cfg.output.precision != "i16":
                raise ValueError(
                    "output.i16_ranges only applies with output.precision: i16"
                )
            fixed = {}
            for k, v in cfg.output.i16_ranges.items():
                try:
                    sid = int(k)
                    lo, hi = (float(v[0]), float(v[1]))
                except (TypeError, ValueError, IndexError):
                    raise ValueError(
                        f"output.i16_ranges entries must be state_id: "
                        f"[min, max]; got {k!r}: {v!r}"
                    )
                import math

                if not (lo < hi) or not (math.isfinite(lo) and math.isfinite(hi)):
                    raise ValueError(
                        f"output.i16_ranges[{sid}] needs finite min < max, "
                        f"got [{lo}, {hi}]"
                    )
                fixed[sid] = (lo, hi)
            cfg.output.i16_ranges = fixed
        parse_interval_minutes(cfg.output.print_interval)  # validate
    if s := doc.get("solver"):
        tol = s.get("tolerances") or {}
        cfg.solver = SolverInfo(
            method=str(s.get("method", "RK45")),
            rtol=float(tol.get("rtol", 1e-6)),
            atol=float(tol.get("atol", 1e-9)),
            safety=float(tol.get("safety", 0.9)),
            min_scale=float(tol.get("min_scale", 0.2)),
            max_scale=float(tol.get("max_scale", 10.0)),
            initial_step=(None if s.get("initial_step") is None else float(s["initial_step"])),
            precision=str(s.get("precision", "f64")),
            forcing_precision=str(s.get("forcing_precision", "f32")),
            controller=str(s.get("controller", "i")),
            pi_beta=float(s.get("pi_beta", 0.04)),
        )
        if cfg.solver.method.lower() != "rk45":
            raise ValueError(
                f"solver.method must be RK45 (got {cfg.solver.method!r}): the "
                "engine is the RK45+Radau hybrid — stiff systems are routed "
                "to Radau automatically, there is no all-Radau mode"
            )
        if cfg.solver.precision not in ("f64", "f32", "f32c"):
            raise ValueError(
                f"solver.precision must be f64|f32|f32c, got {cfg.solver.precision}"
            )
        if cfg.solver.forcing_precision not in ("f32", "bf16"):
            raise ValueError(
                f"solver.forcing_precision must be f32|bf16, got "
                f"{cfg.solver.forcing_precision}"
            )
        if cfg.solver.controller not in ("i", "pi"):
            raise ValueError(
                f"solver.controller must be i|pi, got {cfg.solver.controller!r}"
            )
        if not 0.0 <= cfg.solver.pi_beta <= 0.2:
            raise ValueError(
                f"solver.pi_beta must be in [0, 0.2], got {cfg.solver.pi_beta}"
            )
        if cfg.solver.precision == "f32" and cfg.solver.rtol < 5e-6:
            import warnings

            warnings.warn(
                f"solver.precision f32 with rtol={cfg.solver.rtol:g}: tolerances "
                "below ~1e-5 are at float32 rounding level — the trajectory "
                "accumulation rounds past them.  Raise rtol (>=1e-5), use "
                "precision f32c (compensated f32: takes most of that rounding "
                "out at kernel speed), or f64.",
                stacklevel=2,
            )
    if p := doc.get("mpi") or doc.get("parallel"):
        cfg.parallel = ParallelInfo(
            step_storage=int(p.get("step_storage", 30)),
            transfer_buffer=int(p.get("transfer_buffer", 10)),
            discontinuity_buf=int(p.get("discontinuity_buf", 0)),
        )
    if fl := doc.get("flags"):
        cfg.flags = FlagsInfo(
            uses_dam=bool(fl.get("uses_dam", False)),
            convert_area=bool(fl.get("convert_area", False)),
        )
    return cfg

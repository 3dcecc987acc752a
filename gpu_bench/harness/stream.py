"""The timed path: one closed-loop stream of windows through the program.

Each window makes one call of the program's entry ``tiger_tpu_torch.solve``
with the window's forcing block, its hourly query grid placed as
``tiger_tpu_torch.chunked.solve_chunked`` places it (window 0 also carries
the t0 query), ``t_shift`` = the window's start (``Inputs.window_start``,
which the check gives the reference too), and the state carried out of the
previous window (window 0: the cold state).  The model is the
configuration's, with its ``doy0`` where the configuration states one.  The
carry keeps a system's previous state where the new one is NaN, as
``chunked._carry_update`` does.  The window ends in a synchronize.

Beside the program's work, a window draws its forcing and adds its failed
systems and step counters to device accumulators (read once the timed
window has closed).  The windows the check holds (``CheckPlan``) also keep
the program's outputs on the check's rows: the fixed sample, and rows that
B2 served in that window, drawn from the seed without a host sync.  This
module alone imports the program.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from harness.inputs import Inputs, stiff_rows, stream_seed

#: Device accumulators, in order.
COUNTERS = ("failed", "b1_accepted", "b1_accepted_kept", "b2_accepted", "b2_attempts",
            "b2_sweeps", "stiff")


class Capture(NamedTuple):
    """A checked window's inputs and outputs on its rows: the fixed sample
    first, then the rows drawn among those B2 served."""

    rows: torch.Tensor  # [R] rows of the basin
    fixed: int  # how many of them are the fixed sample
    y_in: torch.Tensor  # [R, N] the state carried into the window
    dense: torch.Tensor  # [R, Q, N]
    carry: torch.Tensor  # [R, N] the state carried out of the window
    stiff: torch.Tensor  # [R] bool: the program handed the row to B2 in this window


class CheckPlan:
    """Which windows the check holds: the first ``first_windows`` in
    sequence, and ``sampled_windows`` drawn uniformly from the seed among the
    later windows the run completes (a reservoir sample, decided before each
    window runs, so that only the kept windows' outputs stay on the card)."""

    def __init__(self, check: dict, seed: int):
        self.first = int(check["first_windows"])
        self.size = int(check["sampled_windows"])
        self.rng = np.random.default_rng(stream_seed(seed, "windows"))
        self.kept: list[int] = []

    def admit(self, k: int) -> tuple[bool, Optional[int]]:
        """(keep window k, the kept window it replaces or None)."""
        if k < self.first:
            return True, None
        i = k - self.first
        if i < self.size:
            self.kept.append(k)
            return True, None
        j = int(self.rng.integers(0, i + 1))
        if j >= self.size:
            return False, None
        old, self.kept[j] = self.kept[j], k
        return True, old


def solver_settings(config: dict, control: bool) -> tuple[torch.dtype, dict]:
    """(state dtype, SolverConfig fields) of a configuration, or of its
    control when ``control`` and the control is a path of the program."""
    solver = dict(config["solver"])
    precision = config["precision"]
    if control:
        over = config["control"].get("program", {})
        precision = over.get("precision", precision)
        solver.update(over.get("solver", {}))
    return (torch.float64 if precision == "f64" else torch.float32), solver


class Stream:
    """The program, its inputs and the stream's state for one run."""

    def __init__(self, cell, seed: int, device, control: bool = False,
                 solve: Optional[Callable] = None):
        import tiger_tpu_torch as program
        from tiger_tpu_torch.forcing import ForcingMeta

        self.cell = cell
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.dtype, settings = solver_settings(cell.config, control)
        self.config = program.SolverConfig(**settings)
        date = {} if cell.doy0 is None else {"doy0": cell.doy0}
        self.model = program.get_model(int(cell.config["program_model"]), **date)
        self.solve = solve or program.solve
        self.forcing_set = program.ForcingSet
        tr = cell.traffic
        self.length = float(tr["window_minutes"])
        ref_model = cell.model
        self.inputs = Inputs(tr, ref_model.PARAM_FIELDS, seed, self.device, self.dtype)
        self.meta = ForcingMeta(self.inputs.offsets, self.inputs.samples, self.inputs.dt)
        step = float(tr["query_minutes"])
        grid = torch.arange(0.0, self.length + 1e-9, step, dtype=torch.float64)
        self.qt_first = grid.to(self.dtype).to(self.device)
        self.qt_next = grid[1:].to(self.dtype).to(self.device)
        y_cold = torch.tensor(ref_model.Y_COLD, dtype=self.dtype, device=self.device)
        self.y = y_cold.repeat(self.inputs.n, 1)
        self.counters = torch.zeros(len(COUNTERS), dtype=torch.int64, device=self.device)
        self.zero = torch.zeros((), dtype=torch.int64, device=self.device)
        check = tr["check"]
        self.plan = CheckPlan(check, seed)
        self.b2_rows = int(check["b2_rows"])
        # Each row's rank in the draw among the rows B2 served: the stiff
        # rows of highest priority are kept.
        gen = torch.Generator(device=self.device)
        gen.manual_seed(stream_seed(seed, "b2_rows"))
        self.priority = torch.rand(self.inputs.n, generator=gen, device=self.device)
        self.rows: Optional[torch.Tensor] = None
        self.captures: dict[int, Capture] = {}
        self.first = None  # window 0's inputs and result, until the sample is fixed

    def window(self, k: int, span=contextlib.nullcontext) -> None:
        """Run window k of the stream; returns after a synchronize."""
        keep, dropped = self.plan.admit(k)
        if dropped is not None:
            del self.captures[dropped]
        with span("bench.draw"):
            forcing = self.forcing_set(data=self.inputs.forcing(k), meta=self.meta)
            y_in = self.y
            qt = self.qt_next if k else self.qt_first
        with span("bench.solve"):
            res = self.solve(self.model, y_in, 0.0, self.length, qt, self.params, forcing,
                             self.config, t_shift=self.inputs.window_start(k))
        with span("bench.carry"):
            self.y = torch.where(torch.isnan(res.y_final), y_in, res.y_final)
            kept = torch.where(res.stiff, 0, res.rk_stats.n_accepted)
            parts = [res.failed.sum(), res.rk_stats.n_accepted.sum(), kept.sum()]
            if res.radau_stats is not None:
                rs = res.radau_stats
                parts += [rs.n_accepted.sum(), rs.n_attempts.sum(), rs.n_newton.sum()]
            else:
                parts += [self.zero] * 3
            parts.append(res.stiff.sum())
            self.counters += torch.stack(parts).to(torch.int64)
            if self.rows is None:
                self.first = (y_in, res)
            elif keep:
                self.keep(k, y_in, res)
        if self.cuda:
            torch.cuda.synchronize(self.device)

    @property
    def params(self) -> dict:
        return self.inputs.params

    def keep(self, k: int, y_in: torch.Tensor, res) -> None:
        """Keep window k's inputs and outputs on the fixed sample and on up
        to ``b2_rows`` of the rows B2 served, drawn by priority (where fewer
        were served, the draw is filled with other rows)."""
        score = torch.where(res.stiff, self.priority, self.priority - 2.0)
        drawn = torch.topk(score, min(self.b2_rows, score.numel())).indices
        rows = torch.cat([self.rows, drawn])
        self.captures[k] = Capture(rows, self.rows.numel(), y_in.index_select(0, rows),
                                   res.dense.index_select(0, rows), self.y.index_select(0, rows),
                                   res.stiff.index_select(0, rows))

    def fix_sample(self, seed: int) -> None:
        """Draw the check's fixed rows once window 0 has run: random rows of
        the basin, some planted stiff rows, and rows window 0 flagged stiff
        on its own; then keep window 0's outputs."""
        spec = self.cell.traffic["check"]
        n = self.inputs.n
        y_in, res = self.first
        gen = torch.Generator().manual_seed(stream_seed(seed, "sample"))
        planted = stiff_rows(self.cell.traffic)
        self.is_planted = torch.zeros(n, dtype=torch.bool)
        self.is_planted[planted] = True
        flagged = torch.nonzero(res.stiff.cpu() & ~self.is_planted).squeeze(1)
        flagged = flagged[torch.randperm(flagged.numel(), generator=gen)[:int(spec["flagged_rows"])]]
        picks = planted[torch.randperm(planted.numel(), generator=gen)[:int(spec["stiff_rows"])]]
        order = torch.randperm(n, generator=gen)
        plain = order[~self.is_planted[order]]
        plain = plain[~torch.isin(plain, flagged)][:int(spec["random_rows"])]
        self.rows = torch.cat([plain, picks, flagged]).to(self.device)
        self.keep(0, y_in, res)
        self.first = None

    def release(self) -> None:
        """Read the counters, keep the checked rows' parameters, and drop the
        program's state and the inputs; the captures stay."""
        self.counts = dict(zip(COUNTERS, (int(v) for v in self.counters.cpu())))
        self.row_params = {}
        for k, cap in self.captures.items():
            self.row_params[k] = {name: v.index_select(0, cap.rows)
                                  for name, v in self.params.items()}
        self.y = self.inputs.params = self.first = self.priority = None
        if self.cuda:
            torch.cuda.empty_cache()

"""How ``correct`` is decided: the program's outputs against the reference.

Once the timed window has closed, the reference (``reference.integrate``,
float64 NumPy) integrates the rows of each checked window (``stream.
CheckPlan``: the first windows in sequence, and windows drawn from the seed
among the rest) from the same inputs the program had.  The rows are the
fixed sample -- random rows, planted stiff rows, rows window 0 flagged stiff
on its own -- and, in every checked window, rows that B2 served in that
window.  In the first windows the fixed sample runs in sequence from the
cold state, so that the cold start and the carry from window to window are
held too; every other row starts from the state the program carried into
the window (the reference cannot afford the windows before).  The reference
reads the time the program's right-hand side reads: window k starts at
``Inputs.window_start(k)``, the program's ``t_shift``, and the configuration's
``doy0`` reaches both sides.

Each entry of the program's dense rows and carried state is judged by its
gap to the reference in units of the configuration's tolerance,
|program - reference| / (atol + rtol |reference|); a NaN counts as an
infinite gap.  Each row of a window is of one kind: ``b2`` where the program
handed it to B2 in that window (the stiff hand-off, B2 and the merge),
``planted`` for the other planted stiff rows, ``plain`` for the rest.  The
numbers:

- ``<kind>_<state>_err``: the widest gap of one state (the model's
  ``STATES``) over the rows of one kind (no number where there are none);
- ``<kind>_rows_err`` over every state, and ``rows_err`` over every row;
- ``failed``: systems the program reported failed, over every window run;
- ``b2_rows_checked``, ``windows_checked``: what the check covered.

The cell's file (``limits``) names the numbers compared and their limits;
the run is correct when each of them is there and at or below its limit.
The others are printed with the run and compared with nothing.

The control of a float32 configuration is the reference itself put in the
program's place with its answers kept in bfloat16 (``reference.bf16``): its
dense rows and its carried state rounded, and each window started from its
start state rounded.  It starts where the program's rows start, and in the
first windows carries its own state.  That is the least error of any
computation that keeps its state or its output in bfloat16.
"""

from __future__ import annotations

import numpy as np

from harness import reference

KINDS = ("plain", "planted", "b2")


def gaps(program: np.ndarray, ref: np.ndarray, rtol: float, atol: float) -> np.ndarray:
    """|program - ref| / (atol + rtol |ref|), with NaN read as infinity."""
    gap = np.abs(program.astype(np.float64) - ref) / (atol + rtol * np.abs(ref))
    return np.where(np.isnan(gap), np.inf, gap)


def compare(stream, rtol: float, atol: float, control: bool = False) -> dict:
    """The numbers compared, from the stream's captures (see module doc);
    with ``control`` the judged outputs are the reference's kept in bfloat16.

    Call after ``stream.release()``: the reference runs on the host, and the
    forcing of each checked window is drawn again on the device, whole, and
    cut to the window's rows.
    """
    traffic = stream.cell.traffic
    model = stream.cell.model
    length = float(traffic["window_minutes"])
    step = float(traffic["query_minutes"])
    first = stream.plan.first
    worst = {kind: np.zeros(model.N_EQ) for kind in KINDS}
    seen = dict.fromkeys(KINDS, 0)
    carried = {"ref": None, "out": None}  # the fixed rows' states out of the last window

    for k in sorted(stream.captures):
        cap = stream.captures[k]
        rows = cap.rows.cpu()
        params = {n: v.double().cpu().numpy() for n, v in stream.row_params[k].items()}
        block = stream.inputs.forcing(k).index_select(1, cap.rows).double().cpu().numpy()
        forcing = [block[off:off + n] for off, n in zip(stream.inputs.offsets, stream.inputs.samples)]
        queries = np.arange(0.0 if k == 0 else step, length + 1e-9, step)
        start = cap.y_in.double().cpu().numpy()
        ref_start, out_start = start.copy(), start.copy()
        if 0 < k < first and carried["ref"] is not None:
            ref_start[:cap.fixed] = carried["ref"]
            out_start[:cap.fixed] = carried["out"]
        args = (params, forcing, stream.inputs.dt, length, queries)
        when = {"t0": stream.inputs.window_start(k), "doy0": stream.cell.doy0}
        dense, final, _ = reference.integrate(model, ref_start, *args, **when)
        if control:
            out_dense, out_final, _ = reference.integrate(model, reference.bf16(out_start),
                                                          *args, **when)
            out_dense, out_final = reference.bf16(out_dense), reference.bf16(out_final)
        else:
            out_dense, out_final = cap.dense.cpu().numpy(), cap.carry.cpu().numpy()
        if k + 1 < first:
            carried = {"ref": final[:cap.fixed],
                       "out": (out_final if control else cap.carry.double().cpu().numpy())[:cap.fixed]}
        g = np.maximum(gaps(out_dense, dense, rtol, atol).max(axis=1),
                       gaps(out_final, final, rtol, atol))
        stiff = cap.stiff.cpu().numpy()
        planted = stream.is_planted[rows].numpy()
        kinds = np.where(stiff, "b2", np.where(planted, "planted", "plain"))
        for kind in KINDS:
            mine = kinds == kind
            if mine.any():
                worst[kind] = np.maximum(worst[kind], g[mine].max(axis=0))
                seen[kind] += int(mine.sum())

    numbers = {"failed": stream.counts["failed"]}
    present = [kind for kind in KINDS if seen[kind]]
    numbers["rows_err"] = float(max(worst[kind].max() for kind in present))
    for kind in present:
        numbers[f"{kind}_rows_err"] = float(worst[kind].max())
        numbers.update({f"{kind}_{name}_err": float(v)
                        for name, v in zip(model.STATES, worst[kind])})
    numbers["b2_rows_checked"] = seen["b2"]
    numbers["windows_checked"] = len(stream.captures)
    return numbers


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers with a limit; a
    limited number the run did not read is None and fails."""
    table = {name: {"value": numbers.get(name), "limit": limit} for name, limit in limits.items()}
    ok = bool(limits) and all(v["value"] is not None and v["value"] <= v["limit"]
                              for v in table.values())
    return ok, table

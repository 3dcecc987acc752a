"""The frozen work of a window: operations and bytes, whatever computes them.

A kernel's roofline share and the window's share of the chip's peak need the
work the answer requires, not the work a kernel happened to do.  So the
operations are the accepted steps times a fixed count per step: the cell's
file freezes the mean accepted steps per link and window that its first
chip runs measured (``work`` in ``gpu_bench/cells/<cell>.json``), and this
file freezes the count per step, from r, the operations of one right-hand
side, which the model's module states (``RHS_OPS`` in
``gpu_bench/models/<model>.py``, with its count written out there).
Rejected attempts, and the steps B1 spent on rows it then handed to B2, are
waste and count nothing.

The rule of the count: every add, subtract, multiply, divide, min, max,
compare-and-select, log2, exp2, exp, sin, cos, tan, atan, asin and acos is
one operation; a constant term is folded, and a loop-invariant one (a
parameter's reciprocal, the sine of the latitude) is taken once per system
and not counted.  A model that reads time counts its use of time (the day of
year from t) in its own r.  A transcendental function costs the card many
instructions and counts one here, so every roofline share and share of the
peak stays a floor, never above the truth.

B1, one accepted Dormand-Prince 5(4) step of N = 5 states, 6r + 386
operations: six right-hand sides 6r (the seventh stage, f at the new state,
is the next step's first: first same as last); the six stage states and the
new state, 20 nonzero coefficients a_sj, a product and an add each, and per
stage a product by h and an add to y: 5 x (20 x 2 + 6 x 2) = 260; the
error norm, six nonzero e_j (6 products, 5 adds, one product by h), the
scale atol + rtol max(|y|, |y_new|) (5), the squared ratio (2) and its
sum (1): 5 x 20 = 100, then mean and root 2; the step-size update 10;
the cap at the next forcing boundary and the forcing gather, two
forcings: 14.
B1's dense fill, one query of N states, 141 operations: the quartic
interpolant's seven weights in theta (Horner, 4 products and 4 adds each),
shared by the states, 56; per state their sum against the stages 14 and
y + h theta (...) 3: 5 x 17.

B2, one accepted 3-stage Radau IIA step of N = 5 states:
  per attempt 7r + 613 operations: f and the Jacobian by differences, six
  right-hand sides (6r) and 25 differences scaled (50) and the five
  perturbations (20); the two factorizations of gamma/h - J (real) and
  (alpha + i beta)/h - J (complex), their diagonals 10 + 20, the real 5 x 5
  LU 70 and the complex one at four real operations for each of its 70,
  frozen at 410; the embedded error estimate, one right-hand side (r), the
  stage combination (30), one real solve (45), the norm (28) and the update
  (15); the step-size update 15;
  per Newton sweep 3r + 454 operations: three stage right-hand sides 3r; the
  transformed residuals, 3 x 3 per state twice (2 x 75) and their terms
  30; the real solve 45; the complex solve 180; the increment's norm 20;
  the update of the stages 30 and of the transformed stages 75, frozen at
  454.  (Itemized, the factorizations come to 380 and the sweep's other
  terms to 530; the totals 410 and 454 stay, since the standing cell's
  readings were taken with them.)
B2's dense fill, one query, 58 operations: the collocation cubic's three
weights in theta (Horner, 3 products and 3 adds each), shared by the
states, 18; per state the sum against the stages, plus y and h: 5 x 8.

Bytes: each input read once and each output written once per window -- the
states, initial steps, parameters and the forcing block in, the final
states, dense rows, two flags and three counters a system out.
"""

from __future__ import annotations

B1_QUERY = 56 + 5 * 17
B2_QUERY = 18 + 5 * 8
N_EQ = 5
N_PARAMS = 15


def b1_step(rhs_ops: int) -> int:
    """Operations of one accepted B1 step, with ``rhs_ops`` a right-hand side."""
    return 6 * rhs_ops + 260 + 102 + 10 + 14


def b2_attempt(rhs_ops: int) -> int:
    """Operations of one B2 attempt outside its Newton sweeps."""
    return 7 * rhs_ops + 50 + 20 + 410 + 30 + 45 + 28 + 15 + 15


def b2_sweep(rhs_ops: int) -> int:
    """Operations of one of B2's Newton sweeps."""
    return 3 * rhs_ops + 454


def window_work(cell_work: dict, rhs_ops: int, links: int, queries: int, forcing_rows: int,
                elem_bytes: int) -> dict:
    """Operations and bytes of one window of B1 and of B2, from the cell's
    frozen counts: ``b1_steps`` and ``b2_steps`` (accepted steps per link and
    window), ``b2_sweeps_per_step`` and ``stiff_rows`` (rows a window hands
    to B2); ``rhs_ops`` is the model's ``RHS_OPS``."""
    stiff = float(cell_work.get("stiff_rows", 0.0))
    b1_rows = links - stiff
    b1_ops = (links * cell_work["b1_steps"] * b1_step(rhs_ops)
              + b1_rows * queries * B1_QUERY)
    b2_ops = (links * cell_work.get("b2_steps", 0.0)
              * (b2_attempt(rhs_ops)
                 + cell_work.get("b2_sweeps_per_step", 0.0) * b2_sweep(rhs_ops))
              + stiff * queries * B2_QUERY)

    def io(rows, forcing=True):
        read = rows * (N_EQ + 1 + N_PARAMS) * elem_bytes + (forcing_rows * rows * 4 if forcing else 0)
        written = rows * (N_EQ + queries * N_EQ) * elem_bytes + rows * (2 + 3 * 4)
        return read + written

    return {"b1_ops": b1_ops, "b2_ops": b2_ops, "b1_bytes": io(links), "b2_bytes": io(stiff)}


def least_seconds(ops: float, nbytes: float, peaks: dict, precision: str) -> tuple[float, str]:
    """(the least time the card could take, the bound that binds)."""
    t_ops = ops / peaks["flops_per_s"][precision]
    t_bytes = nbytes / peaks["bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

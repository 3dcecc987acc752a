"""DummyModel: 5-state linear test system (port of tiger_tpu/models/dummy.py).

    dH0 = 1.0 - 0.5*H0
    dH1 = 1.2 + 0.5*H0 - 0.3*H1 - 0.4 - 0.6*H1
    dH2 = 0.3*H1 - 0.2
    dH3 = 0.6*H1 - 0.4*H3 - 0.3
    dH4 = 0.4*H3 - 0.1

With y0 = [1,1,1,1,1] over t in [0, 5] at rtol 1e-6 / atol 1e-9 it must
reproduce the reference's golden final state.  The CUDA kernels do not carry
this model: it runs on the plain (CPU) path only.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DummyModel:
    N_EQ: int = 5
    UID: int = 1

    def rhs_tuple(self, t, y, params=None, forcings=None) -> tuple:
        H0, H1, H2, H3, H4 = y[0], y[1], y[2], y[3], y[4]
        dH0 = 1.0 - 0.5 * H0
        dH1 = 1.2 + 0.5 * H0 - 0.3 * H1 - 0.4 - 0.6 * H1
        dH2 = 0.3 * H1 - 0.2
        dH3 = 0.6 * H1 - 0.4 * H3 - 0.3
        dH4 = 0.4 * H3 - 0.1
        return (dH0, dH1, dH2, dH3, dH4)

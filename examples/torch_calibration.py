"""Ensemble parameter calibration on the port's batch axis.

A K-member parameter ensemble for an S-link basin is one solve of S*K
systems: tile the links K times, perturb each copy's parameters, integrate
everything in one call, score each member against the observed discharge,
and keep the best member of each link.

    python examples/torch_calibration.py          # on the CUDA card
    python examples/torch_calibration.py --cpu    # the kernels' plain versions
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

# Runnable straight from a git checkout, no install needed.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--links", type=int, default=64)
    p.add_argument("--members", type=int, default=32)
    p.add_argument("--hours", type=int, default=48)
    args = p.parse_args()

    from tiger_tpu_torch import ForcingSet, Model204, SolverConfig, solve
    from tiger_tpu_torch.routing import link_runoff_204

    dev = torch.device("cpu" if args.cpu else "cuda")
    S, K, hours = args.links, args.members, args.hours
    tf = hours * 60.0
    rng = np.random.default_rng(0)

    # --- "truth": a basin with per-link parameters we pretend not to know --
    base = dict(
        c1=0.001 / 60.0, infil=7.0e-5, perco=2.7e-5, Hu=178.0, lat=41.5,
        sw=0.11, ss=0.33, n_mann=0.1, slope=0.02, L=0.6, A_h=0.76,
        alpha3=2880.0, alpha4=79200.0, melt_f=3.7, temp_thr=0.0,
    )
    truth = {k: torch.as_tensor(np.full(S, v) * rng.uniform(0.7, 1.4, S), dtype=torch.float32,
                                device=dev) for k, v in base.items()}
    pr = rng.gamma(0.15, 2.0, (hours, S)).astype(np.float32)
    t2m = rng.uniform(2.0, 12.0, (-(-hours // 24), S)).astype(np.float32)
    forc = ForcingSet.from_series([pr, t2m], [60.0, 1440.0], device=dev)
    y0 = torch.tensor([0.01, 3.0, 0.0, 5.0, 0.2], dtype=torch.float32, device=dev).repeat(S, 1)
    qt = torch.arange(0.0, tf + 1e-9, 60.0, dtype=torch.float32, device=dev)
    cfg = SolverConfig(rtol=1e-5, atol=1e-6)

    def hydrograph(res, params):  # [S', Q] link outflow at each query
        return link_runoff_204(torch.nan_to_num(res.dense), {k: v[:, None] for k, v in params.items()})

    q_obs = hydrograph(solve(Model204(), y0, 0.0, tf, qt, params=truth, forcings=forc, config=cfg),
                       truth)

    # --- ensemble: K perturbed copies of every link, one batched solve -----
    # The prior is the uncalibrated table (``base``); member k of link s is
    # row k*S + s, and member 0 is the prior itself.
    prior = {k: torch.full((S,), v, dtype=torch.float32, device=dev) for k, v in base.items()}
    ens = {k: v.repeat(K) for k, v in prior.items()}
    for name in ("Hu", "n_mann", "infil", "melt_f"):
        factors = rng.uniform(0.5, 2.0, (K, S)).astype(np.float32)
        factors[0] = 1.0
        ens[name] = ens[name] * torch.as_tensor(factors.reshape(K * S), device=dev)
    forc_ens = ForcingSet(data=forc.data.repeat(1, K), meta=forc.meta)

    start = time.perf_counter()
    run = solve(Model204(), y0.repeat(K, 1), 0.0, tf, qt, params=ens, forcings=forc_ens, config=cfg)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - start
    q_ens = hydrograph(run, ens).reshape(K, S, -1)

    # --- score and select ---------------------------------------------------
    rmse = ((q_ens - q_obs[None]) ** 2).mean(dim=2).sqrt()  # [K, S]
    best = rmse.argmin(dim=0)
    links = torch.arange(S, device=dev)
    hu = ens["Hu"].reshape(K, S)[best, links]
    hu_err = float((hu / truth["Hu"] - 1.0).abs().median())
    print(f"{K}-member ensemble x {S} links = {K * S} systems on {dev} in {wall:.2f} s; "
          f"median hydrograph RMSE {float(rmse[0].median()):.3g} -> "
          f"{float(rmse[best, links].median()):.3g}; median |Hu err| of the selected members: "
          f"{hu_err:.1%}")


if __name__ == "__main__":
    main()

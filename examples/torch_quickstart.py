"""Quickstart on the PyTorch port: a synthetic basin, integrated and routed.

    python examples/torch_quickstart.py          # on the CUDA card
    python examples/torch_quickstart.py --cpu    # the kernels' plain versions

For real basins use the CLI (python -m tiger_tpu_torch.run --config
simulation.yaml); see examples/simulation.yaml.
"""

import argparse
import os
import sys

import numpy as np
import torch

# Runnable straight from a git checkout, no install needed.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tiger_tpu_torch import ForcingSet, Model204, SolverConfig, solve  # noqa: E402
from tiger_tpu_torch import routing  # noqa: E402
from tiger_tpu_torch.models.model204 import Y0_COMMON  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--links", type=int, default=1000)
    args = p.parse_args()
    dev = torch.device("cpu" if args.cpu else "cuda")
    rng = np.random.default_rng(0)
    n_links = args.links

    # ---- spatial parameters (tiger_tpu_torch.params loads the CSV) -------
    c1 = 0.001 / 60.0
    fields = {
        "c1": np.full(n_links, c1),
        "infil": rng.uniform(3, 8, n_links) * c1,
        "perco": rng.uniform(1, 4, n_links) * c1,
        "Hu": rng.uniform(0.2, 0.6, n_links),
        "lat": np.full(n_links, 41.5),
        "sw": np.full(n_links, 0.2),
        "ss": np.full(n_links, 0.8),
        "n_mann": np.full(n_links, 0.03),
        "slope": rng.uniform(0.01, 0.08, n_links),
        "L": rng.uniform(0.5, 3.0, n_links),
        "A_h": rng.uniform(5, 30, n_links),
        "alpha3": np.full(n_links, 2.0 * 1440.0),
        "alpha4": np.full(n_links, 5.0 * 1440.0),
        "melt_f": np.full(n_links, 1e-4),
        "temp_thr": np.zeros(n_links),
    }
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in fields.items()}

    # Hourly rain and daily temperature for 2 days, already on the links
    # (tiger_tpu_torch.forcing.load_forcings remaps NetCDF grids).
    pr = rng.uniform(0, 0.0015, (48, n_links)).astype(np.float32)
    t2m = rng.uniform(2, 12, (2, n_links)).astype(np.float32)
    forcings = ForcingSet.from_series([pr, t2m], [60.0, 1440.0], device=dev)

    # A random river network: every link drains into a higher-numbered one.
    stream = np.arange(1, n_links + 1)
    nxt = np.where(rng.uniform(size=n_links) < 0.9,
                   np.minimum(stream + rng.integers(1, 50, n_links), n_links), -1)
    nxt[-1] = -1

    # ---- integrate ---------------------------------------------------------
    y0 = torch.tensor(Y0_COMMON, dtype=torch.float32, device=dev).repeat(n_links, 1)
    query_times = torch.arange(0.0, 2881.0, 60.0, dtype=torch.float32, device=dev)
    res = solve(Model204(), y0, 0.0, 2880.0, query_times, params=params, forcings=forcings,
                config=SolverConfig(rtol=1e-5, atol=1e-8))
    print(f"integrated {n_links} links x 2 days on {dev}: "
          f"{int(res.rk_stats.n_attempts.sum())} steps, {res.n_stiff} stiff, "
          f"{int(res.failed.sum())} failed")
    print("final state of link 0:", np.round(res.y_final[0].cpu().numpy(), 5))

    # ---- route the discharge -----------------------------------------------
    topo = routing.build_topology(stream, nxt)
    q = routing.routed_discharge(res.dense, params, topo)
    outlet = int(torch.argmax(q[:, -1]))
    print(f"network depth {topo.depth}; biggest outlet is link {outlet} with "
          f"discharge {float(q[outlet, -1]):.4f} at t=2880 min")


if __name__ == "__main__":
    main()

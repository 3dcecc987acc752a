"""One rank of tests/test_torch_dist.py's process groups (gloo, on the CPU).

    python tests/_torch_dist_worker.py exchange COORD WORLD RANK JOB OUT
        joins the group, and for each case of JOB (torch.save of a list of
        dicts: stream, next_stream, q [S, W] float64, bounds 'even' or
        'uniform') runs routing.exchange_sharded twice on its rows, and
        accumulate_downstream_sharded on q's first column; saves {"rows":
        [slice], "runs": [(first, second)], "vector": [first column]} to OUT;
    python tests/_torch_dist_worker.py crash WINDOW ARGS...
        runs ``python -m tiger_tpu_torch.run ARGS...`` with the solve of
        window WINDOW (1 is the first) raising, as a crash would.
"""

import sys

import numpy as np
import torch


def exchange(coordinator, world, rank, job_path, out_path):
    from tiger_tpu_torch import routing
    from tiger_tpu_torch.dist import init_process, shard_rows_for_process
    from tiger_tpu_torch.params import split_even

    init_process(coordinator, int(world), int(rank), "gloo")
    out = {"rows": [], "runs": [], "vector": []}
    try:
        for case in torch.load(job_path, weights_only=False):
            topo = routing.build_topology(case["stream"], case["next_stream"])
            n = len(case["stream"])
            bounds = split_even(n, int(world)) if case["bounds"] == "even" else None
            plan = routing.plan_sharded_topology(topo, int(world), bounds)
            start, size = plan.starts[int(rank)], plan.sizes[int(rank)]
            q = torch.as_tensor(np.asarray(case["q"])[start:start + size])
            out["rows"].append(shard_rows_for_process(n))
            out["runs"].append(tuple(routing.exchange_sharded(q, plan).numpy()
                                     for _ in range(2)))
            out["vector"].append(routing.accumulate_downstream_sharded(q[:, 0], plan).numpy())
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, out_path)


def crash(window, *argv):
    from tiger_tpu_torch import chunked
    from tiger_tpu_torch.run import main

    real_solve, calls = chunked.solve, {"n": 0}

    def dying_solve(*a, **kw):
        calls["n"] += 1
        if calls["n"] == int(window):
            raise RuntimeError("simulated crash")
        return real_solve(*a, **kw)

    chunked.solve = dying_solve
    return main(list(argv))


if __name__ == "__main__":
    mode, *args = sys.argv[1:]
    sys.exit({"exchange": exchange, "crash": crash}[mode](*args))

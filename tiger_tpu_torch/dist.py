"""Several processes: the process group, each rank's rows and device.

Port of ``tiger_tpu/dist.py``.  The reference's MPI layer had rank 0 scatter
the SpatialParams rows (main.cpp:257-310); here every process reads the
whole parameter table and keeps its own contiguous rows
(``shard_rows_for_process``, the ``params.split_even`` split), solves them
end to end on its own device, and writes its own rank-tagged files.  Only
the routed discharge needs the other ranks (``routing.exchange_sharded``,
``run._make_cross_rank_routed``), over ``torch.distributed``.

One process's rows split over several of its devices is
``solver.api.solve(..., devices=[...])``.

    python -m tiger_tpu_torch.run --config sim.yaml --distributed \\
        --coordinator host:port --num-processes 2 --process-id 0 --dist-backend nccl

or under ``torchrun`` (its RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT and
LOCAL_RANK).  Not carried over: the HLO collective audit (``lower_only``:
there is no HLO) and the cross-process global-mesh solve of the stiff rows
(the JAX ``run`` never builds that mesh either: each rank owns its rows).
"""

from __future__ import annotations

import datetime
import os

import torch

from tiger_tpu_torch.params import split_even

#: Seconds a collective waits for the other ranks before it fails: a rank
#: that dies makes the others fail instead of hang.
TIMEOUT_S = 120.0


def init_process(coordinator: str | None = None, num_processes: int | None = None,
                 process_id: int | None = None, backend: str | None = None,
                 timeout_s: float = TIMEOUT_S) -> None:
    """Join the process group: ``torch.distributed.init_process_group`` at
    ``tcp://{coordinator}`` (host:port) with ``num_processes`` ranks, as
    rank ``process_id``.  Each argument left None is read from torchrun's
    environment: MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK.

    ``backend`` ('nccl' or 'gloo') is the caller's choice: nothing picks
    one.  'nccl' needs a card for each rank of a host: NCCL cannot put two
    ranks on one GPU, so more ranks on this host (LOCAL_WORLD_SIZE, else
    ``num_processes``) than cards is refused before the group is formed.
    """
    import torch.distributed as dist

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    env = os.environ
    if coordinator is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("no coordinator: give host:port, or MASTER_ADDR and MASTER_PORT")
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "0")) or None
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if num_processes is None or process_id is None:
        raise ValueError("give the number of processes and this process's id "
                         "(or WORLD_SIZE and RANK)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, {num_processes})")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise ValueError("the nccl backend needs CUDA cards; this host has none")
        local = int(env.get("LOCAL_WORLD_SIZE", num_processes))
        cards = torch.cuda.device_count()
        if local > cards:
            raise ValueError(
                f"nccl with {local} ranks on this host's {cards} card(s): NCCL cannot put "
                "two ranks on one GPU; use one card a rank, or --dist-backend gloo")
        torch.cuda.set_device(device_for_process(rank=process_id))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def shard_rows_for_process(n_rows: int) -> slice:
    """This process's rows of an ``n_rows`` table: an even split, the
    remainder over the first processes (the reference's rank-0 row
    scatter, main.cpp:269-308)."""
    return split_even(n_rows, process_count())[process_index()]


def device_for_process(cpu: bool = False, rank: int | None = None) -> torch.device:
    """The device of this process: ``cuda:(local_rank % device_count)``,
    the local rank from LOCAL_RANK (torchrun) or else the rank.  The CPU
    only when the caller asks for it (``cpu=True``, the CLI's ``--cpu``)."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: run with --cpu to use the CPU")
    local = int(os.environ.get("LOCAL_RANK", process_index() if rank is None else rank))
    return torch.device("cuda", local % torch.cuda.device_count())

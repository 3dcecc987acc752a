"""Downstream routing: river-network accumulation of link runoff, one device.

Port of the single-device half of ``tiger_tpu/routing.py``:

  - ``build_topology``: stream/next_stream ids -> downstream row index
    (outlets and links draining outside the basin get -1), network depth
    and the pointer-doubling tables (numpy, a copy of the JAX package's);
  - ``link_runoff_204``: each link's instantaneous outflow from its Model-204
    stores (``models.model204.link_outflow``), the quantity routed;
  - ``accumulate_downstream_log``: acc = (I + S)(I + S^2)(I + S^4)... q for
    the downstream scatter matrix S, one ``index_add`` per doubling round;
  - ``accumulate_downstream``: the O(depth) fixpoint acc <- q + S acc, kept
    as the brute-force oracle of the tests;
  - ``routed_discharge``: the hydrograph [S, Q] of a dense output block.

``index_add_`` on CUDA adds with atomics, so routed discharge on the card
is not bit-reproducible from run to run: the sums are the same to within
float rounding, in another order.  The sharded exchange across processes
is not ported (ROADMAP Queue 1 #16).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Topology(NamedTuple):
    next_idx: np.ndarray  # [S] int32; downstream link's row, -1 if none in basin
    depth: int  # longest path length (rounds needed for exact accumulation)
    # [R, S] int32 pointer-doubling tables: row j holds each link's 2^j-th
    # downstream row (-1 if the path ends sooner).  R = ceil(log2(depth+1)).
    ptr_tables: np.ndarray


def build_topology(stream_ids: np.ndarray, next_stream_ids: np.ndarray) -> Topology:
    """Resolve next_stream ids to row indices; compute network depth (host)."""
    stream_ids = np.asarray(stream_ids, np.int64)
    next_ids = np.asarray(next_stream_ids, np.int64)
    order = np.argsort(stream_ids, kind="stable")
    sorted_ids = stream_ids[order]
    pos = np.searchsorted(sorted_ids, next_ids)
    pos_clip = np.clip(pos, 0, len(sorted_ids) - 1)
    found = sorted_ids[pos_clip] == next_ids
    next_idx = np.where(found, order[pos_clip], -1).astype(np.int32)

    # Path length to termination via pointer doubling (host, O(S log depth)):
    # cnt[i] = hops accumulated along ptr; after round k, ptr is the 2^k-th
    # successor (or -1 once the path end is absorbed).  The ptr snapshots are
    # the device doubling tables.
    if len(next_idx) == 0:
        return Topology(
            next_idx=next_idx, depth=0,
            ptr_tables=np.zeros((0, 0), np.int32),
        )
    ptr = next_idx.astype(np.int64)
    cnt = (ptr >= 0).astype(np.int64)
    tables = []
    rounds = 0
    while (ptr >= 0).any():
        tables.append(ptr.astype(np.int32))
        idx = np.clip(ptr, 0, None)
        cnt = cnt + np.where(ptr >= 0, cnt[idx], 0)
        ptr = np.where(ptr >= 0, ptr[idx], -1)
        rounds += 1
        if rounds > int(np.log2(len(next_idx) + 1)) + 2:
            raise ValueError("Routing topology contains a cycle")
    depth = int(cnt.max())
    n_rounds = 0 if depth == 0 else int(np.ceil(np.log2(depth + 1)))
    ptr_tables = (
        np.stack(tables[:n_rounds])
        if n_rounds
        else np.zeros((0, len(next_idx)), np.int32)
    )
    return Topology(next_idx=next_idx, depth=depth, ptr_tables=ptr_tables)


def link_runoff_204(y: torch.Tensor, params: dict) -> torch.Tensor:
    """Instantaneous local outflow per link [m * km^2 / min] from the
    Model-204 stores (``y`` [S, N], or [S, Q, N] with params of [S, 1])."""
    from tiger_tpu_torch.models.model204 import link_outflow

    return link_outflow(y, params)


def _scatter_round(x: torch.Tensor, ptr_row: torch.Tensor) -> torch.Tensor:
    """x + S_row x: each row's value added onto the row ``ptr_row`` names
    (-1: nowhere)."""
    valid = ptr_row >= 0
    tgt = torch.where(valid, ptr_row, torch.zeros_like(ptr_row))
    mask = valid.reshape(valid.shape + (1,) * (x.ndim - 1))
    return x.index_add(0, tgt, torch.where(mask, x, torch.zeros_like(x)))


def accumulate_downstream(q: torch.Tensor, next_idx: torch.Tensor, n_iters: int) -> torch.Tensor:
    """acc[v] = q[v] + sum of q over all links upstream of v.

    The O(depth) fixpoint acc <- q + S acc, exact after ``n_iters`` >=
    Topology.depth rounds: the brute-force oracle of
    ``accumulate_downstream_log``.  ``q`` is [S] or [S, ...].
    """
    valid = next_idx >= 0
    tgt = torch.where(valid, next_idx, torch.zeros_like(next_idx)).to(torch.int64)
    mask = valid.reshape(valid.shape + (1,) * (q.ndim - 1))
    acc = q
    for _ in range(n_iters):
        acc = q + torch.zeros_like(q).index_add(0, tgt, torch.where(mask, acc, torch.zeros_like(acc)))
    return acc


def accumulate_downstream_log(q: torch.Tensor, ptr_tables: torch.Tensor) -> torch.Tensor:
    """acc[v] = q[v] + sum over upstream links, in O(log depth) rounds.

    Round j adds the current partial sums through the 2^j-th-successor
    table: (I + S)(I + S^2)(I + S^4)...q = sum_k S^k q.  ``q`` is [S] or
    [S, ...] (every trailing column accumulates alike); ``ptr_tables`` is
    [R, S] on q's device.
    """
    x = q
    for row in ptr_tables:
        x = _scatter_round(x, row)
    return x


#: One-slot device cache of Topology.ptr_tables: a caller routing window
#: after window of one topology uploads the [rounds, S] tables once.  It
#: holds the host array itself and compares with ``is`` (an id()-keyed
#: cache could serve a stale topology when CPython reuses the address).
_tables_cache: tuple = (None, None, None)


def _device_tables(topo: Topology, device: torch.device) -> torch.Tensor:
    global _tables_cache
    host, dev, tables = _tables_cache
    if host is not topo.ptr_tables or dev != device:
        tables = torch.as_tensor(topo.ptr_tables, dtype=torch.int64, device=device)
        _tables_cache = (topo.ptr_tables, device, tables)
    return tables


def routed_discharge(dense: torch.Tensor, params: dict, topo: Topology) -> torch.Tensor:
    """Routed hydrograph [S, Q]: downstream-accumulated link outflow at each
    query time, on the dense tensor's device (NaN states — unfinished
    systems — contribute zero).  ``params`` holds the Model-204 fields as
    [S] tensors on that device."""
    col = {k: v[:, None] for k, v in params.items()}
    q = link_runoff_204(torch.nan_to_num(dense), col)  # [S, Q]
    return accumulate_downstream_log(q, _device_tables(topo, dense.device))

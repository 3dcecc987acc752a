"""Downstream routing: river-network accumulation of link runoff, one device.

Port of the single-device half of ``tiger_tpu/routing.py``:

  - ``build_topology``: stream/next_stream ids -> downstream row index
    (outlets and links draining outside the basin get -1), network depth
    and the pointer-doubling tables (numpy, the JAX package's), plus the
    summation plan of ``accumulate_downstream_log``;
  - ``link_runoff_204``: each link's instantaneous outflow from its Model-204
    stores (``models.model204.link_outflow``), the quantity routed;
  - ``accumulate_downstream_log``: acc[v] = the sum of q over v's upstream
    subtree, in O(log S) gather-and-add passes, in a fixed order;
  - ``accumulate_downstream``: the O(depth) fixpoint acc <- q + S acc, kept
    as the brute-force oracle of the tests;
  - ``routed_discharge``: the hydrograph [S, Q] of a dense output block.

The order of summation is fixed by the topology alone, so the result has
the same bits from run to run and on every device.  The JAX package sums
through scatter-adds over the doubling tables; on the card such an
``index_add`` adds with atomics, in an order that changes from run to run.
Here each link's upstream subtree is a contiguous range of a depth-first
preorder of the network (children in row order).  The range is cut, left to
right, into aligned power-of-two blocks, each block the pairwise sum of its
two halves, and the blocks are added left to right: nothing but gathers and
elementwise adds.  The sharded exchange across processes is not ported
(ROADMAP Queue 1 #16).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SumPlan(NamedTuple):
    """Host arrays of the fixed-order subtree sums (``build_topology``)."""

    perm: np.ndarray  # [S] int64: the row at each preorder position
    # K arrays of flat block ids, one per pass: pass k adds the k-th block
    # (from the left) of the links that have one.  The accumulator holds the
    # links with the most blocks first, so pass k covers a prefix of it.
    blocks: tuple
    where: np.ndarray  # [S] int64: the accumulator row of each link
    n_levels: int  # block levels 0..n_levels-1 (level k: blocks of 2^k)


class Topology(NamedTuple):
    next_idx: np.ndarray  # [S] int32; downstream link's row, -1 if none in basin
    depth: int  # longest path length (rounds needed for exact accumulation)
    # [R, S] int32 pointer-doubling tables: row j holds each link's 2^j-th
    # downstream row (-1 if the path ends sooner).  R = ceil(log2(depth+1)).
    ptr_tables: np.ndarray
    plan: SumPlan


def _floor_log2(n: np.ndarray) -> np.ndarray:
    """floor(log2(n)) of positive integers below 2^53, exactly."""
    return np.frexp(n.astype(np.float64))[1].astype(np.int64) - 1


def _path_sums(val: np.ndarray, tables) -> np.ndarray:
    """Each link's sum of ``val`` over its path to the outlet (itself
    included), by pointer doubling: after round j a link holds the sum over
    the first 2^(j+1) links of its path."""
    for row in tables:
        val = val + np.where(row >= 0, val[np.clip(row, 0, None)], 0)
    return val


def _subtree_sums(val: np.ndarray, tables) -> np.ndarray:
    """Each link's sum of ``val`` over its upstream subtree (integers, so the
    scatter order does not matter): (I + S)(I + S^2)...val."""
    for row in tables:
        add = np.zeros_like(val)
        valid = row >= 0
        np.add.at(add, row[valid], val[valid])
        val = val + add
    return val


def _sum_plan(next_idx: np.ndarray, tables) -> SumPlan:
    """The preorder layout and the block decomposition of every subtree."""
    s_count = len(next_idx)
    size = _subtree_sums(np.ones(s_count, np.int64), tables)
    # Preorder position = the sum, over the path to the outlet, of each
    # link's offset within its parent's range: 1 + the sizes of its earlier
    # siblings (children in row order); an outlet's offset is the sizes of
    # the earlier outlets.
    off = np.zeros(s_count, np.int64)
    kids = np.flatnonzero(next_idx >= 0)
    kids = kids[np.argsort(next_idx[kids], kind="stable")]
    sz = size[kids]
    incl = np.cumsum(sz)
    par = next_idx[kids]
    first = np.r_[True, par[1:] != par[:-1]] if len(kids) else np.zeros(0, bool)
    start = np.maximum.accumulate(np.where(first, np.arange(len(kids)), 0))
    off[kids] = 1 + (incl - sz) - (incl[start] - sz[start])
    roots = np.flatnonzero(next_idx < 0)
    off[roots] = np.cumsum(size[roots]) - size[roots]
    pos = _path_sums(off, tables)
    perm = np.empty(s_count, np.int64)
    perm[pos] = np.arange(s_count)

    # Level k holds ceil(S / 2^k) blocks; flat id = level offset + index.
    n_levels = int(_floor_log2(np.array([max(s_count, 1)]))[0]) + 1
    sizes = [-(-s_count // (1 << k)) for k in range(n_levels)]
    level_off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    # Greedy left-to-right decomposition: each pass takes, for every link
    # whose range is not yet covered, the largest aligned block that starts
    # at the range's left end and fits in it.
    rows, lo, hi = np.arange(s_count), pos.copy(), pos + size
    passes = []
    used = 0
    while rows.size:
        k = np.minimum(_floor_log2(hi - lo),
                       np.where(lo > 0, _floor_log2(np.maximum(lo & -lo, 1)), n_levels))
        passes.append((rows, level_off[k] + (lo >> k)))
        used = max(used, int(k.max()))
        lo = lo + (np.int64(1) << k)
        keep = lo < hi
        rows, lo, hi = rows[keep], lo[keep], hi[keep]
    counts = np.zeros(s_count, np.int64)
    for rows_j, _ in passes:
        counts[rows_j] += 1
    order = np.argsort(-counts, kind="stable")
    where = np.empty(s_count, np.int64)
    where[order] = np.arange(s_count)
    blocks = []
    for rows_j, flat_j in passes:  # pass j's links: the first len(rows_j) of order
        blk = np.empty(len(rows_j), np.int64)
        blk[where[rows_j]] = flat_j
        blocks.append(blk)
    return SumPlan(perm=perm, blocks=tuple(blocks), where=where, n_levels=used + 1)


def build_topology(stream_ids: np.ndarray, next_stream_ids: np.ndarray) -> Topology:
    """Resolve next_stream ids to row indices; compute the network depth and
    the summation plan (host)."""
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
    # the doubling tables.
    if len(next_idx) == 0:
        empty = np.zeros(0, np.int64)
        return Topology(
            next_idx=next_idx, depth=0, ptr_tables=np.zeros((0, 0), np.int32),
            plan=SumPlan(perm=empty, blocks=(), where=empty, n_levels=1),
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
    plan = _sum_plan(next_idx, [r.astype(np.int64) for r in ptr_tables])
    return Topology(next_idx=next_idx, depth=depth, ptr_tables=ptr_tables, plan=plan)


def link_runoff_204(y: torch.Tensor, params: dict) -> torch.Tensor:
    """Instantaneous local outflow per link [m * km^2 / min] from the
    Model-204 stores (``y`` [S, N], or [S, Q, N] with params of [S, 1])."""
    from tiger_tpu_torch.models.model204 import link_outflow

    return link_outflow(y, params)


def accumulate_downstream(q: torch.Tensor, next_idx: torch.Tensor, n_iters: int) -> torch.Tensor:
    """acc[v] = q[v] + sum of q over all links upstream of v.

    The O(depth) fixpoint acc <- q + S acc, exact after ``n_iters`` >=
    Topology.depth rounds: the brute-force oracle of
    ``accumulate_downstream_log`` (its ``index_add`` is not reproducible
    on the card).  ``q`` is [S] or [S, ...].
    """
    valid = next_idx >= 0
    tgt = torch.where(valid, next_idx, torch.zeros_like(next_idx)).to(torch.int64)
    mask = valid.reshape(valid.shape + (1,) * (q.ndim - 1))
    acc = q
    for _ in range(n_iters):
        acc = q + torch.zeros_like(q).index_add(0, tgt, torch.where(mask, acc, torch.zeros_like(acc)))
    return acc


class _DevicePlan(NamedTuple):
    perm: torch.Tensor
    blocks: tuple
    where: torch.Tensor
    n_levels: int


#: One-slot device cache of a Topology's plan: a caller routing window after
#: window of one topology uploads it once.  It holds the host plan itself
#: and compares with ``is`` (an id()-keyed cache could serve a stale
#: topology when CPython reuses the address).
_plan_cache: tuple = (None, None, None)


def _device_plan(topo: Topology, device: torch.device) -> _DevicePlan:
    global _plan_cache
    host, dev, plan = _plan_cache
    if host is not topo.plan or dev != device:
        p = topo.plan

        def up(a):
            return torch.as_tensor(a, dtype=torch.int64, device=device)

        plan = _DevicePlan(up(p.perm), tuple(up(b) for b in p.blocks), up(p.where), p.n_levels)
        _plan_cache = (topo.plan, device, plan)
    return plan


def accumulate_downstream_log(q: torch.Tensor, topo: Topology) -> torch.Tensor:
    """acc[v] = q[v] + sum over upstream links, in a fixed order.

    ``q`` is [S] or [S, ...] (every trailing column accumulates alike).  In
    the preorder layout, level k + 1 of the block sums is level k's pairs
    added; pass j then adds each link's j-th block from the left, so every
    link's sum is ((b0 + b1) + b2) + ... of pairwise block sums: the same
    bits on every device and in every run.
    """
    if q.shape[0] == 0:
        return q.clone()
    plan = _device_plan(topo, q.device)
    s_count = q.shape[0]
    sizes = [-(-s_count // (1 << k)) for k in range(plan.n_levels)]
    flat = q.new_empty((sum(sizes),) + tuple(q.shape[1:]))
    torch.index_select(q, 0, plan.perm, out=flat[:s_count])
    a = 0
    for n, m in zip(sizes, sizes[1:]):  # level k at flat[a:a+n], k+1 after it
        b, pairs = a + n, n // 2
        torch.add(flat[a : a + 2 * pairs : 2], flat[a + 1 : a + 2 * pairs : 2],
                  out=flat[b : b + pairs])
        if n % 2:  # an unpaired last block carries over as it is
            flat[b + pairs] = flat[a + n - 1]
        a = b
    acc = flat.index_select(0, plan.blocks[0])
    for blk in plan.blocks[1:]:
        acc[: blk.shape[0]] += flat.index_select(0, blk)
    return acc.index_select(0, plan.where)


def routed_discharge(dense: torch.Tensor, params: dict, topo: Topology) -> torch.Tensor:
    """Routed hydrograph [S, Q]: downstream-accumulated link outflow at each
    query time, on the dense tensor's device (NaN states — unfinished
    systems — contribute zero).  ``params`` holds the Model-204 fields as
    [S] tensors on that device."""
    col = {k: v[:, None] for k, v in params.items()}
    q = link_runoff_204(torch.nan_to_num(dense), col)  # [S, Q]
    return accumulate_downstream_log(q, topo)

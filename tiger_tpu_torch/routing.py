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


def _range_plan(lo: np.ndarray, hi: np.ndarray, n_flat: int) -> tuple:
    """(blocks, where, n_levels): the sum of each range [lo[k], hi[k]) of a
    flat array of ``n_flat`` values as aligned power-of-two blocks, left to
    right (every range non-empty).

    Level k of the block sums holds ceil(n_flat / 2^k) blocks, each the
    pairwise sum of two blocks of level k - 1; a block's flat id is its
    level's offset plus its index.  Each pass takes, for every range not yet
    covered, the largest aligned block that starts at its left end and fits
    in it.  ``blocks[j]`` holds pass j's block ids for the first
    ``len(blocks[j])`` rows of the accumulator, which holds the ranges with
    the most blocks first; ``where[k]`` is range k's accumulator row."""
    n_levels = int(_floor_log2(np.array([max(n_flat, 1)]))[0]) + 1
    sizes = [-(-n_flat // (1 << k)) for k in range(n_levels)]
    level_off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    n_ranges = len(lo)
    rows, lo, hi = np.arange(n_ranges), np.asarray(lo, np.int64).copy(), np.asarray(hi, np.int64)
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
    counts = np.zeros(n_ranges, np.int64)
    for rows_j, _ in passes:
        counts[rows_j] += 1
    order = np.argsort(-counts, kind="stable")
    where = np.empty(n_ranges, np.int64)
    where[order] = np.arange(n_ranges)
    blocks = []
    for rows_j, flat_j in passes:  # pass j's ranges: the first len(rows_j) of order
        blk = np.empty(len(rows_j), np.int64)
        blk[where[rows_j]] = flat_j
        blocks.append(blk)
    return tuple(blocks), where, used + 1


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

    blocks, where, n_levels = _range_plan(pos, pos + size, s_count)
    return SumPlan(perm=perm, blocks=blocks, where=where, n_levels=n_levels)


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
    return _range_sums(q, plan.perm, plan.blocks, plan.where, plan.n_levels)


def _range_sums(src: torch.Tensor, perm: torch.Tensor, blocks: tuple, where: torch.Tensor,
                n_levels: int) -> torch.Tensor:
    """The sums of ``_range_plan``'s ranges over the flat array src[perm]
    ([K, ...], range by range).  Level k + 1 of the block sums is level k's
    pairs added; pass j then adds each range's j-th block from the left, so
    every sum is ((b0 + b1) + b2) + ... of pairwise block sums: gathers and
    elementwise adds only, the same bits on every device and in every run."""
    n_flat = perm.shape[0]
    sizes = [-(-n_flat // (1 << k)) for k in range(n_levels)]
    flat = src.new_empty((sum(sizes),) + tuple(src.shape[1:]))
    torch.index_select(src, 0, perm, out=flat[:n_flat])
    a = 0
    for n, m in zip(sizes, sizes[1:]):  # level k at flat[a:a+n], k+1 after it
        b, pairs = a + n, n // 2
        torch.add(flat[a : a + 2 * pairs : 2], flat[a + 1 : a + 2 * pairs : 2],
                  out=flat[b : b + pairs])
        if n % 2:  # an unpaired last block carries over as it is
            flat[b + pairs] = flat[a + n - 1]
        a = b
    acc = flat.index_select(0, blocks[0])
    for blk in blocks[1:]:
        acc[: blk.shape[0]] += flat.index_select(0, blk)
    return acc.index_select(0, where)


def routed_discharge(dense: torch.Tensor, params: dict, topo: Topology) -> torch.Tensor:
    """Routed hydrograph [S, Q]: downstream-accumulated link outflow at each
    query time, on the dense tensor's device (NaN states — unfinished
    systems — contribute zero).  ``params`` holds the Model-204 fields as
    [S] tensors on that device."""
    col = {k: v[:, None] for k, v in params.items()}
    q = link_runoff_204(torch.nan_to_num(dense), col)  # [S, Q]
    return accumulate_downstream_log(q, topo)


# ---------------------------------------------------------------------------
# The sharded exchange: each process holds a contiguous block of the links
# ---------------------------------------------------------------------------


class ShardedTopology(NamedTuple):
    """Per-shard static routing plan (host-precomputed, stacked over shards):
    ``tiger_tpu/routing.py::ShardedTopology``, array for array.

    One plan slice per pointer-doubling round (leading R axis): round j's
    edges are u -> 2^j-th-successor(u).  Local edges add within the shard;
    remote edges are packed into a fixed-width outbox (padded with -1
    targets) and delivered around a ring of the shards.
    """

    local_tgt: np.ndarray  # [R, D, B] int32: in-shard target row or -1
    outbox_src: np.ndarray  # [R, D, M] int32: local row feeding outbox slot, -1 pad
    outbox_shard: np.ndarray  # [R, D, M] int32: destination shard, -1 pad
    outbox_row: np.ndarray  # [R, D, M] int32: destination row within shard, -1 pad
    n_shards: int
    block: int
    depth: int
    n_rounds: int
    # Shard row ranges in global row coordinates (starts[d] .. starts[d] +
    # sizes[d]); uniform ``block`` partition unless ``bounds`` was given.
    starts: tuple = ()
    sizes: tuple = ()
    # Per-round outbox width (max over shards): round j circulates its own
    # m_j slots, not the widest round's.
    round_slots: tuple = ()


def plan_sharded_topology(topo: Topology, n_shards: int, bounds=None) -> ShardedTopology:
    """Split a Topology over ``n_shards`` contiguous row blocks (host).

    ``bounds``: optional explicit per-shard row ranges (a sequence of
    slices, e.g. ``params.split_even``, the multi-process partition).
    Default: uniform ceil(S/D) blocks.  Each shard's rows are addressed
    locally as ``global_row - starts[d]``.  The port of the JAX package's
    function: its arrays are equal.
    """
    s_total = len(topo.next_idx)
    n_rounds = topo.ptr_tables.shape[0]
    rows = np.arange(s_total)
    if bounds is None:
        block = -(-s_total // max(n_shards, 1))  # ceil
        starts = np.arange(n_shards) * block
        sizes = np.clip(s_total - starts, 0, block)
        src_shard = rows // max(block, 1)
    else:
        if len(bounds) != n_shards:
            raise ValueError(f"bounds has {len(bounds)} slices, want {n_shards}")
        starts = np.array([b.start for b in bounds])
        sizes = np.array([b.stop - b.start for b in bounds])
        if starts[0] != 0 or (starts[1:] != (starts + sizes)[:-1]).any() or (
            starts + sizes
        )[-1] != s_total:
            raise ValueError("bounds must be contiguous and cover all rows")
        block = int(sizes.max()) if n_shards else 0
        src_shard = np.searchsorted(starts, rows, side="right") - 1

    def to_shard(grows):
        d = np.searchsorted(starts, grows, side="right") - 1 if bounds is not None \
            else grows // max(block, 1)
        return d, grows - starts[d]

    local_tgt = np.full((max(n_rounds, 1), n_shards, max(block, 1)), -1, np.int32)
    out_src, out_shard, out_row = [], [], []
    for j in range(n_rounds):
        edges = topo.ptr_tables[j]
        safe = np.clip(edges, 0, None)
        e_shard, e_row = to_shard(safe)
        tgt_shard = np.where(edges >= 0, e_shard, -1)
        tgt_row = np.where(edges >= 0, e_row, -1)
        src_row = rows - starts[src_shard]
        for d in range(n_shards):
            mine = src_shard == d
            local = mine & (tgt_shard == d)
            local_tgt[j, d, src_row[local]] = tgt_row[local]
            remote = mine & (tgt_shard >= 0) & (tgt_shard != d)
            out_src.append(src_row[remote])
            out_shard.append(tgt_shard[remote])
            out_row.append(tgt_row[remote])
    m = max(1, max((len(x) for x in out_src), default=1))

    def pad(xs):
        return np.stack(
            [np.pad(x, (0, m - len(x)), constant_values=-1).astype(np.int32) for x in xs]
        ).reshape(n_rounds, n_shards, m)

    if n_rounds == 0:
        empty = np.full((1, n_shards, 1), -1, np.int32)
        out_arrs = (empty, empty, empty)
        round_slots = ()
    else:
        out_arrs = (pad(out_src), pad(out_shard), pad(out_row))
        round_slots = tuple(
            max(1, max(len(out_src[j * n_shards + d]) for d in range(n_shards)))
            for j in range(n_rounds)
        )
    return ShardedTopology(
        local_tgt=local_tgt,
        outbox_src=out_arrs[0],
        outbox_shard=out_arrs[1],
        outbox_row=out_arrs[2],
        n_shards=n_shards,
        block=block,
        depth=topo.depth,
        n_rounds=n_rounds,
        starts=tuple(int(x) for x in starts),
        sizes=tuple(int(x) for x in sizes),
        round_slots=round_slots,
    )


class _RangeAdd(NamedTuple):
    """acc[targets] += the sums, in a fixed order, of ``src[perm]``'s
    ranges, one range a target (``_range_plan``)."""

    perm: torch.Tensor
    targets: torch.Tensor
    blocks: tuple
    where: torch.Tensor
    n_levels: int


def _range_add(src_rows: np.ndarray, targets: np.ndarray, device) -> _RangeAdd | None:
    """The plan that adds ``src[src_rows[i]]`` into ``acc[targets[i]]`` for
    every i: each target's sources in ascending order of ``src_rows``
    (their global rows), summed as ``_range_sums`` sums; None when there is
    nothing to add."""
    if len(src_rows) == 0:
        return None
    order = np.lexsort((src_rows, targets))
    src_rows, targets = src_rows[order], targets[order]
    uniq, first, counts = np.unique(targets, return_index=True, return_counts=True)
    blocks, where, n_levels = _range_plan(first, first + counts, len(src_rows))

    def up(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return _RangeAdd(up(src_rows), up(uniq), tuple(up(b) for b in blocks), up(where), n_levels)


def _apply(acc: torch.Tensor, src: torch.Tensor, add: _RangeAdd | None) -> torch.Tensor:
    if add is None:
        return acc
    sums = _range_sums(src, add.perm, add.blocks, add.where, add.n_levels)
    return acc.index_copy(0, add.targets, acc.index_select(0, add.targets) + sums)


class _RingTables(NamedTuple):
    """One shard's device tables of every round (``_ring_tables``)."""

    local: tuple  # per round: the in-shard _RangeAdd
    outbox: tuple  # per round: the local rows of this shard's slots (then zero pad)
    slots: tuple  # per round: m_j, the width of every shard's outbox
    deliver: tuple  # per round: per hop h = 1..D-1, the _RangeAdd of hop h's slots


def _ring_tables(plan: ShardedTopology, me: int, device) -> _RingTables:
    """Shard ``me``'s tables, built from the plan on the host and uploaded
    once.  Hop h delivers the outbox of shard (me - h) mod D; its slots
    addressed to ``me`` are added to their rows, each row's slots in slot
    order (the sender's ascending global rows)."""
    n, size = plan.n_shards, plan.sizes[me]
    local, outbox, deliver = [], [], []
    for j in range(plan.n_rounds):
        tgt = plan.local_tgt[j, me, :size].astype(np.int64)
        src = np.flatnonzero(tgt >= 0)
        local.append(_range_add(src, tgt[src], device))
        m_j = plan.round_slots[j]
        src = plan.outbox_src[j, me, :m_j]
        outbox.append(torch.as_tensor(src[src >= 0].astype(np.int64), device=device))
        hops = []
        for h in range(1, n):
            d = (me - h) % n
            slots = np.flatnonzero(plan.outbox_shard[j, d, :m_j] == me)
            hops.append(_range_add(slots, plan.outbox_row[j, d, slots].astype(np.int64), device))
        deliver.append(tuple(hops))
    return _RingTables(tuple(local), tuple(outbox), plan.round_slots, tuple(deliver))


#: One-slot device cache of a shard's ring tables: a run routes window after
#: window over one plan and uploads it once.  It holds the host plan itself
#: and compares with ``is``.
_ring_cache: tuple = (None, None, None, None)


def _device_ring(plan: ShardedTopology, me: int, device) -> _RingTables:
    global _ring_cache
    host, rank, dev, tables = _ring_cache
    if host is not plan.local_tgt or rank != me or dev != device:
        tables = _ring_tables(plan, me, device)
        _ring_cache = (plan.local_tgt, me, device, tables)
    return tables


def exchange_sharded(q_local: torch.Tensor, plan: ShardedTopology, group=None) -> torch.Tensor:
    """This process's rows of the downstream accumulation over the whole
    basin: ``q_local`` [S_local] or [S_local, W] (the rows ``plan.starts[me]``
    .. + ``plan.sizes[me]`` of rank ``me`` of ``group``; a trailing payload
    axis W, e.g. a window's query times, routes alike), every rank of
    ``group`` calling it with its own rows.

    Each pointer-doubling round adds, within the shard, the current partial
    sums through the round's edges (x <- x + S_j x), then sends the round's
    outbox (``round_slots[j]`` slots of the pre-round sums) n - 1 hops
    around the ring, rank -> rank + 1, with ``torch.distributed``; at each
    hop the slots addressed to this rank are added to their rows.  Every
    sum is a fixed-order sum of gathers (``_range_add``) and deliveries
    are added in ring-arrival order: no ``index_add``, no atomics, so a run
    equals itself bit for bit.  The plan's tables reach the device once per
    plan (``_device_ring``).  The ring carries values only: every rank
    holds the plan, so a slot's address need not travel.  Under ``gloo``
    the outbox of a card's tensor goes through pinned host buffers (gloo's
    transfers read host memory); under ``nccl`` it stays on the card.
    """
    import torch.distributed as dist

    me = dist.get_rank(group) if dist.is_initialized() else 0
    if plan.n_shards != (dist.get_world_size(group) if dist.is_initialized() else 1):
        raise ValueError(f"the plan has {plan.n_shards} shards, the group "
                         f"{dist.get_world_size(group) if dist.is_initialized() else 1} ranks")
    if q_local.shape[0] != plan.sizes[me]:
        raise ValueError(f"rank {me} holds {plan.sizes[me]} rows, q_local {q_local.shape[0]}")
    vec = q_local.ndim == 1
    acc = q_local[:, None] if vec else q_local
    tables = _device_ring(plan, me, acc.device)
    n = plan.n_shards
    staged = n > 1 and acc.is_cuda and dist.get_backend(group) == "gloo"
    nxt, prv = (me + 1) % n, (me - 1) % n
    if n > 1 and group is not None:
        nxt, prv = (dist.get_global_rank(group, r) for r in (nxt, prv))
    for j in range(plan.n_rounds):
        new = _apply(acc, acc, tables.local[j])
        if n > 1:
            rows = tables.outbox[j]
            box = acc.new_zeros((tables.slots[j],) + tuple(acc.shape[1:]))
            box[: rows.shape[0]] = acc.index_select(0, rows)
            if staged:
                box = box.cpu().pin_memory()
            for h in range(1, n):
                got = torch.empty(box.shape, dtype=box.dtype, device=box.device,
                                  pin_memory=staged)
                for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, box, nxt, group),
                                                    dist.P2POp(dist.irecv, got, prv, group)]):
                    work.wait()
                box = got
                if tables.deliver[j][h - 1] is not None:
                    arrived = got.to(acc.device, non_blocking=True) if staged else got
                    new = _apply(new, arrived, tables.deliver[j][h - 1])
        acc = new
    return acc[:, 0] if vec else acc


def accumulate_downstream_sharded(q_local: torch.Tensor, plan: ShardedTopology,
                                  group=None) -> torch.Tensor:
    """The single-vector exchange: ``q_local`` [S_local] is this rank's
    rows (the JAX function takes the global padded vector on a mesh)."""
    return exchange_sharded(q_local.reshape(-1), plan, group)


def _sum_depth(blocks: tuple, n_levels: int) -> int:
    """The most roundings a term passes through in a ``_range_sums`` sum:
    the pairwise adds of its block's level and one add for each later
    pass."""
    return (n_levels - 1) + max(len(blocks) - 1, 0)


def ring_error_bound(topo: Topology, plan: ShardedTopology, eps: float) -> float:
    """A bound on |exchange_sharded - accumulate_downstream_log| relative to
    the sum, for non-negative runoff in a type of unit roundoff ``eps``
    (2^-24 in float32): each term's computed sum is off the exact one by at
    most (its roundings) x eps x the sum, and the bound adds the most
    roundings of both orders.  ``accumulate_downstream_log``: one range sum
    (``_sum_depth``).  The ring, in each round: the round's deepest range
    sum, in-shard or of a hop's slots, then the add into the target and an
    add for each later hop (D)."""
    ring = 0
    for j in range(plan.n_rounds):
        deepest = 0
        for d in range(plan.n_shards):
            size = plan.sizes[d]
            tgt = plan.local_tgt[j, d, :size].astype(np.int64)
            pairs = [(np.flatnonzero(tgt >= 0), tgt[tgt >= 0])]
            m_j = plan.round_slots[j]
            for h in range(1, plan.n_shards):
                s = (d - h) % plan.n_shards
                slots = np.flatnonzero(plan.outbox_shard[j, s, :m_j] == d)
                pairs.append((slots, plan.outbox_row[j, s, slots].astype(np.int64)))
            for src, targets in pairs:
                if len(src):
                    _, first, counts = np.unique(targets, return_index=True, return_counts=True)
                    blocks, _, n_levels = _range_plan(first, first + counts, len(src))
                    deepest = max(deepest, _sum_depth(blocks, n_levels))
        ring += deepest + plan.n_shards
    log = _sum_depth(topo.plan.blocks, topo.plan.n_levels)
    return 1.01 * (ring + log) * eps


def ring_bytes_per_exchange(plan: ShardedTopology, w: int, itemsize: int = 4) -> int:
    """Bytes a ring exchange sends over the interconnect (all hops, all
    rounds, all ranks): round j's m_j-slot outbox of [m_j, W] values makes
    D - 1 hops from every rank.  The JAX ring also sends each slot's packed
    4-byte address; this one sends values only."""
    return sum(plan.n_shards * (plan.n_shards - 1) * m_j * w * itemsize
               for m_j in plan.round_slots)


def allgather_bytes_per_exchange(s_total: int, w: int, n_eq: int, n_shards: int,
                                 itemsize: int = 4) -> int:
    """Bytes the allgather oracle delivers per exchange: every shard
    receives the full [S_total, W, n_eq] block (the port's run gathers the
    link runoff, n_eq = 1)."""
    return n_shards * s_total * w * n_eq * itemsize

"""tiger_tpu_torch.routing against tiger_tpu.routing, on the CPU in float64.

Topologies are numpy on both sides and must be equal.  The accumulations
add the same float64 values in each package's own order (the JAX package's
scatter-adds, the port's fixed block order), so they are held to 1e-12
relative (a sum of at most 1,000 non-negative terms reordered moves by at
most ~1,000 ulp of the sum; the runs here move by far less).  The port's
order itself is held bit for bit to a plain recursive statement of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiger_tpu import routing as jrouting
from tiger_tpu_torch import routing
from tiger_tpu_torch.scenario import scenario_arrays

RTOL = 1e-12


def _random_forest(rng, n):
    """Random forest whose next-in-row-order link lies downstream; the ids
    are random and unsorted, so the id -> row resolution is exercised."""
    next_row = np.full(n, -1, np.int64)
    for i in range(n - 1):
        if rng.uniform() < 0.85:
            next_row[i] = rng.integers(i + 1, n)
    ids = rng.choice(1_000_000, size=n, replace=False) + 1
    nxt = np.where(next_row >= 0, ids[np.clip(next_row, 0, None)], -999)
    return ids, nxt


def _chain(n):
    ids = np.arange(1, n + 1)
    return ids, np.concatenate([ids[1:], [-1]])


def _binary_tree(n):
    rows = np.arange(n)
    return rows + 1, np.where(rows > 0, (rows - 1) // 2 + 1, -1)


NETWORKS = {
    "forest_300": lambda: _random_forest(np.random.default_rng(17), 300),
    "forest_64": lambda: _random_forest(np.random.default_rng(5), 64),
    "chain_1000": lambda: _chain(1000),
    "binary_tree_511": lambda: _binary_tree(511),
    "single_link": lambda: (np.array([7]), np.array([-1])),
}


@pytest.mark.parametrize("net", sorted(NETWORKS))
def test_build_topology_equal(net):
    ids, nxt = NETWORKS[net]()
    ours, ref = routing.build_topology(ids, nxt), jrouting.build_topology(ids, nxt)
    assert ours.depth == ref.depth
    for a, b in ((ours.next_idx, ref.next_idx), (ours.ptr_tables, ref.ptr_tables)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_cycle_detection():
    ids = np.array([1, 2, 3])
    nxt = np.array([2, 3, 1])
    with pytest.raises(ValueError, match="cycle"):
        routing.build_topology(ids, nxt)


@pytest.mark.parametrize("net", sorted(NETWORKS))
def test_accumulate_log_matches_jax_and_brute_force(net):
    ids, nxt = NETWORKS[net]()
    topo = routing.build_topology(ids, nxt)
    q = np.random.default_rng(3).uniform(0, 1, len(ids))
    ours = routing.accumulate_downstream_log(torch.from_numpy(q), topo).numpy()
    ref = np.asarray(
        jrouting.accumulate_downstream_log(jnp.asarray(q), jnp.asarray(topo.ptr_tables))
    )
    brute = routing.accumulate_downstream(
        torch.from_numpy(q), torch.as_tensor(topo.next_idx), topo.depth
    ).numpy()
    assert ours.dtype == np.float64
    np.testing.assert_allclose(ours, ref, rtol=RTOL)
    np.testing.assert_allclose(ours, brute, rtol=RTOL)
    if net == "chain_1000":  # each link carries every link above it
        np.testing.assert_allclose(ours[np.argsort(ids)], np.cumsum(q[np.argsort(ids)]), rtol=RTOL)


def test_accumulate_log_takes_columns():
    """A [S, Q] block accumulates each column as a [S] vector alone."""
    ids, nxt = _random_forest(np.random.default_rng(2), 100)
    topo = routing.build_topology(ids, nxt)
    q = np.random.default_rng(4).uniform(0, 1, (100, 7))
    block = routing.accumulate_downstream_log(torch.from_numpy(q), topo).numpy()
    for j in range(7):
        col = routing.accumulate_downstream_log(torch.from_numpy(q[:, j].copy()), topo)
        np.testing.assert_array_equal(block[:, j], col.numpy())


def test_routed_discharge_matches_jax():
    """routed_discharge on a dense block with negative and NaN states."""
    s, n_q = 96, 9
    rng = np.random.default_rng(8)
    p, _, _ = scenario_arrays(s)
    ids, nxt = _random_forest(rng, s)
    topo = routing.build_topology(ids, nxt)
    dense = rng.uniform(-0.01, 1.0, (s, n_q, 5))
    dense[3, 2, :] = np.nan  # an unfinished system contributes zero
    dense[5, :, 2] = -1e-4  # overshoot below an empty store
    ours = routing.routed_discharge(
        torch.from_numpy(dense), {k: torch.from_numpy(v) for k, v in p.items()}, topo
    ).numpy()
    ref = np.asarray(
        jrouting.routed_discharge(
            jnp.asarray(dense), {k: jnp.asarray(v) for k, v in p.items()}, topo
        )
    )
    assert ours.shape == (s, n_q) and np.isfinite(ours).all() and (ours >= 0).all()
    np.testing.assert_allclose(ours, ref, rtol=RTOL)


def test_link_outflow_matches_jax():
    from tiger_tpu.models.model204 import link_outflow as j_link_outflow
    from tiger_tpu_torch.models.model204 import link_outflow

    s = 128
    rng = np.random.default_rng(9)
    p, _, _ = scenario_arrays(s)
    y = rng.uniform(-0.05, 2.0, (s, 5))
    ours = link_outflow(torch.from_numpy(y), {k: torch.from_numpy(v) for k, v in p.items()})
    ref = j_link_outflow(jnp.asarray(y), {k: jnp.asarray(v) for k, v in p.items()})
    # The same float64 formulas in the same order; exp2/log2 of two libms.
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-13)


def test_device_tables_cache_one_slot():
    ids, nxt = _chain(10)
    a, b = routing.build_topology(ids, nxt), routing.build_topology(ids, nxt)
    ta = routing._device_plan(a, torch.device("cpu"))
    assert routing._device_plan(a, torch.device("cpu")) is ta
    tb = routing._device_plan(b, torch.device("cpu"))
    assert tb is not ta and torch.equal(tb.perm, ta.perm)
    assert all(torch.equal(x, y) for x, y in zip(tb.blocks, ta.blocks))


def _fan_in(rng, n, n_targets):
    """A few targets (a small tree among themselves), each fed by many
    sources, the rows shuffled."""
    next_row = np.full(n, -1, np.int64)
    next_row[1:n_targets] = rng.integers(0, np.arange(1, n_targets))
    next_row[n_targets:] = rng.integers(0, n_targets, n - n_targets)
    shuffle = rng.permutation(n)
    inv = np.argsort(shuffle)
    rows = np.where(next_row[shuffle] >= 0, inv[np.clip(next_row[shuffle], 0, None)], -1)
    return np.arange(1, n + 1), np.where(rows >= 0, rows + 1, -1)


def _reference_sums(q, next_idx):
    """The documented order, stated plainly: a recursive depth-first
    preorder (children in row order), each subtree's range cut greedily
    into aligned power-of-two blocks, each block the sum of its halves, the
    blocks added left to right, every sum rounded to q's dtype."""
    n = len(next_idx)
    children = [[] for _ in range(n)]
    for u in range(n):
        if next_idx[u] >= 0:
            children[next_idx[u]].append(u)
    order, size = [], np.zeros(n, np.int64)

    def visit(v):
        order.append(v)
        size[v] = 1 + sum(visit(c) for c in children[v])
        return size[v]

    for r in range(n):
        if next_idx[r] < 0:
            visit(r)
    x = q[order]
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)

    def block(k, i):
        if k == 0:
            return x[i]
        return block(k - 1, 2 * i) + block(k - 1, 2 * i + 1)

    out = np.empty_like(q)
    for v in range(n):
        lo, hi, acc = pos[v], pos[v] + size[v], None
        while lo < hi:
            k = 0
            while lo % (2 << k) == 0 and lo + (2 << k) <= hi:
                k += 1
            b = block(k, lo >> k)
            acc = b if acc is None else acc + b
            lo += 1 << k
        out[v] = acc
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accumulate_sums_in_a_fixed_order(seed):
    """Several sources per target, float32 values over eight decades, where
    the order of summation shows in the bits: the result equals the plain
    statement of the documented order bit for bit, in every call, and
    differs from a row-order sum somewhere (so the check can tell)."""
    rng = np.random.default_rng(seed)
    ids, nxt = _fan_in(rng, 200, 5)
    topo = routing.build_topology(ids, nxt)
    q = (10.0 ** rng.uniform(-8, 0, 200)).astype(np.float32)
    want = _reference_sums(q, topo.next_idx)
    got = [routing.accumulate_downstream_log(torch.from_numpy(q), topo).numpy() for _ in range(2)]
    assert got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], want)
    row_order = routing.accumulate_downstream(
        torch.from_numpy(q), torch.as_tensor(topo.next_idx), topo.depth
    ).numpy()
    assert (row_order != want).any()
    np.testing.assert_allclose(want, row_order, rtol=1e-5)

"""Several processes through the port, on the CPU, against one process and
the JAX package.

- ``params.split_even`` and ``dist.shard_rows_for_process`` against the JAX
  package's;
- ``solve(devices=["cpu", "cpu"])`` on an odd number of systems with stiff
  lanes: bit for bit the one-device solve, and held against the JAX
  ``solve(mesh=...)`` over 8 virtual CPU devices at test_torch_solve.py's
  tolerances;
- ``routing.plan_sharded_topology``: the JAX package's arrays exactly;
- ``routing.exchange_sharded`` over 2 and 3 gloo processes in float64,
  against the JAX ``exchange_sharded`` on as many virtual devices at rtol
  1e-12, on tests/test_routing.py's topologies (random, a deep chain that
  crosses every shard, a payload axis over split_even bounds); a second
  exchange equals the first bit for bit;
- the CLI with two gloo processes over tests/test_cli.py::make_scenario's
  basin, whole and in 1-day windows: the rank files, concatenated, equal
  the port's one-process run bit for bit (final, dense, state); the
  allgather discharge equals it bit for bit, the ring's within 1e-12; a
  per-rank resume from the day-1 checkpoints equals the uninterrupted run
  bit for bit; and the files match the JAX one-process run at
  test_torch_cli.py's TOL;
- nccl with two ranks on one card is refused before the group forms.

Ranks are separate Python processes (``tests/_torch_dist_worker.py`` or the
CLI module) that meet at a free localhost port.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cli import make_scenario
from test_routing import _brute_accumulate, _random_forest
from test_torch_cli import _assert_close
from tiger_tpu import routing as j_routing
from tiger_tpu.config import load_config as j_load_config
from tiger_tpu.params import split_even as j_split_even
from tiger_tpu.run import run as j_run
from tiger_tpu_torch import routing
from tiger_tpu_torch.config import load_config
from tiger_tpu_torch.io.netcdf import read_netcdf
from tiger_tpu_torch.params import split_even
from tiger_tpu_torch.run import run

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
RANKS = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(argvs, tmp_path, timeout=120):
    """Start one process for each argv, wait for all; any failure kills
    the rest and fails the test with its output."""
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": str(tmp_path),
           "PYTHONPATH": os.path.dirname(HERE),
           "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env) for argv in argvs]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [(proc.returncode, out) for proc, out in zip(procs, outs)]


def _ok(results):
    for rc, out in results:
        assert rc == 0, out[-3000:]
    return results


# --- rows ---------------------------------------------------------------


@pytest.mark.parametrize("n_rows,n_shards", [(0, 1), (5, 1), (10, 3), (67, 4), (3, 8), (131_072, 7)])
def test_split_even_matches_jax(n_rows, n_shards):
    assert split_even(n_rows, n_shards) == j_split_even(n_rows, n_shards)


def test_shard_rows_for_process_matches_jax():
    """Without a process group this process is rank 0 of 1, as in JAX."""
    from tiger_tpu.dist import shard_rows_for_process as j_rows
    from tiger_tpu_torch.dist import process_count, process_index, shard_rows_for_process

    assert (process_index(), process_count()) == (jax.process_index(), jax.process_count())
    for n in (0, 1, 67):
        assert shard_rows_for_process(n) == j_rows(n)


# --- solve() over devices -------------------------------------------------


def test_solve_on_devices_bitwise_and_against_jax_mesh():
    """63 systems with stiff rows 0 and 62 over 3 hours in float64 (the
    port's default precision) at the reference's rtol 1e-6 / atol 1e-9.
    In float32 the JAX mesh path is the XLA vmap RK45, not the Pallas
    kernel test_torch_solve.py holds the port to, and float32 step
    sequences part (ROADMAP "float32 against XLA")."""
    from __graft_entry__ import _scenario
    from tiger_tpu.dist import systems_mesh
    from tiger_tpu.models import Model204 as JModel204
    from tiger_tpu.solver.api import solve as j_solve
    from tiger_tpu.solver.config import SolverConfig as JSolverConfig
    from tiger_tpu_torch import Model204, SolverConfig, solve
    from tiger_tpu_torch.scenario import scenario

    s_count, days, cfg = 63, 0.125, dict(rtol=1e-6, atol=1e-9, max_steps=100_000)
    tf = days * 1440.0
    y0, p, f = scenario(s_count, days, 2 / s_count, device="cpu", dtype=torch.float64)
    qt = torch.arange(0.0, tf + 1e-9, 60.0, dtype=torch.float64)
    one = solve(Model204(), y0, 0.0, tf, qt, p, f, SolverConfig(**cfg))
    two = solve(Model204(), y0, 0.0, tf, qt, p, f, SolverConfig(**cfg), devices=["cpu", "cpu"])
    stiff = [0, s_count - 1]
    assert one.n_stiff == two.n_stiff == 2
    assert np.nonzero(two.stiff.numpy())[0].tolist() == stiff
    for name in ("y_final", "dense", "stiff", "failed"):
        assert torch.equal(getattr(two, name), getattr(one, name)), name
    for a, b in zip((*two.rk_stats, *two.radau_stats), (*one.rk_stats, *one.radau_stats)):
        assert torch.equal(a, b)

    jy0, jp, jf = _scenario(s_count, jnp.float64, days=days, stiff_frac=2 / s_count)
    assert np.array_equal(np.asarray(jy0), y0.numpy())
    ref = j_solve(JModel204(), jy0, 0.0, tf, jnp.asarray(qt.numpy()), jp, jf,
                  config=JSolverConfig(**cfg), mesh=systems_mesh(jax.devices()[:8]))
    np.testing.assert_array_equal(np.asarray(ref.stiff), two.stiff.numpy())
    rk = np.setdiff1d(np.arange(s_count), stiff)
    y, d, ry, rd = two.y_final.numpy(), two.dense.numpy(), np.asarray(ref.y_final), np.asarray(ref.dense)
    np.testing.assert_allclose(y[rk], ry[rk], rtol=5e-4, atol=1e-7)
    np.testing.assert_allclose(d[rk], rd[rk], rtol=5e-4, atol=1e-7)
    np.testing.assert_allclose(y[stiff], ry[stiff], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(d[stiff], rd[stiff], rtol=1e-4, atol=1e-7)


# --- the sharded exchange -------------------------------------------------


def _topologies():
    """tests/test_routing.py's: (name, stream, next_stream, q, bounds)."""
    rng = np.random.default_rng(5)
    stream, nxt = _random_forest(rng, 16 * 8 - 3)
    yield "random", stream, nxt, rng.uniform(0, 1, (len(stream), 3)), "uniform"
    ids = np.arange(1, 16 * 8 + 1)
    yield ("deep_chain", ids, np.concatenate([ids[1:], [-1]]),
           np.random.default_rng(3).uniform(0, 1, (len(ids), 1)), "uniform")
    rng = np.random.default_rng(11)
    stream, nxt = _random_forest(rng, 16 * 4 + 3)
    yield "payload_split_even", stream, nxt, rng.uniform(0, 1, (len(stream), 5)), "even"


TOPOLOGIES = {name: rest for name, *rest in _topologies()}
#: The chip_smoke basin's river network (write_basin: link i drains into
#: (i - 1) // 2) at its 131,072 links, with float32 runoff: the ring's
#: rounding against routing.ring_error_bound.
_ROWS = np.arange(131_072)
BIG = (_ROWS + 1, np.where(_ROWS > 0, (_ROWS - 1) // 2 + 1, -1),
       np.random.default_rng(7).uniform(0, 1, (len(_ROWS), 2)).astype(np.float32), "even")


@pytest.mark.parametrize("n_shards", [2, 3, 8])
@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_plan_sharded_topology_matches_jax(name, n_shards):
    stream, nxt, _, bounds = TOPOLOGIES[name]
    topo, j_topo = routing.build_topology(stream, nxt), j_routing.build_topology(stream, nxt)
    assert np.array_equal(topo.ptr_tables, j_topo.ptr_tables)
    b = split_even(len(stream), n_shards) if bounds == "even" else None
    ours = routing.plan_sharded_topology(topo, n_shards, b)
    ref = j_routing.plan_sharded_topology(j_topo, n_shards, b)
    assert ours._fields == ref._fields
    for field, a, r in zip(ours._fields, ours, ref):
        if isinstance(a, np.ndarray):
            assert a.dtype == r.dtype and np.array_equal(a, r), field
        else:
            assert a == r, field


@pytest.fixture(scope="module", params=[2, 3], ids=["2 processes", "3 processes"])
def exchanged(request, tmp_path_factory):
    """Every topology's exchange over ``param`` gloo processes: (world,
    each rank's worker output)."""
    world, tmp = request.param, tmp_path_factory.mktemp("exchange")
    job = [dict(stream=s, next_stream=n, q=q, bounds=b) for s, n, q, b in (*TOPOLOGIES.values(), BIG)]
    torch.save(job, tmp / "job.pt")
    coord = f"127.0.0.1:{_free_port()}"
    _ok(_launch([[WORKER, "exchange", coord, str(world), str(r), str(tmp / "job.pt"),
                  str(tmp / f"out{r}.pt")] for r in range(world)], tmp))
    return world, [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(world)]


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_exchange_sharded_matches_jax(exchanged, name):
    """The ranks' rows, concatenated, against the JAX ring on as many
    virtual devices (rtol 1e-12) and the brute-force sums; the second
    exchange equals the first bit for bit, and the single-vector exchange
    of the first column equals its column; each rank's rows are the JAX
    split's."""
    from tiger_tpu.dist import systems_mesh

    world, outs = exchanged
    k = list(TOPOLOGIES).index(name)
    stream, nxt, q, bounds = TOPOLOGIES[name]
    n = len(stream)
    b = j_split_even(n, world) if bounds == "even" else None
    for r, out in enumerate(outs):
        if bounds == "even":
            assert out["rows"][k] == j_split_even(n, world)[r]
        first, second = out["runs"][k]
        assert np.array_equal(first, second)
        assert np.array_equal(out["vector"][k], first[:, 0])
    ours = np.concatenate([out["runs"][k][0] for out in outs])

    j_topo = j_routing.build_topology(stream, nxt)
    plan = j_routing.plan_sharded_topology(j_topo, world, b)
    q_g = np.zeros((world, plan.block, q.shape[1]))
    for d in range(world):
        q_g[d, : plan.sizes[d]] = q[plan.starts[d] : plan.starts[d] + plan.sizes[d]]
    out = np.asarray(j_routing.exchange_sharded(jnp.asarray(q_g), plan,
                                                systems_mesh(jax.devices()[:world])))
    ref = np.concatenate([out[d, : plan.sizes[d]] for d in range(world)])
    assert ours.shape == ref.shape == q.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0)
    topo = routing.build_topology(stream, nxt)
    for col in range(q.shape[1]):
        np.testing.assert_allclose(ours[:, col], _brute_accumulate(q[:, col], topo.next_idx),
                                   rtol=1e-12)


def test_ring_float32_within_its_bound(exchanged):
    """At 131,072 links in float32 the ring's discharge lies within
    ring_error_bound of the one-device sums (accumulate_downstream_log),
    and the bound is below 1e-5."""
    world, outs = exchanged
    stream, nxt, q, _ = BIG
    k = len(TOPOLOGIES)
    ours = np.concatenate([out["runs"][k][0] for out in outs])
    topo = routing.build_topology(stream, nxt)
    plan = routing.plan_sharded_topology(topo, world, split_even(len(stream), world))
    bound = routing.ring_error_bound(topo, plan, 2.0 ** -24)
    one = routing.accumulate_downstream_log(torch.from_numpy(q), topo).numpy()
    rel = np.abs(ours - one) / one
    print(f"{world} processes: ring against one device, largest relative difference "
          f"{rel.max():.3e}, bound {bound:.3e}")
    assert ours.dtype == np.float32 and bound <= 1e-5
    assert (rel <= bound).all()


def test_exchange_bytes():
    """The ring sends each round's outbox around the ring; the oracle
    delivers every rank the whole block."""
    stream, nxt, q, _ = TOPOLOGIES["payload_split_even"]
    plan = routing.plan_sharded_topology(routing.build_topology(stream, nxt), 4,
                                         split_even(len(stream), 4))
    assert routing.ring_bytes_per_exchange(plan, 5, 8) == sum(
        4 * 3 * m * 5 * 8 for m in plan.round_slots)
    assert routing.allgather_bytes_per_exchange(len(stream), 5, 1, 4, 8) == 4 * len(stream) * 5 * 8
    one = routing.plan_sharded_topology(routing.build_topology(stream, nxt), 1)
    assert routing.ring_bytes_per_exchange(one, 5) == 0


# --- the CLI with two processes -------------------------------------------


def _files(folder, name, var, ranks):
    """A file kind's (values, link ids) of ``ranks`` ranks, concatenated."""
    parts = [read_netcdf(os.path.join(folder, f"{name}_basin_rank_{r}.nc"), (var, "system"))[0]
             for r in range(ranks)]
    return np.concatenate([p[var] for p in parts]), np.concatenate([p["system"] for p in parts])


def _write_config(scenario, folder, **changes):
    """The scenario's YAML with ``changes`` ({"section": {key: value}})."""
    import yaml

    doc = yaml.safe_load(scenario["cfg_path"].read_text())
    for section, values in changes.items():
        doc.setdefault(section, {}).update(values)
    doc["output"]["path"] = str(folder)
    path = folder.parent / f"{folder.name}.yaml"
    path.write_text(yaml.safe_dump(doc))
    return path


def _cli(config, tmp_path, crash_window=None):
    coord = f"127.0.0.1:{_free_port()}"
    head = [WORKER, "crash", str(crash_window)] if crash_window else ["-m", "tiger_tpu_torch.run"]
    return _launch([head + ["--config", str(config), "--cpu", "--distributed", "--coordinator",
                            coord, "--num-processes", str(RANKS), "--process-id", str(r),
                            "--dist-backend", "gloo"] for r in range(RANKS)], tmp_path)


@pytest.fixture(scope="module")
def basin(tmp_path_factory):
    """make_scenario's basin (6 links in a chain, 2 days, f64), and the one-
    process runs of the port and of the JAX package, whole and in 1-day
    windows with daily checkpoints."""
    tmp = tmp_path_factory.mktemp("basin")
    sc = make_scenario(tmp)
    windows = {"time": {"chunk_days": 1.0}, "output": {"checkpoint_interval": "1d"}}
    for tag, changes in (("whole", {}), ("windows", windows)):
        path = _write_config(sc, tmp / f"one_{tag}", **changes)
        run(load_config(str(path)), device="cpu")
        j_run(j_load_config(str(_write_config(sc, tmp / f"jax_{tag}", **changes))), use_mesh=False)
    return sc, tmp, windows


@pytest.mark.parametrize("exchange", ["ring", "allgather"])
@pytest.mark.parametrize("tag", ["whole", "windows"])
def test_two_process_cli_matches_one_process(basin, tmp_path, tag, exchange):
    sc, tmp, windows = basin
    changes = windows if tag == "windows" else {}
    out = tmp_path / "ranks"
    config = _write_config(sc, out, **{**changes, "output": {
        **changes.get("output", {}), "routed_exchange": exchange}})
    _ok(_cli(config, tmp_path))
    for name, var in (("final", "outputs"), ("dense", "outputs"), ("state", "outputs"),
                      ("discharge", "discharge")):
        got, ids = _files(out, name, var, RANKS)
        one, one_ids = _files(tmp / f"one_{tag}", name, var, 1)
        assert np.array_equal(ids, one_ids) and got.dtype == one.dtype, name
        if name == "discharge" and exchange == "ring":
            np.testing.assert_allclose(got, one, rtol=1e-12, atol=0)
        else:
            assert np.array_equal(got, one), name
        ref = read_netcdf(os.path.join(tmp / f"jax_{tag}", f"{name}_basin_rank_0.nc"), (var,))[0][var]
        _assert_close(got, ref, "f64")


def test_two_process_crash_resume(basin, tmp_path):
    """Both ranks die in their second window; each resumes from its own
    day-1 checkpoint (``{rank}`` in initial.file) into its own files, which
    then equal the uninterrupted run's bit for bit."""
    sc, tmp, windows = basin
    out = tmp_path / "ranks"
    config = _write_config(sc, out, **windows)
    crashed = _cli(config, tmp_path, crash_window=2)
    for rc, text in crashed:
        assert rc != 0 and "simulated crash" in text, text[-3000:]
    for r in range(RANKS):
        attrs = read_netcdf(str(out / f"state_basin_rank_{r}.nc"), ())[1]
        assert attrs["sim_time_minutes"] == 1440.0
    resume = _write_config(sc, out, **windows, initial={
        "mode": "hot", "file": str(out / "state_basin_rank_{rank}.nc"), "resume": True})
    _ok(_cli(resume, tmp_path))
    whole = tmp_path / "whole"
    _ok(_cli(_write_config(sc, whole, **windows), tmp_path))
    for name, var in (("final", "outputs"), ("dense", "outputs"), ("state", "outputs"),
                      ("discharge", "discharge")):
        for r in range(RANKS):
            a = read_netcdf(str(out / f"{name}_basin_rank_{r}.nc"), (var,))[0][var]
            b = read_netcdf(str(whole / f"{name}_basin_rank_{r}.nc"), (var,))[0][var]
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, r)


def test_nccl_two_ranks_on_one_card_refused(monkeypatch):
    from tiger_tpu_torch import dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="NCCL cannot put two ranks on one GPU"):
        dist.init_process("127.0.0.1:1", 2, 0, "nccl")
    with pytest.raises(ValueError, match="backend must be"):
        dist.init_process("127.0.0.1:1", 2, 0, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        dist.device_for_process()
    assert dist.device_for_process(cpu=True) == torch.device("cpu")

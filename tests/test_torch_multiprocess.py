"""The port's shard mesh over two processes against its single-process
mesh and the JAX package's, on the CPU.

Two spawned processes (``tests/torch_multiprocess_worker.py``) join one
``gloo`` group and each holds four of eight CPU shards of fat-tree k=4
(``make_multihost_mesh(8, device="cpu")``). They run the same scenarios
on the same inputs; each process's results are held against this
process's single-process 8-shard mesh (``make_mesh(8)``) and against
the reference's ``make_multihost_mesh(8)`` on its virtual CPU mesh:

- the mesh facts: ring order, each process's shards one arc, two
  processes, the axes of an 8-shard mesh, ``mesh_replica_index`` the
  rank;
- K3 and its step form on every wire dtype (``ring_all_gather``,
  ``RingExchange``, ``ring_stream``, ``exchange_distances``), and blocks
  of unequal rows refused in every process;
- the refresh's distances and next hops (gather and ring), both chases
  and the sharded collective's slot streams, bit for bit;
- the engine: windows, fdbs, the narrowed re-route after a flap,
  ``warm_serving``, the shortest and balanced collectives and the host
  twins, ring on and off;
- ``--distributed`` through the launcher (demo and checkpoint as one
  process writes them);
- every leg left for later raises ``NotImplementedError`` naming ROADMAP
  A4;
- without processes: each process's step table (its own sources, the
  destinations one process gives them) and the steps at which each
  process's blocks reach it (``ring._reach``), on synthetic addresses.

Each test waits at most its own time limit for both processes, and the
group's timeout is short, so a hang fails the test instead of the suite.
"""

import multiprocessing
import queue
import socket
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnmpi_tpu import shardplane as jshard
from sdnmpi_tpu.oracle import dag as jdag
from sdnmpi_tpu.oracle.engine import tensorize as j_tensorize
from sdnmpi_tpu.shardplane import mesh as jmesh
from sdnmpi_tpu.topogen import fattree as j_fattree
from sdnmpi_tpu_torch.kernels import ring
from sdnmpi_tpu_torch.shardplane import mesh as pmesh
from tests import torch_multiprocess_worker as W
from tests.conftest import N_VIRTUAL_DEVICES

WORLD = 2
#: seconds a collective of the workers' group waits before it fails
GROUP_TIMEOUT_S = 60.0
#: each test's limit on both processes' answer (the first includes the
#: spawn and the group's rendezvous)
ANSWER_S = 120.0


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


class Pair:
    """Two spawned processes of one ``gloo`` group, serving scenarios."""

    def __init__(self):
        ctx = multiprocessing.get_context("spawn")
        self.port = _free_port()
        self.outbox = ctx.Queue()
        self.inboxes = [ctx.Queue() for _ in range(WORLD)]
        self.procs = [
            ctx.Process(target=W.serve, daemon=True, args=(
                r, WORLD, self.port, self.inboxes[r], self.outbox, GROUP_TIMEOUT_S))
            for r in range(WORLD)
        ]
        for p in self.procs:
            p.start()
        self.cache: dict = {}

    def ask(self, name: str, **kw) -> list:
        """Every process's result of scenario ``name``, by rank; fails the
        test (and ends both processes) on an error or past ``ANSWER_S``."""
        key = (name, tuple(sorted(kw.items())))
        if key in self.cache:
            return self.cache[key]
        for box in self.inboxes:
            box.put((name, kw))
        got: dict = {}
        deadline = time.monotonic() + ANSWER_S
        while len(got) < WORLD:
            try:
                rank, status, out = self.outbox.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                self.close()
                pytest.fail(f"{name}: processes {sorted(set(range(WORLD)) - set(got))} "
                            f"gave no answer within {ANSWER_S} s")
            if status != "ok":
                self.close()
                pytest.fail(f"{name}: process {rank} failed:\n{out}")
            got[rank] = out
        self.cache[key] = [got[r] for r in range(WORLD)]
        return self.cache[key]

    @property
    def alive(self) -> bool:
        return all(p.is_alive() for p in self.procs)

    def close(self) -> None:
        for box in self.inboxes:
            box.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()


@pytest.fixture(scope="module")
def pair():
    """The two processes, started again for a test after one failed."""
    holder: dict = {}

    def get() -> Pair:
        if "pair" not in holder or not holder["pair"].alive:
            holder["pair"] = Pair()
        return holder["pair"]

    yield get
    if "pair" in holder:
        holder["pair"].close()


@pytest.fixture(scope="module")
def j_mesh(virtual_mesh):
    return jmesh.make_multihost_mesh(N_VIRTUAL_DEVICES)


@pytest.fixture(scope="module")
def j_problem():
    """The reference's tensors of fat-tree k=4 and its sharded distances
    and next hops on ``make_multihost_mesh(8)``."""
    t = j_tensorize(j_fattree(4).to_topology_db(backend="jax", pad_multiple=W.PAD), W.PAD)
    return t


def _same(got, want, what: str) -> None:
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


# -- the mesh -------------------------------------------------------------------


def test_mesh_facts_match_the_reference(pair, j_mesh):
    """Ring order, one arc a process, two processes, the axes of an
    8-shard mesh; the replica index is the rank; a second
    ``init_multihost`` is a no-op."""
    one = pmesh.make_mesh(N_VIRTUAL_DEVICES, device="cpu")
    for rank, got in enumerate(pair().ask("mesh")):
        assert got["rank"] == got["replica"] == rank
        assert got["init_again"] is True
        assert got["local"] == tuple(range(4 * rank, 4 * rank + 4))
        assert got["processes"] == [0] * 4 + [1] * 4
        assert got["ring"] == one.ring
        assert got["shape"] == one.shape == dict(j_mesh.shape)
        assert got["axes"] == pmesh.mesh_axes(one) == jmesh.mesh_axes(j_mesh)
        assert got["n_processes"] == 2 and got["multiprocess"] is True
        assert got["devices"] == [("cpu" if q in got["local"] else None) for q in range(8)]
        assert got["order"] == [(p, q) for p in (0, 1) for q in range(4 * p, 4 * p + 4)]
    assert jmesh.mesh_processes(j_mesh) == pmesh.mesh_processes(one) == 1


# -- K3 and its step form ----------------------------------------------------


def test_ring_kernels_across_processes(pair):
    """Every process's outputs and views equal the whole matrix on every
    wire dtype; ``ring_stream`` hands each local shard the reference's
    arrival order; the distance exchange is exact; unequal blocks raise
    in both processes."""
    rng = np.random.default_rng(7)
    for name, dtype in (("bf16", torch.bfloat16), ("int16", torch.int16),
                        ("int32", torch.int32)):
        # the wire's own values (bf16 rounds past 256)
        full = torch.as_tensor(rng.integers(-300, 300, (48, 5))).to(dtype).float().numpy()
        order = [[((me + d) % 8, t) for t in range(max(ring.ring_legs(8)) + 1)
                  for d in ring.step_offsets(t, 8)] for me in range(8)]
        for rank, got in enumerate(pair().ask("ring")):
            g = got[name]
            local = range(4 * rank, 4 * rank + 4)
            for q in range(8):
                if q in local:
                    _same(g["gather"][q], full, f"{name} K3 shard {q}")
                else:
                    assert g["gather"][q] is None
            for k, q in enumerate(local):
                _same(g["views"][k], full, f"{name} step form shard {q}")
                assert g["seen"][k] == order[q], (name, q)
    dist = rng.integers(0, 5, (48, 48)).astype(np.float32)
    dist[rng.random((48, 48)) < 0.1] = np.inf
    for got in pair().ask("ring"):
        assert len(got["dist"]) == 4
        for d in got["dist"]:
            _same(d, dist, "distance exchange")
        assert "one row count" in got["uneven"]


# -- the shardplane ------------------------------------------------------------


def test_refresh_and_chases_bit_equal(pair, j_mesh, j_problem):
    """Distances and next hops (gather and ring) and both chases, from
    row-sharded and replicated next hops: every process equal to one
    process and to the reference on ``make_multihost_mesh(8)``."""
    t = j_problem
    single = W.scenario_shardplane()
    j_dist = np.asarray(jshard.apsp_distances_rowsharded(t.adj, j_mesh))
    j_next = np.asarray(jshard.apsp_next_hops_rowsharded(
        t.adj, jnp.asarray(j_dist), j_mesh, t.max_degree))
    _same(single["dist"], j_dist, "one process's distances")
    _same(single["next"], j_next, "one process's next hops")
    src, dst, fport = W.chase_batch(t)
    max_len = int(j_dist[np.isfinite(j_dist)].max()) + 1
    j_args = (jnp.asarray(j_next), t.port, jnp.asarray(src), jnp.asarray(dst),
              jnp.asarray(fport), max_len, j_mesh)
    j_chase = {"sharded": jshard.batch_fdb_sharded(*j_args),
               "ringed": jshard.batch_fdb_ringed(*j_args)}
    for rank, got in enumerate(pair().ask("shardplane")):
        for key in ("dist", "next", "next_ring"):
            _same(got[key], single[key], f"process {rank}: {key}")
        _same(got["next_ring"], j_next, f"process {rank}: ring next hops")
        _same(got["dist"], j_dist, f"process {rank}: distances")
        for name in ("sharded", "ringed"):
            for form in ("rows", "full"):
                key = f"chase_{name}_{form}"
                for g, s, j in zip(got[key], single[key], j_chase[name]):
                    _same(g, s, f"process {rank}: {key}")
                    _same(g, j, f"process {rank}: {key} against the reference")


def test_collective_slot_streams_bit_equal(pair, j_mesh, j_problem):
    """``route_collective_sharded`` in ring and gather modes, with and
    without cached distances and a destination set: every process's slot
    stream and fractional congestion equal one process's and the
    reference's on ``make_multihost_mesh(8)``, bit for bit (on this idle
    fabric no flow meets a near-tie)."""
    t = j_problem
    single = W.scenario_shardplane()
    dist = single["dist"]
    p = W.collective_problem(_PortTensors(t), dist)
    kw = dict(levels=p["levels"], rounds=2, max_len=p["levels"] + 1, salt=3)
    dn = jdag.make_dst_nodes(p["dst"][p["src"] >= 0])
    answers = pair().ask("shardplane")
    for mode, one in zip(W.collective_modes(), single["collectives"]):
        ring_on, cached, restrict = mode
        j_slots, j_maxc = jshard.route_collective_sharded(
            *(jnp.asarray(p[k]) for k in ("adj", "li", "lj", "util", "traffic", "src",
                                          "dst")),
            j_mesh, dist=jnp.asarray(dist) if cached else None,
            dst_nodes=jnp.asarray(dn) if restrict else None, ring_exchange=ring_on, **kw)
        _same(one[0], j_slots, f"one process's slots {mode}")
        assert one[1] == float(j_maxc), mode
        for rank, got in enumerate(answers):
            slots, maxc = got["collectives"][W.collective_modes().index(mode)]
            _same(slots, one[0], f"process {rank}: slots {mode}")
            assert maxc == one[1], (rank, mode)


class _PortTensors:
    """The reference's tensors as ``collective_problem`` reads them."""

    def __init__(self, t):
        self.index = t.index
        self._adj = np.asarray(t.adj)

    def host_adj(self):
        return self._adj


# -- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("ring_on", [False, True])
def test_engine_entry_points_bit_equal(pair, ring_on):
    """``TopologyDB(mesh_devices=8, shard_oracle=True)`` on two
    processes: windows, fdbs, the narrowed re-route after a flap,
    ``warm_serving``, the shortest and balanced collectives and the host
    twins equal one process's; the shortest collective, the windows, the
    fdbs and ``warm_serving`` equal the reference's too."""
    single = W.scenario_engine(ring_on)
    jdb = j_fattree(4).to_topology_db(backend="jax", pad_multiple=W.PAD)
    jdb.mesh_devices = N_VIRTUAL_DEVICES
    jdb.shard_oracle = True
    jdb.ring_exchange = ring_on
    jdb._jax_oracle().host_chase_hop_budget = 0
    macs = sorted(jdb.hosts)
    pairs = [(a, b) for a in macs[:10] for b in macs[:10] if a != b]
    assert W.window(jdb.find_routes_batch_dispatch(pairs).reap()) == single["window"]
    assert jdb.find_routes_batch(pairs) == single["fdbs"]
    warm = jdb.warm_serving()
    assert (warm["shapes"], warm["max_len"]) == single["warm"]
    n = len(macs)
    src, dst = np.arange(n), np.roll(np.arange(n), 3)
    assert W.collective(jdb.find_routes_collective(
        macs, src, dst, policy="shortest")) == single["shortest"]
    for rank, got in enumerate(pair().ask("engine", ring=ring_on)):
        for key in ("window", "fdbs", "warm", "shortest", "balanced", "delta"):
            assert got[key] == single[key], (rank, key)
        for key in ("dist", "next"):
            _same(got[key], single[key], f"process {rank}: host {key}")


# -- the launcher and the legs left for later ----------------------------------


def test_distributed_launch(pair):
    """``--distributed HOST:PORT,2,RANK --device cpu --shard-oracle
    --demo``: both processes install the demo's flows and write the
    checkpoint one process writes."""
    single = W.run_launch([])
    assert single["demo"] and "flows installed" in single["demo"][0]
    for rank, got in enumerate(pair().ask("launch")):
        assert got["spec"] == f"127.0.0.1:{pair().port},{WORLD},{rank}"
        assert got["demo"] == single["demo"], rank
        assert got["checkpoint"] == single["checkpoint"], rank


def test_legs_left_for_later_raise(pair):
    """The greedy balancer, the UGAL program, ``multichip_route_step``,
    the v-axis refresh and the hier oracle's three sharded planes raise
    on a two-process mesh, naming ROADMAP A4, in both processes."""
    for got in pair().ask("later"):
        for name, msg in got.items():
            assert "ROADMAP A4" in msg and "processes" in msg, (name, msg)
        assert len(got) == 7


# -- each process's part of a step (no processes needed) -----------------------


def _two_process_mesh(rank: int):
    return pmesh.ShardMesh(["cpu"] * 8, processes=[0] * 4 + [1] * 4, rank=rank)


@pytest.mark.parametrize("nbytes", [96, 4096 + 2])
def test_each_process_launches_for_its_own_sources(nbytes):
    """A process's step table holds its own sources only, each with the
    destinations one process's table gives it (in any process's views);
    the two processes' tables together are one process's, and a grid
    counts the table's sources."""
    s = 8
    src = [0x7F00_0000_0000 + q * (1 << 24) for q in range(s)]
    views = [0x7E00_0000_0000 + me * s * nbytes for me in range(s)]
    for t in range(max(ring.ring_legs(s)) + 1):
        whole = ring.step_args(src, views, nbytes, t, ctas=128)
        parts = []
        for rank in (0, 1):
            m = _two_process_mesh(rank)
            mine = [a if q in m.local else 0 for q, a in enumerate(src)]
            a = ring.step_args(mine, views, nbytes, t, ctas=128)
            assert len(a.table) == 3 * len(m.local)
            assert (a.bulk, a.unit, a.head, a.mid, a.tail) == (
                whole.bulk, whole.unit, whole.head, whole.mid, whole.tail)
            assert a.grid == (min(128, 4 * -(-a.mid // ring.BULK_CHUNK)) if a.bulk
                              else 128 // 4)
            parts += list(a.table)
        assert parts == list(whole.table)


@pytest.mark.parametrize("rank", [0, 1])
def test_reach_follows_the_schedule(rank):
    """The steps at which each process's blocks land in this process's
    views: exactly those at which ``arrival_steps`` brings one of them
    to one of this process's shards."""
    m = _two_process_mesh(rank)
    last = max(ring.ring_legs(8))
    want = {p: sorted({ring.arrival_steps(me, 8)[q] for me in m.local
                       for q in range(4 * p, 4 * p + 4)}) for p in (0, 1)}
    assert ring._reach(m, last) == want
    assert want[rank][0] == 0 and want[1 - rank][0] > 0

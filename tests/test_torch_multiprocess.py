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
  process writes them), with ``--shard-oracle`` and with
  ``--hier-oracle``;
- the legs a single-process mesh runs, each bit-equal in every process
  to one process's run: the greedy balancer, the UGAL program (packed
  and decoded), ``multichip_route_step`` and the v-axis refresh against
  the reference's sharded legs too; the hier oracle's pod blocks, row
  sweep and border plane against its single-device oracle and host
  executor; the engine's adaptive batches, and the hier oracle's routes
  and flap repair;
- without processes: each process's step table (its own sources, the
  destinations one process gives them), the steps at which each
  process's blocks reach it (``ring._reach``), on synthetic addresses,
  and which process computes which "v" block at one shard a process.

Each test waits at most its own time limit for both processes, and the
group's timeout is short, so a hang fails the test instead of the suite.
"""

import multiprocessing
import queue
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnmpi_tpu import shardplane as jshard
from sdnmpi_tpu.oracle import dag as jdag
from sdnmpi_tpu.oracle import hier as j_hier
from sdnmpi_tpu.oracle.apsp import apsp_distances as j_apsp
from sdnmpi_tpu.oracle.engine import tensorize as j_tensorize
from sdnmpi_tpu.shardplane import hier as j_shier
from sdnmpi_tpu.shardplane import mesh as jmesh
from sdnmpi_tpu.topogen import dragonfly as j_dragonfly
from sdnmpi_tpu.topogen import fattree as j_fattree
from sdnmpi_tpu_torch.kernels import ring
from sdnmpi_tpu_torch.shardplane import apsp as papsp
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


# -- the launcher ------------------------------------------------------------


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


def test_distributed_hier_launch(pair):
    """``--distributed HOST:PORT,2,RANK --device cpu --hier-oracle
    --ring-exchange --demo``: both processes install the demo's flows
    and write the checkpoint (border plane included) one process
    writes."""
    single = W.run_launch([], hier=True)
    assert single["demo"] and "flows installed" in single["demo"][0]
    assert single["checkpoint"]["hier_border"]["pods"]
    for rank, got in enumerate(pair().ask("launch", hier=True)):
        assert got["demo"] == single["demo"], rank
        assert got["checkpoint"] == single["checkpoint"], rank


# -- the sharded legs on two processes -----------------------------------------


@pytest.fixture(scope="module")
def single_routing():
    """One process's routing legs on ``make_mesh(8)``."""
    return W.scenario_routing()


@pytest.fixture(scope="module")
def single_hier():
    """One process's hier legs on ``make_mesh(8)``."""
    return W.scenario_hier()


_J_ADAPTIVE: dict = {}


def _j_route_adaptive(mesh, n_valid, cached, **kw):
    """The reference's ``route_adaptive_sharded`` under ``jax.jit`` (one
    program per configuration; the eager shard_map takes tens of seconds
    a call)."""
    key = (n_valid, cached, tuple(sorted(kw.items())))
    if key not in _J_ADAPTIVE:
        _J_ADAPTIVE[key] = jax.jit(lambda a, u, s, d, w, dd: jshard.route_adaptive_sharded(
            a, u, s, d, w, n_valid, mesh, dist=dd, **kw))
    return _J_ADAPTIVE[key]


def _reference_routing(leg: str, j_mesh, t) -> dict:
    """The reference's sharded legs on ``make_multihost_mesh(8)``, fed the
    worker's seeded problems (:func:`W.balance_problem`,
    :func:`W.ugal_problem`)."""
    if leg in ("flows", "flows_fractional", "step"):
        p = W.balance_problem(np.asarray(t.adj), t.n_real,
                              fractional=leg == "flows_fractional")
        args = (jnp.asarray(p["base"]), jnp.asarray(p["src"]), jnp.asarray(p["dst"]),
                jnp.asarray(p["weight"]), j_mesh, W.FLOW_KW["max_len"])
        kw = dict(chunk=W.FLOW_KW["chunk"], max_degree=t.max_degree)
        if leg != "step":
            got = jshard.route_flows_sharded(t.adj, j_apsp(t.adj), *args, **kw)
        else:
            got = jshard.multichip_route_step(t.adj, *args, **kw)
        return {"out": [np.asarray(x) for x in got],
                "v_blocks": np.asarray(jshard.apsp_distances_sharded(t.adj, j_mesh))}
    dt = j_tensorize(j_dragonfly(4, 4).to_topology_db(backend="jax", pad_multiple=W.PAD),
                     W.PAD)
    if leg == "ugal_fractional":
        u = W.ugal_problem(np.asarray(dt.adj), dt.n_real, seed=2, fractional=True)
        fn = _j_route_adaptive(j_mesh, dt.n_real, False, packed=True,
                               max_degree=dt.max_degree, **W.UGAL_KW)
        return {"out": [np.asarray(x) for x in fn(
            dt.adj, jnp.asarray(u["util"]), jnp.asarray(u["src"]), jnp.asarray(u["dst"]),
            jnp.asarray(u["weight"]), None)]}
    u = W.ugal_problem(np.asarray(dt.adj), dt.n_real)
    out = {}
    for cached in (False, True):
        fn = _j_route_adaptive(j_mesh, dt.n_real, cached, packed=leg == "ugal_packed",
                               max_degree=dt.max_degree, **W.UGAL_KW)
        got = fn(dt.adj, jnp.asarray(u["util"]), jnp.asarray(u["src"]),
                 jnp.asarray(u["dst"]), jnp.asarray(u["weight"]),
                 j_apsp(dt.adj) if cached else None)
        out[cached] = [np.asarray(x) for x in got]
    return out


@pytest.fixture(scope="module")
def j_hier_state():
    """The reference's single-device hier oracle on fattree(8) after the
    worker's pairs and collective, its row sweep of every border, and
    its fdbs after each half of the worker's intra-pod flap."""
    from sdnmpi_tpu.core.topology_db import Link as JLink
    from sdnmpi_tpu.core.topology_db import Port as JPort

    db = j_fattree(8).to_topology_db(backend="jax", hier_oracle=True)
    pairs = W.hier_pairs(db)
    out = {"fdbs": db.find_routes_batch(pairs)}
    macs = sorted(db.hosts)[:12]
    si, di = np.nonzero(~np.eye(12, dtype=bool))
    out["collective"] = db.find_routes_collective(
        macs, si.astype(np.int32), di.astype(np.int32), "shortest").fdbs()
    st = db._jax_oracle()._hier
    out["state"] = st
    out["sweep"] = j_hier.sweep_rows_host(st.deg_buckets, st.n_borders,
                                          np.arange(st.n_borders, dtype=np.int64))
    out["rows"] = {p: np.asarray(r).copy() for p, r in st.rows.items()}
    a, pa, b, pb = W.hier_cable()
    out["flap"] = []
    for add in (False, True):
        for x, px, y, py in ((a, pa, b, pb), (b, pb, a, pa)):
            link = JLink(JPort(x, px), JPort(y, py))
            (db.add_link if add else db.delete_link)(link)
        out["flap"].append(db.find_routes_batch(pairs))
    return out


ROUTING_LEGS = ["psum", "flows", "flows_fractional", "ugal_packed", "ugal_decoded",
                "ugal_fractional", "step", "v_refresh"]
HIER_LEGS = ["pod_blocks", "row_sweep", "border_plane"]


@pytest.mark.parametrize("leg", ROUTING_LEGS + HIER_LEGS)
def test_sharded_leg_bit_equal_across_processes(leg, pair, j_mesh, j_problem,
                                                single_routing, single_hier, j_hier_state):
    """Each leg on two processes, 4 of 8 CPU shards each: every process's
    result equal bit for bit to one process's 8-shard mesh, and to the
    reference: its sharded legs on ``make_multihost_mesh(8)`` for the
    routing legs (the UGAL load to rtol 1e-5, f32 products summed in
    another order, as ``tests/test_torch_shard_legs.py`` holds it), its
    single-device hier oracle and host executors for the hier legs.
    The fractional cases' sums depend on their order, so they hold the
    shard-order psum across processes: bit-equal to one process, and to
    the reference's load to rtol 1e-6 (balancer) and 1e-5 (UGAL), its
    ``psum`` adding in another order."""
    if leg in ROUTING_LEGS:
        answers, single = pair().ask("routing"), single_routing
        want = (None if leg in ("psum", "v_refresh")
                else _reference_routing(leg, j_mesh, j_problem))
    else:
        answers, single = pair().ask("hier"), single_hier
    if leg == "psum":
        for dtype in (torch.float32, torch.float64):
            parts = W.psum_parts(dtype)
            total = parts[0]
            for x in parts[1:]:
                total = total + x
            back = parts[-1]
            for x in reversed(parts[:-1]):
                back = back + x
            assert not torch.equal(total, back)  # the order shows
            _same(single[leg][str(dtype)], total, f"one process's {dtype} psum")
            for rank, got in enumerate(answers):
                _same(got[leg][str(dtype)], total, f"process {rank}: {dtype} psum")
    elif leg in ("flows", "step"):
        nodes, load, maxc = single[leg]
        j_nodes, j_load, j_maxc = want["out"]
        _same(nodes, j_nodes, f"one process's {leg} nodes")
        _same(load, j_load, f"one process's {leg} load")
        assert maxc == float(j_maxc)
        assert (nodes[:-3, 0] >= 0).all() and (nodes[-3:] == -1).all()
        for rank, got in enumerate(answers):
            for g, o, what in zip(got[leg], single[leg], ("nodes", "load", "maxc")):
                _same(g, o, f"process {rank}: {leg} {what}")
        if leg == "step":
            _same(np.concatenate(single["v_blocks"]), want["v_blocks"], "v blocks")
            for got in answers:
                for g, o in zip(got["v_blocks"], single["v_blocks"]):
                    _same(g, o, "v blocks")
    elif leg == "flows_fractional":
        nodes, load, maxc = single[leg]
        j_nodes, j_load, j_maxc = want["out"]
        _same(nodes, j_nodes, "one process's nodes")
        np.testing.assert_allclose(load, j_load, rtol=1e-6)
        np.testing.assert_allclose(maxc, float(j_maxc), rtol=1e-6)
        for rank, got in enumerate(answers):
            for g, o, what in zip(got[leg], single[leg], ("nodes", "load", "maxc")):
                _same(g, o, f"process {rank}: {leg} {what}")
    elif leg == "ugal_fractional":
        np.testing.assert_allclose(single[leg][3], want["out"][3], rtol=1e-5)
        for rank, got in enumerate(answers):
            for g, o in zip(got[leg], single[leg]):
                _same(g, o, f"process {rank}: {leg}")
    elif leg.startswith("ugal"):
        packed = leg == "ugal_packed"
        for cached in (False, True):
            one = single[("ugal", packed, cached)]
            for k, (o, j) in enumerate(zip(one, want[cached])):
                if k < 3:
                    _same(o, j, f"one process's {leg} output {k} (cached {cached})")
                else:
                    np.testing.assert_allclose(o, j, rtol=1e-5, atol=1e-5)
            assert (one[0] >= 0).any()  # some flows detour
            for rank, got in enumerate(answers):
                for g, o in zip(got[("ugal", packed, cached)], one):
                    _same(g, o, f"process {rank}: {leg} (cached {cached})")
    elif leg == "v_refresh":
        jdb = j_fattree(4).to_topology_db(backend="jax", pad_multiple=W.PAD)
        jdb.mesh_devices = N_VIRTUAL_DEVICES
        jo = jdb._jax_oracle()
        jo.refresh(jdb)
        for o, j in zip(single["refresh"], (jo._dist, jo._next)):
            _same(o, j, "one process's mesh-only refresh")
        for rank, got in enumerate(answers):
            for g, o in zip(got["refresh"], single["refresh"]):
                _same(g, o, f"process {rank}: mesh-only refresh")
    elif leg == "pod_blocks":
        for seed, n, s in W.HIER_STACKS:
            jd, jn = (np.asarray(x) for x in j_shier.pod_stack_apsp(
                W.hier_stack(seed, n, s), mesh=None))
            d, nx, twins, sharded = single[("pods", seed)]
            _same(d, jd, "one process's pod distances")
            _same(nx, jn, "one process's pod next hops")
            assert sharded == (n >= N_VIRTUAL_DEVICES)
            _same(twins[0][:n], jd, "resident distance twins")
            _same(twins[1][:n], jn, "resident next-hop twins")
            for rank, got in enumerate(answers):
                g = got[("pods", seed)]
                for x, o in zip((*g[:2], *g[2]), (d, nx, *twins)):
                    _same(x, o, f"process {rank}: pod blocks of stack {seed}")
                assert g[3] == sharded
    elif leg == "row_sweep":
        rows, plane = single["sweep"]
        _same(rows, j_hier_state["sweep"], "one process's border rows")
        _same(plane[:len(rows)], rows, "one process's device plane")
        assert plane.shape[0] % N_VIRTUAL_DEVICES == 0
        for rank, got in enumerate(answers):
            for g, o in zip(got["sweep"], single["sweep"]):
                _same(g, o, f"process {rank}: row sweep")
            for p, r in single["rows"].items():
                _same(got["rows"][p], r, f"process {rank}: lazy rows of pod {p}")
                _same(r, j_hier_state["rows"][p], f"lazy rows of pod {p}")
    else:
        js = j_hier_state["state"]
        for bi, b in enumerate(js.buckets):
            plane = single["plane"][bi]
            for i, p in enumerate(b.pods):
                lo, hi = int(js.pod_bstart[p]), int(js.pod_bstart[p + 1])
                bl = js.border_local[lo:hi]
                _same(plane[i, :hi - lo], np.asarray(b.dist)[i][bl, :],
                      f"border plane of pod {p}")
                assert np.isinf(plane[i, hi - lo:]).all()
        for rank, got in enumerate(answers):
            assert sorted(got["plane"]) == sorted(single["plane"])
            for bi, plane in single["plane"].items():
                _same(got["plane"][bi], plane, f"process {rank}: border plane {bi}")


@pytest.mark.parametrize("shard_oracle", [False, True])
def test_engine_adaptive_batch_across_processes(pair, single_routing, shard_oracle):
    """``find_routes_batch_adaptive`` on ``TopologyDB(mesh_devices=8)``
    (the mesh-only refresh) and with ``shard_oracle``: the sharded UGAL
    program through the engine, every process's fdbs, detours and
    congestion equal to one process's."""
    key = "adaptive_shard_oracle" if shard_oracle else "adaptive"
    fdbs, detours, maxc = single_routing[key]
    assert detours >= 0 and all(fdbs)
    for rank, got in enumerate(pair().ask("routing")):
        assert got[key] == single_routing[key], rank


def test_hier_oracle_routes_and_flap_across_processes(pair, single_hier, j_hier_state):
    """``TopologyDB(hier_oracle=True, mesh_devices=8, ring_exchange=True)``
    on two processes: fdbs and a collective equal to one process's and
    to the reference's single device; an intra-pod flap repairs the pod
    blocks in place (no full build), its routes and the link's return
    equal to the reference's, the repaired resident twins equal to the
    host stacks."""
    assert single_hier["fdbs"] == j_hier_state["fdbs"]
    assert single_hier["collective"] == j_hier_state["collective"]
    flap, builds = single_hier["flap"]
    assert builds == 0
    for (fdbs, twins, _), want in zip(flap, j_hier_state["flap"]):
        assert fdbs == want
        for twin, host in twins:
            _same(twin, host, "repaired twin")
    for rank, got in enumerate(pair().ask("hier")):
        for key in ("fdbs", "collective"):
            assert got[key] == single_hier[key], (rank, key)
        g_flap, g_builds = got["flap"]
        assert g_builds == 0
        for (g, g_twins, g_rows), (o, o_twins, o_rows) in zip(g_flap, flap):
            assert g == o, rank
            for (gt, gh), (ot, oh) in zip(g_twins, o_twins):
                _same(gt, ot, f"process {rank}: repaired twin")
                _same(gh, oh, f"process {rank}: repaired host stack")
            assert sorted(g_rows) == sorted(o_rows)
            for p, r in o_rows.items():
                _same(g_rows[p], r, f"process {rank}: rows of pod {p} after the flap")


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


@pytest.mark.parametrize("rank", range(4))
def test_v_blocks_of_one_shard_a_process(rank):
    """Four processes of one shard (a 2 x 2 mesh): each computes the
    "v" block of its own shard's "v" index, every block crosses to the
    processes that lack it (one K3 launch over the mesh), and the blocks
    this process returns are the whole matrix's. On two processes of
    four shards each process holds both indexes and nothing crosses."""
    m = pmesh.ShardMesh(["cpu"] * 4, processes=range(4), rank=rank)
    assert m.shape == {"flow": 2, "v": 2}
    assert papsp.v_block_shards(m) == [rank if j == rank % 2 else None for j in (0, 1)]
    assert [papsp.v_block_shards(m, p) for p in range(4)] == [
        [0, None], [None, 1], [2, None], [None, 3]]
    assert papsp.v_blocks_cross(m)
    two = _two_process_mesh(rank % 2)
    assert papsp.v_block_shards(two) == [4 * (rank % 2), 4 * (rank % 2) + 1]
    assert not papsp.v_blocks_cross(two)
    # the crossing, with K3's gather played by the other processes' blocks
    from sdnmpi_tpu_torch.oracle.apsp import apsp_distances

    adj = torch.as_tensor(W.hier_stack(4, 1, 16)[0])
    whole = apsp_distances(adj)
    sent = []

    def gather(blocks, mesh):
        assert mesh is m and [q for q, b in enumerate(blocks) if b is not None] == [rank]
        sent.append(blocks[rank])
        rows = [whole[(q % 2) * 8:(q % 2 + 1) * 8] for q in range(4)]
        rows[rank] = blocks[rank]
        return [torch.cat(rows) if q == rank else None for q in range(4)]

    saved = papsp.ring_all_gather
    papsp.ring_all_gather = gather
    try:
        got = papsp.apsp_distances_sharded(adj, m)
    finally:
        papsp.ring_all_gather = saved
    assert len(sent) == 1
    _same(sent[0], whole[(rank % 2) * 8:(rank % 2 + 1) * 8], "the block this process sends")
    _same(torch.cat(got), whole, "the blocks this process holds")

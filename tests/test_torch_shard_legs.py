"""The port's remaining sharded legs against the JAX package's, on the
CPU: the reference on its 8-device virtual mesh, the port on
``make_mesh(8, device="cpu")``, both fed the same seeded numpy inputs.

- The chase (``batch_fdb_sharded``, ``batch_fdb_ringed``): nodes, ports
  and lengths bit-equal to the reference's on fat-tree, linear and torus
  fabrics with ``-1`` pads, ring and gather modes equal, and the int32
  wire (forced by lowering the port's ``NEXT_WIRE_MAX_V``) changes
  nothing.
- The sharded UGAL program (``route_adaptive_sharded``), packed and
  unpacked, with and without cached distances: with integer weights the
  intermediates and both slot streams are bit-equal to the reference's,
  and everything, the load included, to the port's single-device
  ``route_adaptive``. The load agrees with the reference's to rtol 1e-5:
  the balancer's fractional splits are f32 products summed in another
  order (the reference holds its own sharded load to its single device
  so). With fractional weights the traffic sums differ too (the
  reference sums f32 per shard, the port f64, see
  ``oracle/adaptive.py``), and every stitched route is checked as a
  path.
- The balancer and the step (``route_flows_sharded``,
  ``multichip_route_step``) on ``__graft_entry__._example_problem``'s
  fat-tree k=4: nodes equal, load and max congestion to rtol 1e-6.
- ``window_readback_nbytes``: independent of the padded V.
- The engine: ``TopologyDB(mesh_devices=8, shard_oracle=True)`` with the
  ring on and off past the host-chase budget, ``warm_serving``, the
  adaptive batch and the shortest and adaptive collectives (flat and
  phased), each equal to the reference's; a Controller's flow tables and
  bus events; the four ``shard_*`` instruments and the two spans.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnmpi_tpu import shardplane as jshard
from sdnmpi_tpu.oracle.apsp import apsp_distances as j_apsp
from sdnmpi_tpu.oracle.apsp import apsp_next_hops as j_next_hops
from sdnmpi_tpu.oracle.engine import tensorize as j_tensorize
from sdnmpi_tpu.oracle.paths import batch_fdb as j_batch_fdb
from sdnmpi_tpu.topogen import dragonfly, fattree, linear, torus
from sdnmpi_tpu_torch import shardplane as pshard
from sdnmpi_tpu_torch.convert import gather_rows, shard_rows, topology_from_dict
from sdnmpi_tpu_torch.kernels import ring
from sdnmpi_tpu_torch.oracle.adaptive import link_loads, route_adaptive, stitch_paths
from tests.conftest import N_VIRTUAL_DEVICES

TOPOS = {
    "linear": lambda: linear(10, hosts_per_switch=2),
    "fattree": lambda: fattree(4),
    "torus": lambda: torus((2, 2, 2), hosts_per_switch=2),
}


def t_(x):
    return torch.tensor(np.asarray(x))


def cat(blocks):
    return np.concatenate([b.numpy() for b in blocks])


@pytest.fixture(scope="module")
def p_mesh():
    return pshard.make_mesh(N_VIRTUAL_DEVICES, device="cpu")


def _tensors(spec, pad: int = 8):
    return j_tensorize(spec.to_topology_db(backend="jax", pad_multiple=pad), pad)


# -- the chase --------------------------------------------------------------


def _chase_problem(topo, seed=0, n=48, n_pad=5):
    """Tensors, next hops and a seeded batch of ``n`` flows whose last
    ``n_pad`` are ``-1`` pads (one more pair is unreachable-free but
    src == dst)."""
    t = _tensors(TOPOS[topo]())
    dist = j_apsp(t.adj)
    nxt = np.asarray(j_next_hops(t.adj, dist, max_degree=t.max_degree))
    rng = np.random.default_rng(seed)
    src = rng.integers(0, t.n_real, n).astype(np.int32)
    dst = rng.integers(0, t.n_real, n).astype(np.int32)
    dst[0] = src[0]
    src[-n_pad:] = -1
    dst[-n_pad:] = -1
    fport = rng.integers(1, 9, n).astype(np.int32)
    d = np.asarray(dist)
    max_len = int(d[np.isfinite(d)].max()) + 1
    return t, nxt, src, dst, fport, max_len


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_chase_legs_match_the_reference(topo, virtual_mesh, p_mesh):
    """Both chases, from row-sharded and from replicated next hops, equal
    the reference's sharded, ringed and single-device chases bit for
    bit."""
    t, nxt, src, dst, fport, max_len = _chase_problem(topo)
    j_args = (jnp.asarray(nxt), t.port, jnp.asarray(src), jnp.asarray(dst),
              jnp.asarray(fport), max_len)
    want = [np.asarray(x) for x in j_batch_fdb(*j_args)]
    for j_fn in (jshard.batch_fdb_sharded, jshard.batch_fdb_ringed):
        for w, r in zip(want, j_fn(*j_args, virtual_mesh)):
            np.testing.assert_array_equal(np.asarray(r), w)
    assert (want[2][:-5] > 0).all() and (want[2][-5:] == 0).all()
    port = t_(t.port)
    args = (t_(src), t_(dst), t_(fport), max_len, p_mesh)
    for fn in (pshard.batch_fdb_sharded, pshard.batch_fdb_ringed):
        for next_hop in (shard_rows(nxt, p_mesh), t_(nxt)):
            got = fn(next_hop, port, *args)
            assert all(len(g) == N_VIRTUAL_DEVICES for g in got)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(cat(g), w)


def test_ringed_chase_int32_wire_is_unchanged(monkeypatch, p_mesh):
    """Past ``NEXT_WIRE_MAX_V`` the next hops ride the ring as int32: the
    rows are those of the int16 wire."""
    t, nxt, src, dst, fport, max_len = _chase_problem("fattree", seed=3)
    dtypes = []
    step = ring.ring_step

    def spy(blocks, views, t, ctas=None):
        if t == 0:  # one record per exchange
            dtypes.append(blocks[0].dtype)
        return step(blocks, views, t, ctas)

    monkeypatch.setattr(ring, "ring_step", spy)
    args = (shard_rows(nxt, p_mesh), t_(t.port), t_(src), t_(dst), t_(fport),
            max_len, p_mesh)
    narrow = pshard.batch_fdb_ringed(*args)
    monkeypatch.setattr(ring, "NEXT_WIRE_MAX_V", 4)
    wide = pshard.batch_fdb_ringed(*args)
    assert dtypes == [torch.int16, torch.int32]
    for a, b in zip(narrow, wide):
        np.testing.assert_array_equal(cat(a), cat(b))


def test_chase_and_programs_refuse_uneven_batches(p_mesh):
    t, nxt, src, dst, fport, max_len = _chase_problem("linear")
    nh, port = t_(nxt), t_(t.port)
    for fn in (pshard.batch_fdb_sharded, pshard.batch_fdb_ringed):
        with pytest.raises(ValueError, match="divide"):
            fn(nh, port, t_(src[:7]), t_(dst[:7]), t_(fport[:7]), max_len, p_mesh)
    with pytest.raises(ValueError, match="divide"):
        pshard.route_flows_sharded(
            t_(t.adj), t_(np.asarray(j_apsp(t.adj))), torch.zeros(nh.shape),
            t_(src[:7]), t_(dst[:7]), torch.ones(7), p_mesh, max_len)


# -- the sharded UGAL program ----------------------------------------------


def _ugal_problem(seed, fractional=False):
    """``tests/test_mesh_adaptive.py``'s dragonfly(4, 4) with its hot
    next-group links, 64 seeded flows (the last 3 dead pads)."""
    t = _tensors(dragonfly(4, 4))
    v = t.adj.shape[0]
    adj = np.asarray(t.adj)
    rng = np.random.default_rng(seed)
    n = 64
    src = rng.integers(0, t.n_real, n).astype(np.int32)
    dst = ((((src // 4) + 1) % 4) * 4 + rng.integers(0, 4, n)).astype(np.int32)
    src[-3:] = -1
    dst[-3:] = -1
    w = (rng.uniform(0.1, 3.0, n) if fractional else rng.integers(1, 4, n))
    w = w.astype(np.float32)
    groups = np.arange(v) // 4
    util = np.zeros((v, v), np.float32)
    util[(groups[None, :] == (groups[:, None] + 1) % 4) & (adj > 0)] = 50.0
    return t, adj, src, dst, w, util


UGAL_KW = dict(levels=4, max_len=8, n_candidates=8)

_J_ROUTE_ADAPTIVE = jshard.route_adaptive_sharded
_J_ADAPTIVE_JITS: dict = {}


def j_route_adaptive_sharded(adj, util, src, dst, weight, n_valid, mesh,
                             dist=None, **kw):
    """The reference's ``route_adaptive_sharded`` under ``jax.jit``, one
    compiled program per static configuration: the same computation,
    without the eager shard_map's tens of seconds per call."""
    key = (int(n_valid), mesh, dist is not None, tuple(sorted(kw.items())))
    fn = _J_ADAPTIVE_JITS.get(key)
    if fn is None:
        fn = _J_ADAPTIVE_JITS[key] = jax.jit(
            lambda a, u, s, d, w, dd: _J_ROUTE_ADAPTIVE(
                a, u, s, d, w, int(n_valid), mesh, dist=dd, **kw))
    return fn(adj, util, src, dst, weight, dist)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_route_adaptive_sharded_matches_the_reference(packed, cached, virtual_mesh,
                                                      p_mesh):
    """Integer weights: inter and both segments bit-equal to the
    reference's sharded program, and everything bit-equal to the port's
    single device. The hot links make the balancer's splits fractional,
    so the load is held to the reference's as ``test_torch_adaptive``
    and ``tests/test_mesh_adaptive.py`` hold it: rtol 1e-5 (f32
    products summed in another order)."""
    t, adj, src, dst, w, util = _ugal_problem(1)
    j_dist = j_apsp(t.adj)
    want = j_route_adaptive_sharded(
        t.adj, jnp.asarray(util), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(w), t.n_real, virtual_mesh, max_degree=t.max_degree,
        dist=j_dist if cached else None, packed=packed, **UGAL_KW)
    want = [np.asarray(x) for x in want]
    dist = shard_rows(np.asarray(j_dist), p_mesh) if cached else None
    got = pshard.route_adaptive_sharded(
        t_(adj), t_(util), t_(src), t_(dst), t_(w), t.n_real, p_mesh,
        dist=dist, packed=packed, **UGAL_KW)
    for g, wnt in zip(got[:3], want[:3]):
        assert len(g) == N_VIRTUAL_DEVICES
        np.testing.assert_array_equal(cat(g), wnt)
    np.testing.assert_allclose(got[3].numpy(), want[3], rtol=1e-5, atol=1e-5)
    assert (want[0] >= 0).any()  # congestion makes some flows detour
    single = route_adaptive(t_(adj), t_(util), t_(src), t_(dst), t_(w), t.n_real,
                            packed=packed, **UGAL_KW)
    for g, s in zip(got[:3], single[:3]):
        np.testing.assert_array_equal(cat(g), s.numpy())
    np.testing.assert_array_equal(got[3].numpy(), single[3].numpy())


def test_route_adaptive_sharded_fractional_weights(virtual_mesh, p_mesh):
    """Fractional weights: the load agrees with the reference's to rtol
    1e-5, every stitched route is a path from its source to its
    destination, and the port's sharded program equals its single
    device bit for bit."""
    t, adj, src, dst, w, util = _ugal_problem(2, fractional=True)
    want = j_route_adaptive_sharded(
        t.adj, jnp.asarray(util), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(w), t.n_real, virtual_mesh, max_degree=t.max_degree, **UGAL_KW)
    inter, n1, n2, load = pshard.route_adaptive_sharded(
        t_(adj), t_(util), t_(src), t_(dst), t_(w), t.n_real, p_mesh, **UGAL_KW)
    np.testing.assert_allclose(load.numpy(), np.asarray(want[3]), rtol=1e-5)
    inter = cat(inter)
    paths = stitch_paths(cat(n1), cat(n2), inter)
    for f in range(len(src) - 3):
        p = paths[f][paths[f] >= 0]
        assert p[0] == src[f] and p[-1] == dst[f], (f, p)
        assert all(adj[a, b] > 0 for a, b in zip(p, p[1:]))
    single = route_adaptive(t_(adj), t_(util), t_(src), t_(dst), t_(w), t.n_real,
                            **UGAL_KW)
    np.testing.assert_array_equal(inter, single[0].numpy())
    np.testing.assert_array_equal(load.numpy(), single[3].numpy())
    live = w.copy()
    live[-3:] = 0
    np.testing.assert_allclose(load.numpy().sum(),
                               link_loads(paths, live, adj.shape[0]).sum(), rtol=1e-4)


# -- the balancer and the step ---------------------------------------------


def _graft_problem(v_axis):
    import __graft_entry__ as g

    t, base, src, dst, weight = g._example_problem(pad_multiple=8 * v_axis)
    pad = (-len(src)) % N_VIRTUAL_DEVICES
    src = np.concatenate([src, np.full(pad, -1, np.int32)])
    dst = np.concatenate([dst, np.full(pad, -1, np.int32)])
    weight = np.concatenate([weight, np.zeros(pad, np.float32)])
    return t, base, src, dst, weight


@pytest.mark.parametrize("leg", ["route_flows_sharded", "multichip_route_step"])
def test_balancer_and_step_match_the_reference(leg, virtual_mesh, p_mesh):
    t, base, src, dst, weight = _graft_problem(virtual_mesh.shape["v"])
    adj = np.asarray(t.adj)
    max_len = 6
    kw = dict(chunk=16)
    if leg == "route_flows_sharded":
        dist = np.asarray(j_apsp(t.adj))
        want = jshard.route_flows_sharded(
            t.adj, jnp.asarray(dist), jnp.asarray(base), jnp.asarray(src),
            jnp.asarray(dst), jnp.asarray(weight), virtual_mesh, max_len,
            max_degree=t.max_degree, **kw)
        got = pshard.route_flows_sharded(
            t_(adj), shard_rows(dist, p_mesh), t_(base), t_(src), t_(dst),
            t_(weight), p_mesh, max_len, **kw)
    else:
        want = jshard.multichip_route_step(
            t.adj, jnp.asarray(base), jnp.asarray(src), jnp.asarray(dst),
            jnp.asarray(weight), virtual_mesh, max_len, max_degree=t.max_degree,
            **kw)
        got = pshard.multichip_route_step(
            t_(adj), t_(base), t_(src), t_(dst), t_(weight), p_mesh, max_len, **kw)
    nodes = cat(got[0])
    np.testing.assert_array_equal(nodes, np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)
    n = int((src >= 0).sum())
    assert (nodes[:n, 0] == src[:n]).all() and (nodes[n:] == -1).all()


# -- packed readback --------------------------------------------------------


def test_window_readback_is_independent_of_padded_v():
    """A sharded window reaps the same bytes at V = 24 and V = 512 (no
    occupancy bucket), as the reference's, and far under an [F, V]
    gather; the count is the reference's on the same window."""
    sizes = {}
    for pad in (8, 512):
        jdb = fattree(4).to_topology_db(backend="jax", pad_multiple=pad)
        pdb = topology_from_dict(jdb.to_dict(), device="cpu", pad_multiple=pad,
                                 mesh_devices=N_VIRTUAL_DEVICES, shard_oracle=True)
        oracle = pdb._oracle_engine()
        oracle.host_chase_hop_budget = 0
        oracle.occ_bucket_multiple = 0
        macs = sorted(pdb.hosts)[:12]
        pairs = [(a, b) for a in macs for b in macs if a != b]
        wr = pdb.find_routes_batch_dispatch(pairs).reap()
        assert (wr.hop_len > 0).all() and oracle._tensors.v >= pad
        nbytes = pshard.window_readback_nbytes(wr)
        assert nbytes <= len(pairs) * (wr.hop_dpid.shape[1] * 12 + 4)
        assert nbytes == jshard.window_readback_nbytes(wr)
        sizes[pad] = nbytes
    assert sizes[8] == sizes[512]
    assert sizes[512] < len(pairs) * 512 * 4


# -- the engine ---------------------------------------------------------------


@pytest.fixture
def jit_reference(monkeypatch):
    """The reference engine's sharded UGAL calls, jitted (the same
    program; see :func:`j_route_adaptive_sharded`)."""
    monkeypatch.setattr(jshard, "route_adaptive_sharded", j_route_adaptive_sharded)


def _dbs(ring: bool, spec=None):
    """The reference's and the port's TopologyDB on fat-tree k=4 with an
    8-shard mesh and ``shard_oracle``; both device chases forced."""
    jdb = (spec or fattree(4)).to_topology_db(backend="jax", pad_multiple=8)
    jdb.mesh_devices = N_VIRTUAL_DEVICES
    jdb.shard_oracle = True
    jdb.ring_exchange = ring
    pdb = topology_from_dict(jdb.to_dict(), device="cpu",
                             mesh_devices=N_VIRTUAL_DEVICES, shard_oracle=True,
                             ring_exchange=ring)
    for o in (jdb._jax_oracle(), pdb._oracle_engine()):
        o.host_chase_hop_budget = 0
    return jdb, pdb


def _window(wr):
    touched = None if wr.touched is None else wr.touched.tolist()
    return wr.hop_dpid.tolist(), wr.hop_port.tolist(), wr.hop_len.tolist(), touched


def _coll(c):
    """A collective's routes, or a phased program's phases, as values."""
    if hasattr(c, "phases"):
        return (c.n_phases, c.pair_phase.tolist(), c.phase_congestion(),
                [(p.phase, p.pair_idx.tolist(), _coll(p.reap())) for p in c.phases])
    return (c.pair_sub.tolist(), c.hop_dpid.tolist(), c.hop_port.tolist(),
            c.hop_len.tolist(), c.max_congestion, c.n_detours)


@pytest.mark.parametrize("ring", [False, True])
def test_engine_sharded_entry_points_match_the_reference(ring, jit_reference):
    jdb, pdb = _dbs(ring)
    macs = sorted(jdb.hosts)
    pairs = [(a, b) for a in macs[:10] for b in macs[:10] if a != b]
    assert pdb.find_routes_batch(pairs) == jdb.find_routes_batch(pairs)
    assert _window(pdb.find_routes_batch_dispatch(pairs).reap()) == _window(
        jdb.find_routes_batch_dispatch(pairs).reap())
    got, want = pdb.warm_serving(), jdb.warm_serving()
    assert (got["shapes"], got["max_len"]) == (want["shapes"], want["max_len"])
    assert got["shapes"] == [8, 256]
    assert pdb.find_routes_batch_adaptive(pairs) == jdb.find_routes_batch_adaptive(pairs)
    n = len(macs)
    src, dst = np.arange(n), np.roll(np.arange(n), 3)
    for kw in (dict(policy="shortest"), dict(policy="adaptive"),
               dict(policy="adaptive", schedule=2)):
        assert _coll(pdb.find_routes_collective(macs, src, dst, **kw)) == _coll(
            jdb.find_routes_collective(macs, src, dst, **kw)), kw
    # a flap: both oracles recompute, then the narrowed re-route of the
    # flapped link's switches runs the sharded chase with the touched rows
    from sdnmpi_tpu.core.topology_db import Link as JLink, Port as JPort
    from sdnmpi_tpu_torch.core.topology_db import Link, Port

    link = next(iter(jdb.links[min(jdb.links)].values()))
    a, pa, b, pb = link.src.dpid, link.src.port_no, link.dst.dpid, link.dst.port_no
    jdb.delete_link(JLink(JPort(a, pa), JPort(b, pb)))
    pdb.delete_link(Link(Port(a, pa), Port(b, pb)))
    big = pairs * 3
    assert _window(pdb.find_routes_batch_delta_dispatch(big, [a, b]).reap()) == _window(
        jdb.find_routes_batch_delta_dispatch(big, [a, b]).reap())


def test_mesh_only_adaptive_and_next_hop_cache_match(jit_reference):
    """Without ``shard_oracle`` the adaptive legs still run the sharded
    UGAL program; the shortest collective on row-sharded next hops
    gathers them once per topology version."""
    jdb = fattree(4).to_topology_db(backend="jax", pad_multiple=8)
    jdb.mesh_devices = N_VIRTUAL_DEVICES
    pdb = topology_from_dict(jdb.to_dict(), device="cpu",
                             mesh_devices=N_VIRTUAL_DEVICES)
    macs = sorted(jdb.hosts)
    pairs = [(a, b) for a in macs[:8] for b in macs[:8] if a != b]
    assert pdb.find_routes_batch_adaptive(pairs) == jdb.find_routes_batch_adaptive(pairs)
    _, sdb = _dbs(False)
    calls = []
    gather = ring.ring_all_gather
    try:
        ring.ring_all_gather = lambda b, m: calls.append(1) or gather(b, m)
        n = len(macs)
        for _ in range(2):
            sdb.find_routes_collective(macs, np.arange(n), np.roll(np.arange(n), 1),
                                       policy="shortest")
    finally:
        ring.ring_all_gather = gather
    assert len(calls) == 1


def _ctl_scenario(S, budget_zero):
    from tests.test_torch_control import build, ip_packet, launch_all, send_vmac, state

    def fat(S_, **kw):
        return S_.topogen.fattree(4).to_fabric(wire=True)

    fabric, ctl, events = build(
        S, fat, shard_oracle=True, mesh_devices=N_VIRTUAL_DEVICES,
        block_install_threshold=1, collective_policy="shortest",
        coalesce_routes=True,
    )
    db = ctl.topology_manager.topologydb
    macs = sorted(fabric.hosts)[:8]
    launch_all(S, fabric, macs)
    send_vmac(S, fabric, macs[0], "ALLTOALL", 0, 1)
    if budget_zero:
        (db._jax_oracle() if hasattr(db, "_jax_oracle") else
         db._oracle_engine()).host_chase_hop_budget = 0
    hosts = sorted(fabric.hosts)
    for a in hosts:
        for b in hosts[:6]:
            if a != b:
                fabric.hosts[a].send(ip_packet(S, a, b))
    fabric.tick(1.0)
    return state(fabric, ctl, events)


def test_controller_on_the_shard_oracle_matches_the_reference(jit_reference):
    """A wire fat-tree Controller on the 8-shard oracle: the shortest
    block install (through ``_next_full``) and the coalesced packet-in
    windows on the device chase give the reference's flow tables, blocks
    and bus events."""
    from tests.test_torch_control import PORT, REF

    ref, got = _ctl_scenario(REF, True), _ctl_scenario(PORT, True)
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key] == ref[key], key
    assert ref["collectives"] and any(ref["tables"].values())


# -- telemetry ----------------------------------------------------------------


SHARD_INSTRUMENTS = ("shard_dispatch_seconds", "shard_reap_seconds",
                     "shard_exchange_overlap_gain", "shard_occupancy_imbalance")


def _pkg(ref, name):
    return importlib.import_module(("sdnmpi_tpu." if ref else "sdnmpi_tpu_torch.") + name)


@pytest.mark.parametrize("ring", [False, True])
def test_shard_instruments_and_spans_match_the_reference(ring):
    """The four instruments exist under the reference's name, kind and
    help; a sharded window under a ``route_window`` span feeds them as
    the reference's does and opens ``shard_dispatch`` under it (and
    ``shard_exchange`` under that on the ring)."""
    rows = {ref: {r["name"]: r for r in _pkg(ref, "api.telemetry").instrument_rows()}
            for ref in (True, False)}
    for name in SHARD_INSTRUMENTS:
        assert rows[False][name] == rows[True][name]
    jdb, pdb = _dbs(ring)
    macs = sorted(jdb.hosts)
    pairs = [(a, b) for a in macs[:10] for b in macs[:10] if a != b]
    seen = {}
    for ref, db in ((True, jdb), (False, pdb)):
        reg = _pkg(ref, "utils.metrics").REGISTRY
        tracing = _pkg(ref, "utils.tracing")
        before = {n: reg.histogram(n).count for n in SHARD_INSTRUMENTS[:2]}
        records = []
        tracing.add_trace_sink(records.append)
        try:
            parent = tracing.start_span("route_window", n_pairs=len(pairs))
            db.find_routes_batch_dispatch(pairs).reap()
            parent.end()
        finally:
            tracing.remove_trace_sink(records.append)
        spans = {r["name"]: r for r in records if r.get("kind") == "span"}
        assert spans["shard_dispatch"]["parent"] == spans["route_window"]["span"]
        assert ("shard_exchange" in spans) == ring
        if ring:
            assert spans["shard_exchange"]["parent"] == spans["shard_dispatch"]["span"]
        seen[ref] = (
            {n: reg.histogram(n).count - before[n] for n in before},
            reg.get("shard_occupancy_imbalance").value,
            _pkg(ref, "oracle.engine").note_exchange_overlap(3.0, 2.0),
            {k: v for k, v in spans["shard_dispatch"].items()
             if k in ("mesh_devices", "n_flows")},
            {k: v for k, v in spans.get("shard_exchange", {}).items()
             if k in ("exchange_bytes", "mesh_devices", "ring")},
        )
    assert seen[False] == seen[True]
    assert seen[True][0] == {"shard_dispatch_seconds": 1, "shard_reap_seconds": 1}
    assert seen[True][1] == 96 / 90 and seen[True][2] == 1.5

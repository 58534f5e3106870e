"""The port's incremental APSP repair against the JAX package's.

The same seeded storms of link removals, restores, rewires and
structural breaks go to a TopologyDB of each package (the port's on the
CPU). After every refresh the port's repaired distances and next hops,
its adjacency and port tensors, their host twins, the sorted-neighbour
cache and the compact neighbour table must be equal, bit for bit, to
the reference's repaired state and to a full recompute of the port; the
repair and full-refresh counts must be the reference's. The cases are
those of ``tests/test_incremental.py``, plus the hazards that are the
port's own: the per-version neighbour table ``TopoTensors.neigh`` that
K1, K2 and the greedy scanner walk, and scatters of padded index sets.
"""

import numpy as np
import pytest
import torch

from sdnmpi_tpu import topogen as j_topogen
from sdnmpi_tpu.core import topology_db as j_tdb
from sdnmpi_tpu_torch import topogen as p_topogen
from sdnmpi_tpu_torch.core import topology_db as p_tdb
from sdnmpi_tpu_torch.oracle.engine import RouteOracle

SPECS = {
    "linear8": ("linear", (8,)),
    "fattree4": ("fattree", (4,)),
    "torus3x3": ("torus2d", (3, 3)),
    "dragonfly3x4": ("dragonfly", (3, 4)),
}


def _pair(name):
    """The same fabric as a reference DB (backend jax) and a port DB
    (torch on the CPU)."""
    fn, args = SPECS[name]
    ref = getattr(j_topogen, fn)(*args).to_topology_db(backend="jax")
    got = getattr(p_topogen, fn)(*args).to_topology_db(backend="torch", device="cpu")
    return ref, got


def _fresh(db):
    """The port's full-recompute oracle of ``db``'s current state."""
    full = RouteOracle(db.pad_multiple, db.max_diameter, device="cpu")
    full.delta_repair_threshold = 0
    full.refresh(db)
    return full


def _cables(db):
    return [(a, b) for a in sorted(db.links) for b in sorted(db.links[a]) if a < b]


def _delete(db, tdb, cable):
    a, b = cable
    for x, y in ((a, b), (b, a)):
        lk = db.links[x][y]
        db.delete_link(tdb.Link(tdb.Port(x, lk.src.port_no), tdb.Port(y, lk.dst.port_no)))


def _restore(db, tdb, cable, ports):
    (a, b), (pa, pb) = cable, ports
    db.add_link(tdb.Link(tdb.Port(a, pa), tdb.Port(b, pb)))
    db.add_link(tdb.Link(tdb.Port(b, pb), tdb.Port(a, pa)))


def _rewire(db, tdb, cable):
    a, b = cable
    lk = db.links[a][b]
    db.add_link(tdb.Link(tdb.Port(a, lk.src.port_no + 10), tdb.Port(b, lk.dst.port_no)))


def _assert_state(oracle, ref_oracle, db):
    """The port's repaired state equals the reference's and a full
    recompute's, bit for bit."""
    full = _fresh(db)
    np.testing.assert_array_equal(oracle._dist_d.numpy(), np.asarray(ref_oracle._dist_d))
    np.testing.assert_array_equal(oracle._next_d.numpy(), np.asarray(ref_oracle._next_d))
    np.testing.assert_array_equal(oracle._dist_d.numpy(), full._dist_d.numpy())
    np.testing.assert_array_equal(oracle._next_d.numpy(), full._next_d.numpy())
    t, tf = oracle._tensors, full._tensors
    np.testing.assert_array_equal(t.adj.numpy(), tf.adj.numpy())
    np.testing.assert_array_equal(t.port.numpy(), tf.port.numpy())
    np.testing.assert_array_equal(t.host_adj(), tf.host_adj())
    np.testing.assert_array_equal(t.host_port(), tf.host_port())
    np.testing.assert_array_equal(t.host_port(), ref_oracle._tensors.host_port())
    np.testing.assert_array_equal(oracle._order, full._order)
    np.testing.assert_array_equal(oracle._order, ref_oracle._order)
    np.testing.assert_array_equal(t.neigh.numpy(), tf.neigh.numpy())
    assert oracle._port is t.port_host
    assert t.link_count() == tf.link_count() == int((t.host_adj() > 0).sum())


def _storm(ref, got, seed, steps, ops=3, check=None):
    """A seeded storm of deletes, restores and rewires, the same on both
    DBs; ``check`` runs after each step's refreshes."""
    rng = np.random.default_rng(seed)
    down: list = []
    for step in range(steps):
        op = int(rng.integers(ops))
        cables = _cables(got)
        if op == 0 or (op == 1 and not down):
            cable = cables[int(rng.integers(len(cables)))]
            ports = (got.links[cable[0]][cable[1]].src.port_no,
                     got.links[cable[1]][cable[0]].src.port_no)
            _delete(ref, j_tdb, cable)
            _delete(got, p_tdb, cable)
            down.append((cable, ports))
        elif op == 1:
            cable, ports = down.pop(int(rng.integers(len(down))))
            _restore(ref, j_tdb, cable, ports)
            _restore(got, p_tdb, cable, ports)
        else:
            cable = cables[int(rng.integers(len(cables)))]
            _rewire(ref, j_tdb, cable)
            _rewire(got, p_tdb, cable)
        check(step)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_random_delta_sequence_matches_reference(name, seed):
    """Randomized add/remove/rewire storms (linear cuts partition the
    graph, so unreachable pairs are covered): every repaired tensor
    equals the reference's and a full recompute, and both packages stay
    on the repair path."""
    ref, got = _pair(name)
    j_oracle, p_oracle = ref._jax_oracle(), got._oracle_engine()
    j_oracle.refresh(ref)
    p_oracle.refresh(got)

    def check(step):
        j_oracle.refresh(ref)
        p_oracle.refresh(got)
        _assert_state(p_oracle, j_oracle, got)
        assert p_oracle.repair_count == j_oracle.repair_count, step

    _storm(ref, got, seed, 16, check=check)
    assert p_oracle.full_refresh_count == j_oracle.full_refresh_count == 1
    assert p_oracle.repair_count > 0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["linear8", "fattree4", "torus3x3"])
def test_repair_patches_host_twins_in_place(name, seed):
    """Materialized host twins survive the repair: only the dirty
    columns and the delta's row are patched, and the twins equal a fresh
    download and the reference's patched twins bit for bit."""
    ref, got = _pair(name)
    j_oracle, p_oracle = ref._jax_oracle(), got._oracle_engine()
    for o, db in ((j_oracle, ref), (p_oracle, got)):
        o.refresh(db)
        assert o._dist is not None and o._next is not None
    dist_id, next_id = id(p_oracle._dist_h), id(p_oracle._next_h)

    def check(step):
        j_oracle.refresh(ref)
        p_oracle.refresh(got)
        # patched, not replaced
        assert (id(p_oracle._dist_h), id(p_oracle._next_h)) == (dist_id, next_id)
        np.testing.assert_array_equal(p_oracle._dist_h, p_oracle._dist_d.numpy())
        np.testing.assert_array_equal(p_oracle._next_h, p_oracle._next_d.numpy())
        np.testing.assert_array_equal(p_oracle._dist_h, j_oracle._dist_h)
        np.testing.assert_array_equal(p_oracle._next_h, j_oracle._next_h)

    _storm(ref, got, seed, 8, ops=2, check=check)
    _assert_state(p_oracle, j_oracle, got)
    assert p_oracle.full_refresh_count == 1


def test_unmaterialized_twins_stay_lazy_through_repair():
    _, got = _pair("fattree4")
    oracle = got._oracle_engine()
    oracle.refresh(got)
    assert oracle._dist_h is None and oracle._next_h is None
    _delete(got, p_tdb, _cables(got)[1])
    oracle.refresh(got)
    assert oracle.repair_count == 2
    assert oracle._dist_h is None and oracle._next_h is None


@pytest.mark.parametrize("name", ["linear8", "fattree4"])
def test_seeded_delta_replay_stress(name):
    """One long-lived oracle absorbs 40 seeded delete/restore deltas;
    after every repair the distances equal a full recompute."""
    _, got = _pair(name)
    oracle = got._oracle_engine()
    oracle.refresh(got)
    rng = np.random.default_rng(0xC0FFEE)
    down: list = []
    for step in range(40):
        cables = _cables(got)
        if down and (not cables or rng.integers(2)):
            cable, ports = down.pop(int(rng.integers(len(down))))
            _restore(got, p_tdb, cable, ports)
        else:
            cable = cables[int(rng.integers(len(cables)))]
            ports = (got.links[cable[0]][cable[1]].src.port_no,
                     got.links[cable[1]][cable[0]].src.port_no)
            _delete(got, p_tdb, cable)
            down.append((cable, ports))
        oracle.refresh(got)
        np.testing.assert_array_equal(
            oracle._dist_d.numpy(), _fresh(got)._dist_d.numpy(),
            err_msg=f"step {step}, {len(down)} cables down",
        )
    assert oracle.full_refresh_count == 1 and oracle.repair_count >= 40


def test_routes_stay_correct_through_repairs():
    """find_route on repaired tensors answers as the reference and the
    port's pure-Python backend do, after every delta."""
    ref, got = _pair("fattree4")
    py = p_topogen.fattree(4).to_topology_db(backend="py")
    macs = sorted(got.hosts)
    pairs = [(macs[0], macs[-1]), (macs[1], macs[2]), (macs[5], macs[11])]
    rng = np.random.default_rng(3)
    removed = None
    for _ in range(8):
        if removed is None:
            cables = _cables(got)
            cable = cables[int(rng.integers(len(cables)))]
            removed = (cable, (got.links[cable[0]][cable[1]].src.port_no,
                               got.links[cable[1]][cable[0]].src.port_no))
            for db, tdb in ((ref, j_tdb), (got, p_tdb), (py, p_tdb)):
                _delete(db, tdb, cable)
        else:
            for db, tdb in ((ref, j_tdb), (got, p_tdb), (py, p_tdb)):
                _restore(db, tdb, *removed)
            removed = None
        for s, d in pairs:
            want = ref.find_route(s, d)
            assert got.find_route(s, d) == want == py.find_route(s, d)
    assert got._oracle_engine().full_refresh_count == 1


@pytest.mark.parametrize("case", ["threshold", "structural", "unknown", "overflow"])
def test_fallbacks_match_reference(case):
    """The reference's fallbacks to a full recompute: past the delta
    threshold, after a structural break of the log, for an endpoint the
    tensors never indexed, and after a log overflow. The counts are the
    reference's and the state is a full recompute's."""
    name = "fattree4" if case == "threshold" else "linear8"
    ref, got = _pair(name)
    j_oracle, p_oracle = ref._jax_oracle(), got._oracle_engine()
    if case == "threshold":
        j_oracle.delta_repair_threshold = p_oracle.delta_repair_threshold = 2
    j_oracle.refresh(ref)
    p_oracle.refresh(got)
    for db, tdb in ((ref, j_tdb), (got, p_tdb)):
        if case == "threshold":
            for cable in _cables(db)[:3]:  # six link deltas > 2
                _delete(db, tdb, cable)
        elif case == "structural":
            sw = db.switches[1]
            v0 = db.version
            db.delete_switch(sw)
            assert db.deltas_since(v0) is None
            db.add_switch(sw)
        elif case == "unknown":
            db.add_switch(tdb.Switch.make(99))
            db.add_link(tdb.Link(tdb.Port(99, 2), tdb.Port(1, 9)))
            db.add_link(tdb.Link(tdb.Port(1, 9), tdb.Port(99, 2)))
        else:
            cable = _cables(db)[0]
            ports = (db.links[cable[0]][cable[1]].src.port_no,
                     db.links[cable[1]][cable[0]].src.port_no)
            for _ in range(40):
                _delete(db, tdb, cable)
                _restore(db, tdb, cable, ports)
    j_oracle.refresh(ref)
    p_oracle.refresh(got)
    assert (p_oracle.repair_count, p_oracle.full_refresh_count) == (
        j_oracle.repair_count, j_oracle.full_refresh_count)
    assert p_oracle.full_refresh_count == 2
    _assert_state(p_oracle, j_oracle, got)


def test_host_delta_repairs_in_place_and_clears_memo():
    """A host added or moved on an indexed switch is a memo-only delta:
    no recompute, and no stale endpoint resolution."""
    _, got = _pair("linear8")
    oracle = got._oracle_engine()
    macs = sorted(got.hosts)
    assert got.find_route(macs[0], macs[1])
    new_mac = "02:00:00:00:00:aa"
    got.add_host(p_tdb.Host(new_mac, p_tdb.Port(3, 7)))
    route = got.find_route(macs[0], new_mac)
    assert route and route[-1] == (3, 7)
    got.add_host(p_tdb.Host(new_mac, p_tdb.Port(2, 7)))
    route = got.find_route(macs[0], new_mac)
    assert route and route[-1] == (2, 7)
    assert oracle.full_refresh_count == 1


@pytest.mark.parametrize("knob", ["max_diameter", "mesh", "db_threshold_0"])
def test_repair_exclusions(knob):
    """No repair under a distance cap, with a shard mesh, or with the
    TopologyDB's ``delta_repair_threshold`` at 0 (passed to the oracle):
    each refresh recomputes in full."""
    spec = p_topogen.fattree(4)
    kw = {"max_diameter": 8} if knob == "max_diameter" else (
        {"mesh_devices": 2, "shard_oracle": True} if knob == "mesh"
        else {"delta_repair_threshold": 0})
    db = spec.to_topology_db(backend="torch", device="cpu", **kw)
    oracle = db._oracle_engine()
    oracle.refresh(db)
    _delete(db, p_tdb, _cables(db)[2])
    oracle.refresh(db)
    assert (oracle.repair_count, oracle.full_refresh_count) == (0, 2)


def test_repair_preserves_downstream_query_paths():
    """Pair batches after a repair equal a fresh DB's, and the restore
    gives back the routes of before."""
    ref, got = _pair("fattree4")
    macs = sorted(got.hosts)
    pairs = [(a, b) for a in macs[:4] for b in macs[4:8] if a != b]
    before = got.find_routes_batch(pairs)
    cable = _cables(got)[2]
    ports = (got.links[cable[0]][cable[1]].src.port_no,
             got.links[cable[1]][cable[0]].src.port_no)
    _delete(got, p_tdb, cable)
    _delete(ref, j_tdb, cable)
    repaired = got.find_routes_batch(pairs)
    assert repaired == ref.find_routes_batch(pairs)
    fresh = p_topogen.fattree(4).to_topology_db(backend="torch", device="cpu")
    _delete(fresh, p_tdb, cable)
    assert repaired == fresh.find_routes_batch(pairs)
    assert got._oracle_engine().full_refresh_count == 1
    _restore(got, p_tdb, cable, ports)
    assert got.find_routes_batch(pairs) == before


def test_repair_span_and_counters():
    """The ``oracle_repair`` span, ``repair_count`` and the
    ``oracle_repairs_total`` metric count the absorbed link deltas."""
    from sdnmpi_tpu_torch.utils.metrics import REGISTRY
    from sdnmpi_tpu_torch.utils.tracing import STATS

    _, got = _pair("fattree4")
    oracle = got._oracle_engine()
    oracle.refresh(got)
    n_spans = len(STATS.samples["oracle_repair"])
    before = REGISTRY.get("oracle_repairs_total").value
    _delete(got, p_tdb, _cables(got)[0])
    oracle.refresh(got)
    assert oracle.repair_count == 2
    assert len(STATS.samples["oracle_repair"]) == n_spans + 1
    assert REGISTRY.get("oracle_repairs_total").value == before + 2


# -- the port's own hazards ---------------------------------------------------


@pytest.mark.parametrize("policy", ["balanced", "adaptive"])
def test_neighbor_table_stays_current(policy):
    """K2 (its plain version here) and the UGAL program walk
    ``TopoTensors.neigh``: a collective routed after a removal and after
    an add, on the repaired oracle, equals the one a full refresh
    routes; a stale table would sample over the removed link."""
    from sdnmpi_tpu_torch.collectives import alltoall_pairs

    _, got = _pair("fattree4")
    macs = sorted(got.hosts)
    pairs = alltoall_pairs(len(macs))
    oracle = got._oracle_engine()
    oracle.refresh(got)
    cable = _cables(got)[3]
    ports = (got.links[cable[0]][cable[1]].src.port_no,
             got.links[cable[1]][cable[0]].src.port_no)
    for step in ("remove", "add"):
        if step == "remove":
            _delete(got, p_tdb, cable)
        else:
            _restore(got, p_tdb, cable, ports)
        routes = oracle.routes_collective(got, macs, pairs[:, 0], pairs[:, 1], policy)
        full = _fresh(got)
        np.testing.assert_array_equal(oracle._tensors.neigh.numpy(),
                                      full._tensors.neigh.numpy())
        want = full.routes_collective(got, macs, pairs[:, 0], pairs[:, 1], policy)
        for f in ("pair_sub", "hop_dpid", "hop_port", "hop_len"):
            np.testing.assert_array_equal(getattr(routes, f), getattr(want, f))
        if step == "remove":
            a, b = cable
            hops = routes.hop_dpid
            assert not ((hops[:, :-1] == a) & (hops[:, 1:] == b)).any()
    assert oracle.full_refresh_count == 1 and oracle.repair_count == 4


def test_padded_index_sets_never_scatter_their_pads():
    """The dirty-column and sample index sets are bucket-padded with an
    out-of-range sentinel. On the CPU an out-of-range ``index_put_``
    raises (on the card it is a device-side assert), so the repair's
    scatters must write the real entries only; the results equal the
    unpadded computation."""
    from sdnmpi_tpu_torch.kernels.tiling import bucket_pad, col_bucket
    from sdnmpi_tpu_torch.oracle import incremental
    from sdnmpi_tpu_torch.oracle.apsp import nexthop_cols

    _, got = _pair("fattree4")
    oracle = got._oracle_engine()
    t = oracle.refresh(got)
    v = t.v
    with pytest.raises(IndexError):
        torch.zeros(v)[torch.tensor([v])] = 1.0
    cols = np.array([1, 4, 6], np.int32)
    padded = bucket_pad(cols, v, v)[0]
    assert len(padded) == col_bucket(3, v) == 8 and (padded[3:] == v).all()
    nxt = oracle._next_d.clone()
    nxt[:, cols] = -7
    out = nexthop_cols(t.adj, oracle._dist_d, nxt, padded, t.max_degree)
    np.testing.assert_array_equal(out.numpy(), oracle._next_d.numpy())
    dist, changed = incremental._remove_repair(t.adj, oracle._dist_d, padded)
    np.testing.assert_array_equal(dist.numpy(), oracle._dist_d.numpy())
    assert not changed[:3].any()


def test_host_twins_are_owned_arrays():
    """``apply_repairs`` patches the stored host twins: when a
    TopoTensors was built without them, the repair first makes owned
    copies (never views of the device tensors), and every later reader
    sees the patched ones."""
    from sdnmpi_tpu_torch.oracle import incremental
    from sdnmpi_tpu_torch.oracle.engine import TopoTensors

    _, got = _pair("fattree4")
    oracle = got._oracle_engine()
    t0 = oracle.refresh(got)
    t = TopoTensors(t0.dpids, t0.index, t0.adj.clone(), t0.port.clone(),
                    t0.n_real, t0.max_degree)
    assert t.adj_host is None and t.port_host is None
    a, b = t.index[_cables(got)[0][0]], t.index[_cables(got)[0][1]]
    incremental.apply_repairs(t, oracle._dist_d, oracle._next_d, None,
                              [("remove", a, b, -1)])
    assert t.adj_host is not None and t.host_adj() is t.adj_host
    assert t.adj_host[a, b] == 0 and t.port_host[a, b] == -1
    assert not np.shares_memory(t.adj_host, t.adj.numpy())
    np.testing.assert_array_equal(t.adj_host, t.adj.numpy())
    np.testing.assert_array_equal(t.port_host, t.port.numpy())


def test_device_tensors_never_alias_host_twins():
    """tensorize copies: poking a host twin, as a repair does, never
    shows through to the device tensors."""
    from sdnmpi_tpu_torch.oracle.engine import tensorize

    _, got = _pair("fattree4")
    t = tensorize(got, device="cpu")
    for host, dev in ((t.adj_host, t.adj), (t.port_host, t.port)):
        before = dev[0, 1].item()
        host[0, 1] = before + 7
        assert dev[0, 1].item() == before
        host[0, 1] = before


def test_nexthop_cols_matches_reference():
    """``apsp.nexthop_cols`` against the reference's, on the same
    distances with every column of a bucket dirtied."""
    import jax.numpy as jnp

    from sdnmpi_tpu.oracle.apsp import nexthop_cols as j_cols
    from sdnmpi_tpu_torch.oracle.apsp import nexthop_cols as p_cols

    ref, got = _pair("torus3x3")
    j_oracle, p_oracle = ref._jax_oracle(), got._oracle_engine()
    jt, pt = j_oracle.refresh(ref), p_oracle.refresh(got)
    cols = np.array([0, 2, 3, 5, 7, 100, 100, 100], np.int32)
    cols[5:] = pt.v
    j_base = jnp.zeros_like(j_oracle._next_d)
    want = np.asarray(j_cols(jt.adj, j_oracle._dist_d, j_base, jnp.asarray(cols),
                             jt.max_degree))
    got_n = p_cols(pt.adj, p_oracle._dist_d, torch.zeros_like(p_oracle._next_d),
                   cols, pt.max_degree)
    np.testing.assert_array_equal(got_n.numpy(), want)


def test_route_cache_never_serves_a_pre_flap_window():
    """A repair moves the oracle's version without a full refresh; the
    route cache, invalidated through the delta log, must still never
    serve a window routed before the flap: every hit equals a miss on a
    cacheless DB of the same state."""
    spec = p_topogen.fattree(4)
    got = spec.to_topology_db(backend="torch", device="cpu", route_cache=True)
    plain = spec.to_topology_db(backend="torch", device="cpu")
    macs = sorted(got.hosts)
    pairs = [(macs[i], macs[(i + 5) % len(macs)]) for i in range(len(macs))]
    for db in (got, plain):
        db.find_routes_batch_dispatch(pairs).reap()
    cable = None
    for cand in _cables(got):
        a, b = cand
        if any(any(dp == a for dp, _ in fdb) and any(dp == b for dp, _ in fdb)
               for fdb in plain.find_routes_batch(pairs)):
            cable = cand
            break
    ports = (got.links[cable[0]][cable[1]].src.port_no,
             got.links[cable[1]][cable[0]].src.port_no)
    for step in ("remove", "add"):
        for db in (got, plain):
            if step == "remove":
                _delete(db, p_tdb, cable)
            else:
                _restore(db, p_tdb, cable, ports)
        for _ in range(2):  # a miss, then a hit
            hit = got.find_routes_batch_dispatch(pairs).reap().fdbs()
            assert hit == plain.find_routes_batch_dispatch(pairs).reap().fdbs()
    assert got._oracle_engine().repair_count == 4
    assert got._oracle_engine().full_refresh_count == 1

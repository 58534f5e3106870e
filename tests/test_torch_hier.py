"""The port's hierarchical two-level oracle against the JAX package's.

Each module of the slice is held against the reference on the same
seeded inputs on the CPU: the pod-stack APSP (``shardplane/hier.py``,
also split over an 8-shard mesh, a stack whose column chunk is below
its pod size, and pod counts below and off the shard count), the row
sweeps (the port's device executor and its host executor against the
reference's ``sweep_rows_host``), the fused composition
(``kernels/hiercompose.py``, with ties, steered and unsteered), the
batched hop arrays (``oracle/hierpath.py``) and the ring-exchanged
border plane (kernel K3's plain version on the CPU). Then the whole
oracle (``oracle/hier.py``) through ``TopologyDB(hier_oracle=True)``:
windows, balanced and adaptive pair batches, collectives and phased
programs (fdbs and congestion equal to the reference's on ``fattree(8)``
and on ``torus((4, 4))``, which takes the partitioner), churn (the same
block repairs and builds), the delta-narrowed leg, the route cache, the
warm ladder, the border-cache counters, border snapshots across the
packages, the Controller's fence against the dense oracle and its
restart round-trip, and the 8-shard mesh with the ring bit-equal to one
device. The reference runs on one device: its mesh path does not run on
the installed JAX (ROADMAP C).
"""

from __future__ import annotations

import json
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdnmpi_tpu import topogen as J
from sdnmpi_tpu.kernels import hiercompose as j_compose
from sdnmpi_tpu.oracle import hier as j_hier
from sdnmpi_tpu.oracle import hierpath as j_hierpath
from sdnmpi_tpu.shardplane import hier as j_shier
from sdnmpi_tpu_torch import topogen as P
from sdnmpi_tpu_torch.kernels import hiercompose as p_compose
from sdnmpi_tpu_torch.oracle import hier as p_hier
from sdnmpi_tpu_torch.oracle import hierpath as p_hierpath
from sdnmpi_tpu_torch.shardplane import hier as p_shier
from sdnmpi_tpu_torch.shardplane.mesh import make_mesh

TOPOS = {
    "fattree4": lambda T: T.fattree(4),
    "fattree4p6": lambda T: T.fattree(4, pods=6),
    "fattree8": lambda T: T.fattree(8),
    "torus4x4": lambda T: T.torus((4, 4)),
    "dragonfly": lambda T: T.dragonfly(3, 4, 1, 2),
}


def _dbs(topo: str, **kw):
    """(reference db, port db) of one fabric under the hier oracle."""
    mk = TOPOS[topo]
    return (
        mk(J).to_topology_db(backend="jax", hier_oracle=True, **kw),
        mk(P).to_topology_db(device="cpu", hier_oracle=True, **kw),
    )


def _pairs(db, n=10):
    hosts = sorted(db.hosts)[:n]
    return [(a, b) for a in hosts for b in hosts if a != b]


def _link(S, a, pa, b, pb, add: bool, *dbs):
    mod = __import__(f"{S}.core.topology_db", fromlist=["Link", "Port"])
    for db in dbs:
        for x, px, y, py in ((a, pa, b, pb), (b, pb, a, pa)):
            link = mod.Link(mod.Port(x, px), mod.Port(y, py))
            (db.add_link if add else db.delete_link)(link)


def _flip(ref, got, cable, add: bool):
    _link("sdnmpi_tpu", *cable, add, ref)
    _link("sdnmpi_tpu_torch", *cable, add, got)


def _stack(rng, n, s, p=0.08):
    """A seeded stack of n symmetric pod adjacencies of size s, with a
    few isolated members (inf distances, -1 next hops)."""
    a = (rng.random((n, s, s)) < p).astype(np.float32)
    a = np.maximum(a, a.transpose(0, 2, 1))
    a[:, np.arange(s), np.arange(s)] = 0
    a[:, :, -1] = a[:, -1, :] = 0  # the last member of every pod is cut off
    return a


# -- level 1: the pod-stack APSP -----------------------------------------


@pytest.mark.parametrize("n,s", [(5, 16), (9, 256), (3, 64), (12, 8)],
                         ids=["small", "col-chunk-below-s", "fewer-pods-than-shards",
                              "pods-off-the-shard-count"])
def test_pod_stack_apsp_matches_the_reference(n, s):
    adj = _stack(np.random.default_rng(n * 1000 + s), n, s)
    if s == 256:
        assert p_shier._col_chunk(n, s) < s
    jd, jn = j_shier.pod_stack_apsp(adj, mesh=None)
    for mesh in (None, make_mesh(8, device="cpu")):
        pd, pn = p_shier.pod_stack_apsp(adj, mesh=mesh, device="cpu")
        np.testing.assert_array_equal(pd, np.asarray(jd))
        np.testing.assert_array_equal(pn, np.asarray(jn))
    # the sharded layout: every shard one equal block of the padded stack
    mesh = make_mesh(8, device="cpu")
    dd, nd, nn, sharded = p_shier.pod_stack_apsp_async(adj, mesh)
    assert nn == n and sharded == (n >= 8)
    blocks = p_shier.shard_pod_stack(np.asarray(jd), mesh)
    assert len(blocks) == 8 and {b.shape[0] for b in blocks} == {-(-n // 8)}
    np.testing.assert_array_equal(p_shier._host_stack(blocks)[:n], np.asarray(jd))
    if sharded:
        assert [b.shape for b in dd] == [b.shape for b in blocks]


# -- level 2: row sweeps, composition, hop arrays, the ring ----------------


@pytest.mark.parametrize("topo", ["dragonfly", "fattree8", "torus4x4"])
def test_row_sweeps_match_the_reference(topo):
    ref, got = _dbs(topo)
    ref.find_routes_batch(_pairs(ref, n=4))
    got.find_routes_batch(_pairs(got, n=4))
    js, ps = ref._jax_oracle()._hier, got._oracle_engine()._hier
    assert ps.n_borders == js.n_borders > 0
    for (ji, jc, jw), (pi, pc, pw) in zip(js.deg_buckets, ps.deg_buckets):
        for x, y in ((ji, pi), (jc, pc), (jw, pw)):
            np.testing.assert_array_equal(x, y)
    targets = np.arange(ps.n_borders, dtype=np.int64)
    want = j_hier.sweep_rows_host(js.deg_buckets, js.n_borders, targets)
    np.testing.assert_array_equal(
        p_hier.sweep_rows_host(ps.deg_buckets, ps.n_borders, targets), want)
    for n in (1, 3, 8):
        rows, rows_d = p_shier.sweep_rows_sharded(
            ps.deg_buckets, ps.n_borders, targets, make_mesh(n, device="cpu"))
        np.testing.assert_array_equal(rows, want)
        assert rows_d.shape[0] % n == 0
    # any row chunking is bit-equal: one row per chunk
    saved = p_shier._SWEEP_GATHER_FLOATS
    p_shier._SWEEP_GATHER_FLOATS = 1
    try:
        rows, _ = p_shier.sweep_rows_sharded(
            ps.deg_buckets, ps.n_borders, targets[::2], make_mesh(1, device="cpu"))
    finally:
        p_shier._SWEEP_GATHER_FLOATS = saved
    np.testing.assert_array_equal(rows, want[::2])
    assert p_shier.warm_sweep_ladder(ps.deg_buckets, ps.n_borders,
                                     make_mesh(8, device="cpu"), 600) == [256, 512, 1024]


@pytest.mark.parametrize("steered", [False, True])
def test_compose_fused_matches_the_reference(steered):
    """Small integer distances and loads: many equal totals and equal
    scores, so the first-index tie-break decides most picks."""
    rng = np.random.default_rng(7 + steered)
    m, bA, bB, r, b = 64, 8, 16, 40, 30
    plane = rng.integers(0, 4, (r, b)).astype(np.float32)
    plane[rng.random((r, b)) < 0.1] = np.inf
    rowidx = rng.integers(0, r, (m, bB)).astype(np.int32)
    gidA = rng.integers(0, b, (m, bA)).astype(np.int32)
    dsb = rng.integers(0, 3, (m, bA)).astype(np.float32)
    dbd = rng.integers(0, 3, (m, bB)).astype(np.float32)
    dsb[:, 6:] = np.inf  # padded source borders
    dbd[:8, 12:] = np.inf
    dbd[-2:] = np.inf  # queries with no destination border: all inf
    if steered:
        loadA = rng.integers(0, 3, (m, bA)).astype(np.float32)
        loadB = rng.integers(0, 3, (m, bB)).astype(np.float32)
        loadA[:, 6:] = np.inf
    else:
        loadA = np.zeros((m, bA), np.float32)
        loadB = np.zeros((m, bB), np.float32)
    want = j_compose.compose_fused(jnp.asarray(plane), rowidx, gidA, dsb, dbd,
                                   loadA, loadB)
    got = p_compose.compose_fused(torch.as_tensor(plane), rowidx, gidA, dsb, dbd,
                                  loadA, loadB)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert len(set(want[1].tolist())) > 1 and (want[1] > 0).any()
    p_compose.warm_compose(torch.as_tensor(plane), 8, 8, 8)


@pytest.mark.parametrize("topo", ["fattree8", "torus4x4", "dragonfly"])
def test_hop_arrays_match_the_reference(topo):
    ref, got = _dbs(topo)
    pairs = _pairs(ref, n=12)
    ref.find_routes_batch(pairs)
    got.find_routes_batch(pairs)
    js, ps = ref._jax_oracle()._hier, got._oracle_engine()._hier
    si = np.array([js.index[ref.hosts[a].port.dpid] for a, _ in pairs], np.int64)
    di = np.array([js.index[ref.hosts[b].port.dpid] for _, b in pairs], np.int64)
    fport = np.array([ref.hosts[b].port.port_no for _, b in pairs], np.int32)
    steer = np.random.default_rng(3).integers(0, 3, js.v).astype(np.float32)
    for st in (None, steer):
        jt = j_hier._Composer(js, st, fused=True).compose(si, di)
        pt = p_hier._Composer(ps, st, fused=True).compose(si, di)
        for x, y in zip(pt, jt):
            np.testing.assert_array_equal(x, y)
        want = j_hierpath.build_hop_arrays(js, si, di, fport, *jt)
        got_h = p_hierpath.build_hop_arrays(ps, si, di, fport, *pt)
        for x, y in zip(got_h, want):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("topo", ["fattree8", "fattree4p6"])
def test_ring_border_plane_is_the_host_slice(topo):
    """The K3-exchanged border plane (the plain version on the CPU)
    equals the host slice of the pod blocks: fattree(4, pods=6) has a
    bucket of 6 pods and a one-pod core bucket, both off the 8 shards."""
    _, got = _dbs(topo, mesh_devices=8, ring_exchange=True)
    got.find_routes_batch(_pairs(got, n=4))
    st = got._oracle_engine()._hier
    counts = {len(b.pods) for b in st.buckets}
    assert any(c % 8 for c in counts)
    planes = p_shier.ring_exchange_border_plane(st)
    for bi, b in enumerate(st.buckets):
        assert isinstance(b.dist_d, list) and len(b.dist_d) == 8
        for i, p in enumerate(b.pods):
            lo, hi = int(st.pod_bstart[p]), int(st.pod_bstart[p + 1])
            bl = st.border_local[lo:hi]
            np.testing.assert_array_equal(planes[bi][i, :hi - lo], b.dist[i][bl, :])
            assert np.isinf(planes[bi][i, hi - lo:]).all()
    assert p_shier.hier_device_bytes(st, st.mesh) == -(-st.device_bytes() // 8)


def test_pack_rows_round_trips_exactly():
    rng = np.random.default_rng(5)
    r = rng.integers(0, 65535, (7, 33)).astype(np.float32)
    r[rng.random(r.shape) < 0.2] = np.inf
    frac = r.copy()
    frac[0, 0] = 0.5
    for x in (r, frac, np.full((2, 3), np.inf, np.float32)):
        packed = json.loads(json.dumps(p_hier._pack_rows(x)))
        assert packed == j_hier._pack_rows(x)
        back = p_hier._unpack_rows(packed)
        assert back.dtype == np.float32
        np.testing.assert_array_equal(back, x)
        np.testing.assert_array_equal(back, j_hier._unpack_rows(packed))
    assert p_hier._pack_rows(r)["enc"] == "u16" and p_hier._pack_rows(frac)["enc"] == "f32"
    with pytest.raises(ValueError):
        p_hier._unpack_rows(dict(packed, enc="u8"))


# -- the oracle through TopologyDB ------------------------------------------


def _util(db):
    rng = np.random.default_rng(11)
    return {(a, link.src.port_no): float(rng.integers(0, 4)) * 1e9
            for a, dst in sorted(db.links.items()) for link in dst.values()}


@pytest.mark.parametrize("topo", ["fattree8", "torus4x4"])
def test_windows_collectives_and_phases_match_the_reference(topo):
    ref, got = _dbs(topo)
    assert type(got._oracle_engine()).__name__ == "HierOracle"
    pairs = _pairs(ref, n=12)
    assert got.find_routes_batch(pairs) == ref.find_routes_batch(pairs)
    util = _util(ref)
    assert got.find_routes_batch_balanced(pairs, link_util=util) == \
        ref.find_routes_batch_balanced(pairs, link_util=util)
    assert got.find_routes_batch_adaptive(pairs, link_util=util) == \
        ref.find_routes_batch_adaptive(pairs, link_util=util)
    macs = sorted(ref.hosts)[:10]
    src, dst = np.meshgrid(np.arange(10), np.arange(10), indexing="ij")
    off = src != dst
    si, di = src[off].astype(np.int32), dst[off].astype(np.int32)
    for policy, lu in (("shortest", None), ("balanced", util), ("adaptive", util)):
        cr = ref.find_routes_collective(macs, si, di, policy, link_util=lu)
        cg = got.find_routes_collective(macs, si, di, policy, link_util=lu)
        assert cg.fdbs() == cr.fdbs() and cg.max_congestion == cr.max_congestion
        for key in ("pair_sub", "final_port", "hop_dpid", "hop_port", "hop_len",
                    "endpoint_port"):
            np.testing.assert_array_equal(getattr(cg, key), getattr(cr, key))
    pr = ref.find_routes_collective_phased(macs, si, di, policy="balanced", n_phases=3)
    pg = got.find_routes_collective_phased(macs, si, di, policy="balanced", n_phases=3)
    pr.reap_all()
    pg.reap_all()
    np.testing.assert_array_equal(pg.pair_phase, pr.pair_phase)
    assert len(pg.phases) == len(pr.phases)
    for a, b in zip(pg.phases, pr.phases):
        np.testing.assert_array_equal(a.pair_idx, b.pair_idx)
        wa, wb = a.window.reap(), b.window.reap()
        assert wa.fdbs() == wb.fdbs() and wa.max_congestion == wb.max_congestion
    # the scalar escape hatch answers the same
    _, scal = _dbs(topo, hier_fused=False)
    assert scal.find_routes_batch(pairs) == got.find_routes_batch(pairs)
    a, b = macs[0], macs[-1]
    assert got.find_route(a, b) == ref.find_route(a, b)
    assert got.find_all_routes(a, b, max_paths=8) == ref.find_all_routes(a, b, max_paths=8)
    with pytest.raises(NotImplementedError):
        got._oracle_engine().matrices(got)


def test_unreachable_and_zero_border_pods_match_the_reference():
    """fattree(8) with pod 0's every uplink cut: pod 0 has no borders;
    a mixed window routes the healthy pairs and leaves [] for the rest."""
    ref, got = _dbs("fattree8")
    spec = P.fattree(8)
    pm = spec.podmap
    core = {d for d, p in pm.pod_of.items() if p == pm.n_pods - 1}
    for a, pa, b, pb in spec.links:
        if b in core and pm.pod_of[a] == 0:
            _flip(ref, got, (a, pa, b, pb), add=False)
    hosts = sorted(ref.hosts)
    pairs = [(hosts[0], hosts[20]), (hosts[20], hosts[0]), (hosts[1], hosts[2]),
             (hosts[20], hosts[30])]
    fr = ref.find_routes_batch(pairs)
    assert got.find_routes_batch(pairs) == fr
    assert fr[0] == [] and fr[3]


def test_churn_replay_matches_the_reference():
    """Seeded link deletes and re-adds through the delta log: every
    step's routes equal the reference's, with the same block repairs,
    level-2 refreshes and builds (all counted by both packages)."""
    from sdnmpi_tpu.utils.metrics import REGISTRY as JR
    from sdnmpi_tpu_torch.utils.metrics import REGISTRY as PR

    names = ("hier_block_repairs_total", "hier_l2_refreshes_total",
             "hier_full_builds_total")
    for topo in ("fattree4", "torus4x4"):
        ref, got = _dbs(topo)
        pairs = _pairs(ref, n=6)
        assert got.find_routes_batch(pairs) == ref.find_routes_batch(pairs)
        jo, po = ref._jax_oracle(), got._oracle_engine()
        j0 = [JR.get(n).value for n in names]
        p0 = [PR.get(n).value for n in names]
        cables = list(TOPOS[topo](P).links)
        rng = random.Random(13)
        removed = []
        for _ in range(12):
            if removed and rng.random() < 0.5:
                _flip(ref, got, removed.pop(), add=True)
            else:
                cable = cables[rng.randrange(len(cables))]
                if ref.links.get(cable[0], {}).get(cable[2]) is None:
                    continue
                removed.append(cable)
                _flip(ref, got, cable, add=False)
            assert got.find_routes_batch(pairs) == ref.find_routes_batch(pairs)
        assert (po.repair_count, po.full_refresh_count) == \
            (jo.repair_count, jo.full_refresh_count)
        assert [PR.get(n).value - v for n, v in zip(names, p0)] == \
            [JR.get(n).value - v for n, v in zip(names, j0)]
        assert po.repair_count > 0


def test_delta_leg_cache_warm_ladder_and_counters_match_the_reference():
    from sdnmpi_tpu.utils.metrics import REGISTRY as JR
    from sdnmpi_tpu_torch.utils.metrics import REGISTRY as PR

    # the delta-narrowed leg
    ref, got = _dbs("fattree4")
    pairs = _pairs(ref, n=6)
    ref.find_routes_batch(pairs)
    got.find_routes_batch(pairs)
    cable = TOPOS["fattree4"](P).links[0]
    _flip(ref, got, cable, add=False)
    wr = ref.find_routes_batch_delta_dispatch(pairs, {cable[0], cable[2]}).reap()
    wg = got.find_routes_batch_delta_dispatch(pairs, {cable[0], cable[2]}).reap()
    assert wg.touched.tolist() == wr.touched.tolist()
    assert wg.fdbs() == wr.fdbs()
    # the route cache: hit == miss, a link delta evicts
    _, db = _dbs("fattree4", route_cache=True)
    miss = db.find_routes_batch_dispatch(pairs).reap()
    assert db.find_routes_batch_dispatch(pairs).reap() is miss
    _link("sdnmpi_tpu_torch", *cable, False, db)
    assert db.find_routes_batch_dispatch(pairs).reap() is not miss
    # the warm ladder: the same rung count, and the escape hatch
    ref, got = _dbs("fattree4p6", mesh_devices=0)
    wr, wg = ref.warm_serving(), got.warm_serving()
    assert (wg["compiled"], wg["max_len"], wg["shapes"]) == \
        (wr["compiled"], wr["max_len"], wr["shapes"]) and wg["compiled"] > 0
    assert _dbs("fattree4", hier_warm=False)[1].warm_serving()["compiled"] == 0
    # the border cache's counters move as the reference's
    names = ("hier_border_cache_hits_total", "hier_border_cache_misses_total",
             "hier_border_rows_total")
    ref, got = _dbs("fattree4")
    for db, reg in ((ref, JR), (got, PR)):
        v0 = [reg.get(n).value for n in names]
        db.find_routes_batch(pairs)
        db.find_routes_batch(pairs)
        db.moved = [reg.get(n).value - v for n, v in zip(names, v0)]
        db.cached = reg.get("hier_border_rows_cached").value
    assert got.moved == ref.moved and got.cached == ref.cached
    assert got.moved[0] > 0 and got.moved[1] > 0


def test_border_snapshots_cross_the_packages():
    """A border snapshot of either package restores into both, byte-equal
    rows and the same routes; another fabric's snapshot and garbage are
    rejected and counted, never raised."""
    from sdnmpi_tpu.utils.metrics import REGISTRY as JR
    from sdnmpi_tpu_torch.utils.metrics import REGISTRY as PR

    ref, got = _dbs("fattree4p6")
    pairs = _pairs(ref, n=10)
    f0 = ref.find_routes_batch(pairs)
    assert got.find_routes_batch(pairs) == f0
    snaps = {"ref": json.loads(json.dumps(ref.hier_border_snapshot())),
             "port": json.loads(json.dumps(got.hier_border_snapshot()))}
    assert snaps["ref"] == snaps["port"] and snaps["port"]["pods"]
    for snap in snaps.values():
        r2, g2 = _dbs("fattree4p6")
        assert g2.hier_restore_border_rows(snap) == r2.hier_restore_border_rows(snap) > 0
        jr, pr = r2._jax_oracle()._hier.rows, g2._oracle_engine()._hier.rows
        assert sorted(jr) == sorted(pr)
        for p in jr:
            np.testing.assert_array_equal(pr[p], jr[p])
        assert g2.find_routes_batch(pairs) == f0
    other_r, other_g = _dbs("fattree4p6")
    _flip(other_r, other_g, TOPOS["fattree4p6"](P).links[0], add=False)
    j0 = JR.get("hier_snapshot_rejected_total").value
    p0 = PR.get("hier_snapshot_rejected_total").value
    for snap in (snaps["port"], {"version": 99}, "not a dict",
                 {"version": 1, "digest": "x"}):
        assert other_g.hier_restore_border_rows(snap) == \
            other_r.hier_restore_border_rows(snap) == 0
    assert PR.get("hier_snapshot_rejected_total").value - p0 == \
        JR.get("hier_snapshot_rejected_total").value - j0 == 4
    assert other_g.find_routes_batch(pairs) == other_r.find_routes_batch(pairs)
    assert ref.hier_border_snapshot() is not None
    assert P.fattree(4).to_topology_db(device="cpu").hier_border_snapshot() is None


def _boot(S, config):
    from tests.test_torch_control import launch_all

    fabric = S.topogen.fattree(4).to_fabric()
    ctl = S.Controller(fabric, config)
    ctl.attach()
    macs = sorted(fabric.hosts)[:6]
    launch_all(S, fabric, macs)
    return fabric, ctl, macs


def test_controller_fence_and_restart_match_the_reference():
    """Both packages' Controllers under hier_oracle against their dense
    controllers (the reference's fence): a block-installed 6-rank
    alltoall rides the same pairs and flow rows, and delivers. Then a
    checkpoint carries the border plane into a restarted controller of
    each package, which routes as before."""
    from tests.test_torch_control import PORT, REF, make_config, send_vmac

    installs = {}
    for S in (REF, PORT):
        for hier in (False, True):
            fabric, ctl, macs = _boot(S, make_config(
                S, block_install_threshold=1, hier_oracle=hier))
            send_vmac(S, fabric, macs[0], "ALLTOALL", 0, 1)
            before = len(fabric.hosts[macs[2]].received)
            send_vmac(S, fabric, macs[1], "ALLTOALL", 1, 2)
            assert len(fabric.hosts[macs[2]].received) > before
            install = next(iter(ctl.router.collectives))
            installs[S is PORT, hier] = (install.n_pairs, install.n_flows,
                                         sorted(install.links))
    assert installs[True, True] == installs[False, True]
    assert installs[True, True][:2] == installs[True, False][:2]
    snaps = {}
    for S in (REF, PORT):
        pkg = "sdnmpi_tpu" if S is REF else "sdnmpi_tpu_torch"
        snapshot = __import__(f"{pkg}.api.snapshot", fromlist=["x"])
        _, ctl, macs = _boot(S, make_config(S, hier_oracle=True))
        db = ctl.topology_manager.topologydb
        pairs = [(a, b) for a in macs for b in macs if a != b]
        f0 = db.find_routes_batch(pairs)
        snaps[S is PORT] = snap = json.loads(json.dumps(snapshot.snapshot_controller(ctl)))
        assert snap["hier_border"]["pods"]
        _, ctl2, _ = _boot(S, make_config(S, hier_oracle=True))
        snapshot.restore_controller(ctl2, snap)
        db2 = ctl2.topology_manager.topologydb
        assert db2._oracle._hier.plane_len > 0
        assert db2.find_routes_batch(pairs) == f0
    assert snaps[True]["hier_border"] == snaps[False]["hier_border"]


def test_mesh_with_ring_matches_one_device():
    """fattree(8) under the 8-shard mesh with the ring: the same routes as
    the port on one device and as the reference on one device; the row
    sweeps run on the device and the pod shards are resident."""
    ref, one = _dbs("fattree8")
    _, mesh = _dbs("fattree8", mesh_devices=8, ring_exchange=True)
    pairs = _pairs(ref, n=12)
    f0 = ref.find_routes_batch(pairs)
    assert one.find_routes_batch(pairs) == f0
    assert mesh.find_routes_batch(pairs) == f0
    macs = sorted(ref.hosts)[:12]
    src, dst = np.meshgrid(np.arange(12), np.arange(12), indexing="ij")
    off = src != dst
    si, di = src[off].astype(np.int32), dst[off].astype(np.int32)
    cr = ref.find_routes_collective(macs, si, di, "shortest")
    assert mesh.find_routes_collective(macs, si, di, "shortest").fdbs() == cr.fdbs()
    st = mesh._oracle_engine()._hier
    assert st.ring and st.rows_d and st.device_bytes() > 0
    one_st = one._oracle_engine()._hier
    for p, r in one_st.rows.items():
        np.testing.assert_array_equal(st.rows[p], r)
    # an intra-pod flap under mesh + ring repairs in place and stays equal
    spec = P.fattree(8)
    pm = spec.podmap
    cable = next(c for c in spec.links if pm.pod_of[c[0]] == pm.pod_of[c[2]])
    builds = mesh._oracle_engine().full_refresh_count
    for add in (False, True):
        _flip(ref, mesh, cable, add)
        assert mesh.find_routes_batch(pairs) == ref.find_routes_batch(pairs)
    assert mesh._oracle_engine().full_refresh_count == builds


def test_launcher_demo_under_the_hier_oracle(tmp_path):
    """``--hier-oracle --demo`` through both launchers writes the same
    checkpoint, border plane included."""
    import asyncio

    from sdnmpi_tpu import launch as ref_launch
    from sdnmpi_tpu_torch import launch as port_launch

    argv = ["--topo", "fattree:4", "--demo", "--demo-ranks", "8", "--no-rpc",
            "--duration", "0.1", "--hier-oracle"]
    out = {}
    for name, launch, side in (("ref", ref_launch, ["--backend", "jax"]),
                               ("port", port_launch, ["--device", "cpu"])):
        path = tmp_path / f"{name}.json"
        args = launch.build_parser().parse_args(argv + side + ["--checkpoint", str(path)])
        asyncio.run(launch.amain(args))
        out[name] = json.loads(path.read_text())
    for key in ("topology", "fdb", "rankdb", "collectives", "desired_flows",
                "hier_border"):
        assert out["port"][key] == out["ref"][key], key
    assert out["port"]["hier_border"]["pods"]

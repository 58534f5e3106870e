"""The port's pair-batch routing API and collective policies against the
JAX package on the CPU.

Every new ``TopologyDB`` entry point of the torch backend
(``find_routes_batch``, ``find_routes_batch_dispatch``,
``find_routes_batch_balanced``, ``find_routes_batch_adaptive`` and
``find_routes_collective(policy="shortest" | "adaptive")``) is held
against ``sdnmpi_tpu``'s ``TopologyDB(backend="jax")`` on the same
fabric (carried across with ``convert.topology_from_dict``), on both legs
of each dispatch rule: the host chase and the device chase, the greedy
scanner and the DAG balancer. Shortest and greedy legs must give the
reference's fdbs exactly. The sampled legs (the DAG balancer and the
UGAL program) follow the near-tie rule of ``test_torch_slice``: a pair's
route equals the reference's unless the reference's own decision for its
sub-flow was a near-tie, and is then a valid route; the near-tie count is
printed. The ``"py"`` backend's fall-backs and the mesh's unported
sharded legs are checked too.
"""

import numpy as np
import pytest

from sdnmpi_tpu import topogen as j_topogen
from sdnmpi_tpu_torch.convert import topology_from_dict
from sdnmpi_tpu_torch.oracle import adaptive, dag, paths
from tests import topo_fixtures
from tests.test_torch_adaptive import reference_adaptive
from tests.test_torch_slice import _reference_ties

UNKNOWN = "02:ff:ff:ff:ff:01"


def _fabric(name: str, backend: str = "jax"):
    """(reference db, port db, host MACs) of one small fabric."""
    if name == "diamond":
        jdb = topo_fixtures.diamond(backend)
    else:
        spec = {
            "dragonfly": lambda: j_topogen.dragonfly(4, 4, 1, 2),
            "fattree4": lambda: j_topogen.fattree(4),
            "torus": lambda: j_topogen.torus((3, 3), hosts_per_switch=1),
        }[name]()
        jdb = spec.to_topology_db(backend=backend)
    pdb = topology_from_dict(
        jdb.to_dict(), backend="torch" if backend == "jax" else "py", device="cpu")
    return jdb, pdb, sorted(jdb.hosts)


def _pairs(macs, n_max: int = 0):
    """Ordered pairs of distinct hosts, one src == dst pair, and pairs
    naming an unknown MAC."""
    out = [(a, b) for a in macs for b in macs if a != b]
    if n_max:
        out = out[:n_max]
    return out + [(macs[0], macs[0]), (UNKNOWN, macs[1]), (macs[1], UNKNOWN)]


def _hot_util(jdb) -> dict:
    """Monitor-style samples: the links out of the lowest third of the
    switches hot, small load on the rest."""
    rng = np.random.default_rng(3)
    dpids = sorted(jdb.switches)
    hot = set(dpids[: max(1, len(dpids) // 3)])
    return {
        (a, link.src.port_no): (8e9 if a in hot else float(rng.random() * 1e9))
        for a, dst_map in jdb.links.items() for link in dst_map.values()
    }


def _assert_valid_fdb(db, pair, fdb):
    """An fdb from the source's edge switch to the destination host's
    port over real links with their ports."""
    src, dst = pair
    assert fdb, pair
    assert fdb[0][0] == db.hosts[src].port.dpid
    assert fdb[-1] == (db.hosts[dst].port.dpid, db.hosts[dst].port.port_no)
    for (d1, p1), (d2, _) in zip(fdb, fdb[1:]):
        assert db.links[d1][d2].src.port_no == p1, (pair, fdb)


def _pair_subflows(pdb, pairs, ecmp_ways: int) -> np.ndarray:
    """Each pair's sub-flow index as the oracle deals it (-1 unresolved)."""
    o = pdb._oracle_engine()
    t = o.refresh(pdb)
    rows = o._resolve_rows(pdb, pairs, t, [[] for _ in pairs])
    groups, group_subs, *_ = o._group_ecmp_subflows(rows, ecmp_ways)
    g_of = np.full(len(pairs), -1, np.int64)
    for key, members in groups.items():
        first, nsub = group_subs[key]
        for j, (k, _) in enumerate(members):
            g_of[k] = first + j % nsub
    return g_of


def _assert_pairs_match(pdb, pairs, got, ref, tied_sub, g_of):
    """Exact fdbs for pairs whose sub-flow had no near-tie, valid ones
    for the rest; returns the number of tied pairs."""
    tied = np.array([g >= 0 and bool(tied_sub[g]) for g in g_of])
    for k, (a, b) in enumerate(zip(got, ref)):
        if tied[k]:
            _assert_valid_fdb(pdb, pairs[k], a)
        else:
            assert a == b, (pairs[k], a, b)
    print(f"near-tie pairs: {int(tied.sum())} of {len(pairs)}")
    return int(tied.sum())


@pytest.mark.parametrize("name", ["dragonfly", "fattree4", "torus", "diamond"])
@pytest.mark.parametrize("leg", ["host", "device"])
def test_find_routes_batch_matches_jax(monkeypatch, name, leg):
    """Shortest-path batches, on the host chase and on the device chase
    (``paths.batch_fdb``, forced by a zero hop budget on both oracles):
    the reference's fdbs exactly, the blocking and the split-phase API,
    and ``find_route`` for every pair."""
    jdb, pdb, macs = _fabric(name)
    pairs = _pairs(macs)
    calls = []
    real = paths.batch_fdb
    monkeypatch.setattr(paths, "batch_fdb", lambda *a: calls.append(1) or real(*a))
    if leg == "device":
        jdb._jax_oracle().host_chase_hop_budget = 0
        pdb._oracle_engine().host_chase_hop_budget = 0
    ref = jdb.find_routes_batch(pairs)
    got = pdb.find_routes_batch(pairs)
    assert got == ref
    assert got == [pdb.find_route(a, b) for a, b in pairs]
    window = pdb.find_routes_batch_dispatch(pairs)
    assert window.done == (leg == "host")
    w, r = window.reap(), jdb.find_routes_batch_dispatch(pairs).reap()
    for field in ("hop_dpid", "hop_port", "hop_len"):
        np.testing.assert_array_equal(getattr(w, field), getattr(r, field), field)
    assert w.fdbs() == ref
    assert bool(calls) == (leg == "device")


@pytest.mark.parametrize("name,util,chunk", [
    ("dragonfly", True, 4096), ("fattree4", True, 8), ("torus", False, 4096),
    ("diamond", True, 2),
])
def test_find_routes_batch_balanced_greedy_matches_jax(name, util, chunk):
    """Below the DAG threshold the greedy scanner routes: the reference's
    fdbs and discrete congestion exactly (the sub-flow weights are
    dyadic, so every load sum is exact in any order)."""
    jdb, pdb, macs = _fabric(name)
    pairs = _pairs(macs, n_max=120)
    kw = {"chunk": chunk}
    if util:
        kw["link_util"] = _hot_util(jdb)
    ref = jdb.find_routes_batch_balanced(pairs, **kw)
    got = pdb.find_routes_batch_balanced(pairs, **kw)
    assert got == ref
    oracle = pdb._oracle_engine()
    assert oracle.last_discrete_congestion == got[1]
    assert oracle.last_fractional_congestion == 0.0  # no DAG pass
    w = pdb.find_routes_batch_dispatch(pairs, policy="balanced", **kw).reap()
    assert (w.fdbs(), w.max_congestion) == got


@pytest.mark.parametrize("name", ["dragonfly", "fattree4"])
def test_find_routes_batch_balanced_dag_matches_jax(monkeypatch, name):
    """At or above the threshold (here 1 sub-flow) the DAG balancer and
    the sampler route: the near-tie rule on the reference's own sampling
    of the same inputs, the fractional bound to rtol 1e-5."""
    jdb, pdb, macs = _fabric(name)
    pairs = _pairs(macs)
    kw = {"link_util": _hot_util(jdb), "dag_threshold": 1}
    captured = {}
    real = dag.route_collective

    def spy(adj, link_src, link_dst, link_util, traffic, src, dst, **k):
        captured.update(adj=adj, link_src=link_src, link_dst=link_dst,
                        link_util=link_util, traffic=traffic, src=src, dst=dst, **k)
        return real(adj, link_src, link_dst, link_util, traffic, src, dst, **k)

    monkeypatch.setattr(dag, "route_collective", spy)
    ref_fdbs, ref_maxc = jdb.find_routes_batch_balanced(pairs, **kw)
    got_fdbs, got_maxc = pdb.find_routes_batch_balanced(pairs, **kw)
    tied, scored, maxc = _reference_ties(captured)
    n = _assert_pairs_match(pdb, pairs, got_fdbs, ref_fdbs, tied,
                            _pair_subflows(pdb, pairs, 4))
    assert n <= 1e-3 * scored
    if n == 0:
        assert got_maxc == ref_maxc
    oracle = pdb._oracle_engine()
    np.testing.assert_allclose(oracle.last_fractional_congestion, maxc, rtol=1e-5)
    w = pdb.find_routes_batch_dispatch(pairs, policy="balanced", **kw).reap()
    assert w.fdbs() == got_fdbs and w.max_congestion == got_maxc


def _adaptive_ties(captured, hops_of=None):
    """Per sub-flow: the reference's UGAL or sampler near-tie on the
    inputs of the port's ``route_adaptive`` call."""
    a = {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in captured.items()}
    _, _, _, near, segments, hops = reference_adaptive(
        a["adj"], a["util"], a["src"], a["dst"], a["weight"], a["n_valid"], a["dist"],
        a["levels"], a["rounds"], a["max_len"], a["n_candidates"], a["bias"], a["salt"])
    tied = near.copy()
    scored = 0
    for _, _, first, sc in segments:
        tied |= first < hops
        scored += sc
    return tied, scored


def _spy_adaptive(monkeypatch, captured):
    real = adaptive.route_adaptive

    def spy(adj, util, src, dst, weight, n_valid, **k):
        captured.update(adj=adj, util=util, src=src, dst=dst, weight=weight,
                        n_valid=n_valid, salt=k.get("salt", 0), **k)
        return real(adj, util, src, dst, weight, n_valid, **k)

    monkeypatch.setattr(adaptive, "route_adaptive", spy)


@pytest.mark.parametrize("name,hot,ways", [
    ("dragonfly", True, 4), ("dragonfly", False, 2), ("torus", True, 4),
    ("fattree4", True, 4),
])
def test_find_routes_batch_adaptive_matches_jax(monkeypatch, name, hot, ways):
    """The UGAL pair batch: fdbs under the near-tie rule (UGAL margin
    and sampler), detour count and discrete congestion exact when nothing
    tied; the split-phase window carries the same."""
    jdb, pdb, macs = _fabric(name)
    pairs = _pairs(macs, n_max=160)
    kw = {"ugal_candidates": 8, "ecmp_ways": ways}
    if hot:
        kw["link_util"] = _hot_util(jdb)
    captured = {}
    _spy_adaptive(monkeypatch, captured)
    ref = jdb.find_routes_batch_adaptive(pairs, **kw)
    got = pdb.find_routes_batch_adaptive(pairs, **kw)
    tied, scored = _adaptive_ties(captured)
    n = _assert_pairs_match(pdb, pairs, got[0], ref[0], tied,
                            _pair_subflows(pdb, pairs, ways))
    assert n <= max(2, 0.05 * len(pairs)), (n, scored)
    if n == 0:
        assert got[1:] == ref[1:]
    if name == "dragonfly" and hot:
        assert got[1] > 0  # the hot links made flows detour
    w = pdb.find_routes_batch_dispatch(pairs, policy="adaptive", **kw)
    assert w.done
    wr = w.reap()
    assert (wr.fdbs(), wr.n_detours, wr.max_congestion) == got
    assert pdb._oracle_engine().last_fractional_congestion == 0.0


@pytest.mark.parametrize("name", ["dragonfly", "fattree4", "torus"])
def test_find_routes_collective_shortest_matches_jax(name):
    """The collective's shortest policy (one sub-flow per group, the
    device next-hop chase): every field of the reference's routes."""
    jdb, pdb, macs = _fabric(name)
    n = len(macs)
    src = np.repeat(np.arange(n), n).astype(np.int32)
    dst = np.tile(np.arange(n), n).astype(np.int32)
    ref = jdb.find_routes_collective(macs, src, dst, policy="shortest")
    got = pdb.find_routes_collective(macs, src, dst, policy="shortest")
    for field in ("pair_sub", "final_port", "hop_dpid", "hop_port", "hop_len",
                  "endpoint_port"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field), field)
    assert (got.max_congestion, got.n_detours) == (ref.max_congestion, ref.n_detours)
    for k in range(0, len(src), 7):
        assert got.fdb(k) == pdb.find_route(macs[src[k]], macs[dst[k]])


@pytest.mark.parametrize("name,ways", [("dragonfly", 4), ("fattree4", 2)])
def test_find_routes_collective_adaptive_matches_jax(monkeypatch, name, ways):
    """The collective's adaptive policy: pair grouping, deal and ports
    exact, sub-flow routes under the near-tie rule, detours and discrete
    congestion exact when nothing tied."""
    jdb, pdb, macs = _fabric(name)
    n = len(macs)
    src = np.repeat(np.arange(n), n).astype(np.int32)
    dst = np.tile(np.arange(n), n).astype(np.int32)
    kw = {"link_util": _hot_util(jdb), "ecmp_ways": ways, "ugal_candidates": 8}
    captured = {}
    _spy_adaptive(monkeypatch, captured)
    ref = jdb.find_routes_collective(macs, src, dst, policy="adaptive", **kw)
    got = pdb.find_routes_collective(macs, src, dst, policy="adaptive", **kw)
    for field in ("pair_sub", "final_port", "endpoint_port"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field), field)
    tied, _ = _adaptive_ties(captured)
    same = ~tied[: got.n_subflows]
    np.testing.assert_array_equal(got.hop_dpid[same], ref.hop_dpid[same])
    np.testing.assert_array_equal(got.hop_port[same], ref.hop_port[same])
    print(f"near-tie sub-flows: {int((~same).sum())} of {got.n_subflows}")
    if same.all():
        assert (got.max_congestion, got.n_detours) == (ref.max_congestion, ref.n_detours)
    assert (got.routed_mask() == ref.routed_mask()).all()
    for k in np.nonzero(got.routed_mask())[0][::5]:
        _assert_valid_fdb(pdb, (macs[src[k]], macs[dst[k]]), got.fdb(k))


def test_py_backend_fall_backs_match_jax_py():
    """The ``"py"`` backend's reference semantics: plain batches, the
    balanced batch reporting the congestion of its plain routes, the
    adaptive batch with zero detours, completed windows."""
    jdb, pdb, macs = _fabric("dragonfly", backend="py")
    pairs = _pairs(macs, n_max=60)
    assert pdb.find_routes_batch(pairs) == jdb.find_routes_batch(pairs)
    assert pdb.find_routes_batch_balanced(pairs) == jdb.find_routes_batch_balanced(pairs)
    got = pdb.find_routes_batch_adaptive(pairs)
    assert got == jdb.find_routes_batch_adaptive(pairs) and got[1:] == (0, 0.0)
    for policy in ("shortest", "balanced", "adaptive"):
        w = pdb.find_routes_batch_dispatch(pairs, policy=policy)
        r = jdb.find_routes_batch_dispatch(pairs, policy=policy).reap()
        assert w.done
        w = w.reap()
        assert (w.fdbs(), w.max_congestion, w.n_detours) == (
            r.fdbs(), r.max_congestion, r.n_detours)
    n = len(macs)
    src, dst = np.arange(n), np.roll(np.arange(n), 3)
    for policy in ("shortest", "adaptive"):
        got = pdb.find_routes_collective(macs, src, dst, policy=policy)
        ref = jdb.find_routes_collective(macs, src, dst, policy=policy)
        np.testing.assert_array_equal(got.hop_dpid, ref.hop_dpid)
        assert got.max_congestion == ref.max_congestion


def test_mesh_oracle_raises_on_unported_sharded_legs():
    """With a shard mesh every leg routes as the reference's single
    device does: past the host chase's budget the sharded chase of
    row-sharded next hops (``shard_oracle``), the shortest collective on
    them, and the sharded UGAL program with or without ``shard_oracle``;
    the greedy scanner and the one-device chase beside a mesh still
    answer too. Nothing raises."""
    jdb, _, macs = _fabric("fattree4")
    pairs = _pairs(macs)
    sdb = topology_from_dict(jdb.to_dict(), device="cpu", mesh_devices=4,
                             shard_oracle=True)
    mdb = topology_from_dict(jdb.to_dict(), device="cpu", mesh_devices=4)
    ref = jdb.find_routes_batch(pairs)
    assert sdb.find_routes_batch(pairs) == ref  # small: the host chase
    sdb._oracle_engine().host_chase_hop_budget = 0
    assert sdb.find_routes_batch(pairs) == ref
    assert sdb.find_routes_batch_dispatch(pairs).reap().fdbs() == ref
    n = len(macs)
    src, dst = np.arange(n), np.roll(np.arange(n), 1)
    want = jdb.find_routes_collective(macs, src, dst, policy="shortest")
    got = sdb.find_routes_collective(macs, src, dst, policy="shortest")
    np.testing.assert_array_equal(got.hop_dpid, want.hop_dpid)
    assert got.max_congestion == want.max_congestion
    want = jdb.find_routes_collective(macs, src, dst, policy="adaptive")
    for db in (sdb, mdb):
        assert db.find_routes_batch_adaptive(pairs) == jdb.find_routes_batch_adaptive(pairs)
        got = db.find_routes_collective(macs, src, dst, policy="adaptive")
        np.testing.assert_array_equal(got.hop_dpid, want.hop_dpid)
        assert (got.max_congestion, got.n_detours) == (want.max_congestion, want.n_detours)
        assert db.find_routes_batch_balanced(pairs) == jdb.find_routes_batch_balanced(pairs)
    mdb._oracle_engine().host_chase_hop_budget = 0
    assert mdb.find_routes_batch(pairs) == ref  # no shard_oracle: one device


def test_reference_policy_knobs_are_accepted():
    """The knobs the reference's blocking APIs take pass through the
    split-phase entry point; an unknown collective policy routes as the
    reference routes it, through the balanced (DAG) leg, flat and phased:
    routes equal to the reference's exactly. ``"scan"`` is one such name:
    no caller's policy picks the phase scanner's leg."""
    jdb, pdb, macs = _fabric("diamond")
    pairs = _pairs(macs)
    w = pdb.find_routes_batch_dispatch(
        pairs, policy="balanced", alpha=2.0, chunk=4, link_capacity=1e9,
        ecmp_ways=2, rounds=3, dag_threshold=10_000).reap()
    assert w.fdbs() == jdb.find_routes_batch_dispatch(
        pairs, policy="balanced", alpha=2.0, chunk=4, link_capacity=1e9,
        ecmp_ways=2, rounds=3, dag_threshold=10_000).reap().fdbs()
    src, dst = np.nonzero(~np.eye(len(macs), dtype=bool))
    for policy in ("valiant", "scan"):
        want = jdb.find_routes_collective(macs, src, dst, policy=policy)
        got = pdb.find_routes_collective(macs, src, dst, policy=policy)
        for field in ("pair_sub", "final_port", "hop_dpid", "hop_port", "hop_len"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        assert got.max_congestion == want.max_congestion
        want = jdb.find_routes_collective_phased(macs, src, dst, policy, n_phases=2)
        got = pdb.find_routes_collective_phased(macs, src, dst, policy, n_phases=2)
        np.testing.assert_array_equal(got.pair_phase, want.pair_phase)
        for a, b in zip(got.phases, want.phases):
            np.testing.assert_array_equal(a.reap().hop_dpid, b.reap().hop_dpid)

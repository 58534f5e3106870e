"""Each sub-flow's member count, taken where the pairs are dealt.

The oracle's group-and-deal front (``oracle.engine._group_and_deal``)
hands a collective batch's reap each sub-flow's dealt member count
(``sub_members``) beside the pairs' sub-flow ids (``pair_sub``), so the
reap's congestion figures make no pass over the pairs. Every deal form
counts: the C++ library's keyed hash deal, its ``np.unique`` path, the
numpy fallback and the rank deal of a balanced phase, each equal to a
count of ``pair_sub``. And the reap, handed a ``pair_sub`` that refuses
any numpy pass, still reads the max congestion, the detours and the
congestion gauges that a count of ``pair_sub`` gives.
"""

import numpy as np
import pytest

from sdnmpi_tpu_torch import native
from sdnmpi_tpu_torch.oracle import adaptive, engine
from sdnmpi_tpu_torch.topogen import dragonfly, fattree
from sdnmpi_tpu_torch.utils.metrics import REGISTRY
from sdnmpi_tpu_torch.utils.tracing import NULL_STAGES

#: the deal forms: (grouping path, rank deal)
FORMS = {
    "keyed": ("library", False),
    "unique": ("unique", False),
    "numpy": ("numpy", False),
    "rank": ("library", True),
    "rank-numpy": ("numpy", True),
}
GAUGES = ("congestion_discrete_max", "congestion_fractional_max",
          "congestion_discrete_over_fractional")


def _grouping(monkeypatch, path: str) -> None:
    """Put the front on one grouping path: the library's fused pass,
    ``np.unique`` with the library loaded, or no library at all."""
    if path != "numpy" and not native.available():
        pytest.skip("no C++ compiler for the native library")
    if path == "unique":
        monkeypatch.setattr(native, "group_pairs", lambda *a: None)
    elif path == "numpy":
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)


def _pairs(seed: int, unresolved: bool):
    """600 pairs over 40 endpoints on 12 switches: groups of one to a
    dozen members, so some hold fewer members than the ways; with
    ``unresolved``, 5 endpoints resolve nowhere (``edge == -1``)."""
    rng = np.random.default_rng(seed)
    edge = rng.integers(0, 12, 40).astype(np.int32)
    if unresolved:
        edge[rng.choice(40, 5, replace=False)] = -1
    src = rng.integers(0, 40, 600).astype(np.int32)
    dst = rng.integers(0, 40, 600).astype(np.int32)
    return src, dst, edge


@pytest.mark.parametrize("unresolved", [False, True], ids=["resolved", "unresolved"])
@pytest.mark.parametrize("ways", [1, 4])
@pytest.mark.parametrize("form", list(FORMS))
def test_the_deal_counts_what_it_deals(monkeypatch, form, ways, unresolved):
    path, rank = FORMS[form]
    _grouping(monkeypatch, path)
    src, dst, edge = _pairs(3, unresolved)
    b = engine._group_and_deal(src, dst, edge, 12, ways, rank, NULL_STAGES)
    assert (b.pair_sub == -1).any() == unresolved
    assert b.sub_members.dtype == np.int32 and b.sub_members.shape == (b.n_sub,)
    dealt = b.pair_sub[b.pair_sub >= 0]
    np.testing.assert_array_equal(b.sub_members, np.bincount(dealt, minlength=b.n_sub))
    assert b.sub_members.sum() == len(dealt) == ((edge[src] >= 0) & (edge[dst] >= 0)).sum()
    if rank:  # a rank deal loads each sub-flow within one member of its weight
        assert b.sub_members.min() >= 1
        assert (np.abs(b.sub_members - b.sub_w) < 1).all()


@pytest.mark.parametrize("unresolved", [False, True], ids=["resolved", "unresolved"])
@pytest.mark.parametrize("ways", [1, 4])
def test_the_library_and_the_fallback_deal_alike(monkeypatch, ways, unresolved):
    """The port's C++ deal (keyed and by group index) and the numpy
    fallback give equal sub-flow ids and equal counts."""
    src, dst, edge = _pairs(8, unresolved)
    batches = {}
    for form in ("keyed", "unique", "numpy"):
        with monkeypatch.context() as m:
            _grouping(m, FORMS[form][0])
            batches[form] = engine._group_and_deal(
                src, dst, edge, 12, ways, False, NULL_STAGES)
    for form in ("unique", "numpy"):
        for a, b in zip(batches["keyed"], batches[form]):
            np.testing.assert_array_equal(a, b)
    # the bare deal, library against fallback
    rng = np.random.default_rng(ways)
    inv = rng.integers(0, 7, 300).astype(np.int32)
    nsub = np.minimum(ways, np.bincount(inv, minlength=7)).astype(np.int32)
    sub_base = np.concatenate([[0], np.cumsum(nsub[:-1])]).astype(np.int64)
    with_lib = native.deal_subflows(inv, src[:300], dst[:300], nsub, sub_base)
    with monkeypatch.context() as m:
        _grouping(m, "numpy")
        without = native.deal_subflows(inv, src[:300], dst[:300], nsub, sub_base)
    for a, b in zip(with_lib, without):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(with_lib[1], np.bincount(with_lib[0], minlength=nsub.sum()))


class _NoRecount(np.ndarray):
    """A ``pair_sub`` the reap may hold and hand on, but not count again:
    no recast, no arithmetic or comparison, no numpy function over it."""

    def astype(self, *args, **kwargs):
        raise AssertionError("the reap recast pair_sub")

    def __array_ufunc__(self, *args, **kwargs):
        raise AssertionError("the reap computed on pair_sub")

    def __array_function__(self, *args, **kwargs):
        raise AssertionError("the reap made a numpy pass over pair_sub")


def _fattree():
    """A k=4 fat-tree's 16 hosts plus one endpoint that resolves nowhere."""
    db = fattree(4).to_topology_db(backend="torch", device="cpu")
    return db, sorted(db.hosts) + ["0e:00:00:00:00:ff"], {}


def _dragonfly():
    """dragonfly(4, 4, 2, 2) with each group's links to the next hot, so
    that some sub-flows detour (as ``test_torch_collective_spans``)."""
    db = dragonfly(4, 4, 2, 2).to_topology_db(backend="torch", device="cpu")
    group = {dpid: (dpid - 1) // 4 for dpid in db.switches}
    util = {(a, link.src.port_no): 9e9 if group[b] == (group[a] + 1) % 4 else 1e8
            for a, ends in db.links.items() for b, link in ends.items()}
    return db, sorted(db.hosts), {"link_util": util, "ugal_candidates": 8}


@pytest.mark.parametrize("case", ["balanced", "shortest", "adaptive", "phased"])
def test_the_reap_counts_nothing_per_pair(monkeypatch, case):
    db, macs, kwargs = _dragonfly() if case == "adaptive" else _fattree()
    src, dst = np.nonzero(~np.eye(len(macs), dtype=bool))
    src, dst = src.astype(np.int32), dst.astype(np.int32)
    oracle = db._oracle_engine()
    v = oracle.refresh(db).v
    batches, paths, weights, inters = [], [], [], []
    front, fdbs, loads = engine._group_and_deal, native.materialize_fdbs, adaptive.link_loads
    legs = oracle._adaptive_paths

    def guarded_front(*args):
        b = front(*args)
        if b is not None:
            batches.append(b)
            b = b._replace(pair_sub=b.pair_sub.view(_NoRecount))
        return b

    def recorded_fdbs(p, *args):
        paths.append(p)
        return fdbs(p, *args)

    def recorded_loads(p, w, v):  # the reap's, over the paths it materialized
        if any(p is q for q in paths):
            weights.append(np.array(w))
        return loads(p, w, v)

    def recorded_legs(*args, **kw):
        out = legs(*args, **kw)
        inters.append(out[0])
        return out

    monkeypatch.setattr(engine, "_group_and_deal", guarded_front)
    monkeypatch.setattr(native, "materialize_fdbs", recorded_fdbs)
    monkeypatch.setattr(adaptive, "link_loads", recorded_loads)
    monkeypatch.setattr(oracle, "_adaptive_paths", recorded_legs)
    before = [REGISTRY.gauge(n).value for n in GAUGES]
    if case == "phased":
        program = oracle.routes_collective_phased(db, macs, src, dst, "balanced")
        routes = [plan.reap() for plan in program.phases]
        assert len(routes) >= 2
    else:
        routes = [oracle.routes_collective(db, macs, src, dst, case, **kwargs)]
    assert len(batches) == len(paths) == len(weights) == len(routes)
    for b, p, w, r in zip(batches, paths, weights, routes):
        # the parent's count: every pair's sub-flow, unresolved pairs in bin 0
        counts = np.bincount(
            b.pair_sub.astype(np.int64) + 1, minlength=b.n_sub + 1)[1:].astype(np.float32)
        counts[r.hop_len == 0] = 0.0
        assert w.dtype == np.float32
        np.testing.assert_array_equal(w, counts)
        assert r.max_congestion == float(
            native.link_loads(p, counts, v).max(initial=0.0))
        assert r.max_congestion > 0
        if case == "adaptive":
            (inter,) = inters
            assert r.n_detours == int(counts[inter >= 0].sum()) > 0
        else:
            assert r.n_detours == 0
    if case == "phased":  # a phase's batch leaves the flat figures alone
        assert [REGISTRY.gauge(n).value for n in GAUGES] == before
        return
    disc, frac, ratio = (REGISTRY.gauge(n).value for n in GAUGES)
    assert disc == routes[0].max_congestion == oracle.last_discrete_congestion
    if case == "balanced":
        assert frac == oracle.last_fractional_congestion > 0
        assert ratio == disc / frac
    else:
        assert frac == ratio == 0.0

"""The port's serving plane against the JAX package's.

The route cache (``oracle/routecache.py``), the admission gate
(``control/admission.py``), the open-loop load generator
(``control/loadgen.py``), ``warm_serving`` and the kernel build
directory (``enable_compile_cache``). The reference runs backend
``"jax"`` on the CPU, the port backend ``"torch"`` on ``device="cpu"``;
both get the same fabrics and the same request sequences. Routes,
counters and snapshots compare exactly; wall times are not compared.
"""

import json

import numpy as np
import pytest

from tests.test_torch_control import PORT, REF, make_config

BALANCED_KW = dict(
    link_util=None, alpha=1.0, chunk=4096, link_capacity=10e9,
    ecmp_ways=4, rounds=2, dag_threshold=512,
)
ADAPTIVE_KW = dict(
    link_util=None, ugal_candidates=2, ugal_bias=1.0, alpha=1.0,
    link_capacity=10e9, ecmp_ways=2,
)
COLLECTIVE_KW = dict(
    link_util=None, alpha=1.0, link_capacity=10e9, ecmp_ways=4, rounds=2,
)
CACHE_METRICS = (
    "route_cache_hits_total", "route_cache_misses_total",
    "route_cache_evictions_total",
)


def _db(S, **kw):
    backend = {"backend": "jax"} if S is REF else {"backend": "torch", "device": "cpu"}
    return S.topogen.fattree(4).to_topology_db(pad_multiple=8, **backend, **kw)


def _registry(S):
    import importlib

    pkg = "sdnmpi_tpu" if S is REF else "sdnmpi_tpu_torch"
    return importlib.import_module(f"{pkg}.utils.metrics").REGISTRY


def _routes(r) -> dict:
    """The arrays of a WindowRoutes or CollectiveRoutes."""
    names = ("hop_dpid", "hop_port", "hop_len", "pair_sub", "final_port")
    return {n: np.asarray(getattr(r, n)).tolist() for n in names if hasattr(r, n)}


def cache_script(S) -> tuple[list, dict, object]:
    """One request sequence through a cached TopologyDB: windows of the
    three policies and collectives, each twice; a link delete; the same
    requests again; a snapshot. Returns the per-step record (counter
    deltas, live entries, each result's arrays and whether it was the
    stored object), the snapshot and the db."""
    reg = _registry(S)
    db = _db(S, route_cache=True)
    macs = sorted(db.hosts)
    pairs = [(macs[i], macs[-(i + 1)]) for i in range(6)]
    src = np.array([0, 1, 2, 3], np.int32)
    dst = np.array([4, 5, 6, 7], np.int32)
    requests = [
        lambda: db.find_routes_batch_dispatch(pairs).reap(),
        lambda: db.find_routes_batch_dispatch(
            pairs, policy="balanced", **BALANCED_KW).reap(),
        lambda: db.find_routes_batch_dispatch(
            pairs, policy="adaptive", **ADAPTIVE_KW).reap(),
        lambda: db.find_routes_collective(
            macs[:8], src, dst, "balanced", **COLLECTIVE_KW),
        lambda: db.find_routes_collective(macs[:8], src, dst, "shortest"),
        lambda: db.find_routes_batch_dispatch(pairs[3:]).reap(),
    ]
    record = []

    def run(tag):
        for i, req in enumerate(requests):
            before = [reg.get(m).value for m in CACHE_METRICS]
            first = req()
            again = req()
            after = [reg.get(m).value for m in CACHE_METRICS]
            record.append((
                tag, i, [a - b for a, b in zip(after, before)],
                len(db.route_cache), again is first, _routes(first),
            ))

    run("cold")
    # delete one link the first pair's shortest path rides: its riders
    # and every utilization-keyed entry go, the rest stay
    hops = record[0][5]["hop_dpid"][0]
    a, b = hops[1], hops[2]
    db.delete_link(db.links[a][b])
    run("after delete")
    snap = db.route_cache.snapshot_entries(db)
    return record, snap, db


def test_route_cache_counters_and_routes_match_the_reference():
    ref_rec, ref_snap, _ = cache_script(REF)
    got_rec, got_snap, _ = cache_script(PORT)
    assert got_rec == ref_rec
    # every repeat request was a hit, served as the stored object
    assert all(step[4] for step in got_rec)
    assert json.loads(json.dumps(got_snap)) == json.loads(json.dumps(ref_snap))
    assert got_snap["entries"], "the shortest-policy entries serialize"


def test_route_cache_hit_equals_miss_and_uncached():
    """On the port a hit is the stored miss itself, and the uncached DB
    routes the same windows and collectives."""
    cached, plain = _db(PORT, route_cache=True), _db(PORT)
    assert plain.route_cache is None
    macs = sorted(cached.hosts)
    pairs = [(macs[i], macs[-(i + 1)]) for i in range(6)]
    for policy, kw in (("shortest", {}), ("balanced", BALANCED_KW),
                       ("adaptive", ADAPTIVE_KW)):
        miss = cached.find_routes_batch_dispatch(pairs, policy=policy, **kw).reap()
        hit = cached.find_routes_batch_dispatch(pairs, policy=policy, **kw).reap()
        off = plain.find_routes_batch_dispatch(pairs, policy=policy, **kw).reap()
        assert hit is miss
        assert _routes(hit) == _routes(off)
    src = np.array([0, 1, 2, 3], np.int32)
    dst = np.array([4, 5, 6, 7], np.int32)
    miss = cached.find_routes_collective(macs[:8], src, dst, "balanced", **COLLECTIVE_KW)
    hit = cached.find_routes_collective(macs[:8], src, dst, "balanced", **COLLECTIVE_KW)
    off = plain.find_routes_collective(macs[:8], src, dst, "balanced", **COLLECTIVE_KW)
    assert hit is miss
    assert _routes(hit) == _routes(off)
    assert hit.max_congestion == off.max_congestion


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF), (PORT, PORT)],
                         ids=["ref-to-port", "port-to-ref", "port-to-port"])
def test_route_cache_snapshot_restores_across_packages(writer, reader):
    """A memo written by either package re-seeds the other's cache on
    the same fabric: a restored entry is a hit equal to the uncached
    route, and it still invalidates through the delta log. Another
    fabric restores nothing."""
    _, snap, src_db = cache_script(writer)
    snap = json.loads(json.dumps(snap))
    fresh = _db(reader, route_cache=True)
    # the intact fabric is not the one the memo was taken on
    assert fresh.route_cache.restore_entries(snap, fresh) == 0
    (a, b), = [(x, y) for x in fresh.links for y in fresh.links[x]
               if y not in src_db.links.get(x, {})]
    link = fresh.links[a][b]
    fresh.delete_link(link)
    assert fresh.route_cache.restore_entries(snap, fresh) == len(snap["entries"]) > 0
    plain = _db(reader)
    plain.delete_link(plain.links[a][b])
    macs = sorted(fresh.hosts)
    pairs = [(macs[i], macs[-(i + 1)]) for i in range(6)]
    reg = _registry(reader)
    h0 = reg.get("route_cache_hits_total").value
    hit = fresh.find_routes_batch_dispatch(pairs).reap()
    assert reg.get("route_cache_hits_total").value == h0 + 1
    assert _routes(hit) == _routes(plain.find_routes_batch_dispatch(pairs).reap())
    # a link add clears the restored memo
    fresh.add_link(link)
    fresh.find_routes_batch_dispatch(pairs).reap()
    assert len(fresh.route_cache) == 1


@pytest.mark.parametrize("spec", [("fattree", (4,)), ("linear", (5, 2)), ("torus2d", (3, 4))])
def test_topology_digest_matches_the_reference(spec):
    """Checkpoints carry the digest across the two packages."""
    from sdnmpi_tpu.oracle.routecache import RouteCache as RefCache
    from sdnmpi_tpu_torch.oracle.routecache import RouteCache as PortCache

    name, args = spec
    ref = getattr(REF.topogen, name)(*args).to_topology_db(backend="py")
    got = getattr(PORT.topogen, name)(*args).to_topology_db(backend="py")
    assert PortCache.topology_digest(got) == RefCache.topology_digest(ref)
    got.delete_link(got.links[min(got.links)][min(got.links[min(got.links)])])
    assert PortCache.topology_digest(got) != RefCache.topology_digest(ref)


# -- admission -------------------------------------------------------------


def test_token_buckets_match_the_reference():
    from sdnmpi_tpu.control import admission as ra
    from sdnmpi_tpu_torch.control import admission as pa

    rng = np.random.default_rng(7)
    times = np.cumsum(rng.exponential(0.05, 400)).tolist()
    macs = [f"04:00:00:00:00:0{i}" for i in range(6)]
    picks = rng.integers(0, 6, 400).tolist()
    out = []
    for mod in (ra, pa):
        gate = mod.AdmissionControl(rate=8.0, burst=3.0)
        gate.assign(macs[0], "t0")
        gate.assign(macs[1], "t0")
        gate.assign(macs[2], "vip", rate=40.0)
        r0 = {t: gate.rejections(t) for t in ("t0", "vip", macs[3])}
        got = [gate.admit(macs[p], now=t) for p, t in zip(picks, times)]
        out.append((got, {t: gate.rejections(t) - r0[t] for t in r0}))
        bucket = mod.TokenBucket(rate=10.0, burst=3.0, now=0.0)
        out[-1] += ([bucket.take(t) for t in (0.0, 0.0, 0.0, 0.0, 0.05, 0.1, 0.1, 100.0)],)
    assert out[1] == out[0]
    assert 0 < sum(out[0][0]) < len(times)


def serving_stack(S, k=4, **config_kw):
    """A small wire-mode serving stack (config 14's posture)."""
    fabric = S.topogen.fattree(k).to_fabric(wire=True)
    config_kw.setdefault("proactive_collectives", False)
    ctl = S.Controller(fabric, make_config(
        S, enable_monitor=False, coalesce_routes=True, coalesce_window_s=10.0,
        **config_kw,
    ))
    ctl.attach()
    return fabric, ctl


def test_router_gate_drops_before_routing_as_the_reference():
    out = []
    for S in (REF, PORT):
        fabric, ctl = serving_stack(S, admission_rate=1e-6, admission_burst=1.0)
        macs = sorted(fabric.hosts)
        for m in macs[:2]:
            ctl.router.admission.assign(m, "t")
        h = fabric.hosts[macs[0]]
        pkt = S.of.Packet(eth_src=macs[0], eth_dst=macs[1], payload=b"x")
        r0 = ctl.router.admission.rejections("t")
        h.send(pkt)  # the burst token: routed and installed
        ctl.router.flush_routes()
        fdb = ctl.router.fdb.to_dict()
        for dpid in list(ctl.router.fdb.fdb):
            ctl.router.fdb.remove_switch(dpid)
        ctl.bus.publish(S.ev.EventPacketIn(h.dpid, h.port_no, pkt, S.of.OFP_NO_BUFFER))
        out.append((fdb, len(ctl.router._pending),
                    ctl.router.admission.rejections("t") - r0))
    assert out[1] == out[0]
    assert out[0][0] and out[0][1:] == (0, 1)


# -- the open-loop load generator -----------------------------------------


def test_loadgen_counts_match_the_reference():
    """A seeded saturation run (``pace=False``) of three tenants: one
    clipped by the gate (burst 5, no refill to speak of), one over it by
    a rate override, one alltoall storm. The offered, completed and
    rejected counts and the installed FDB equal the reference's."""
    out = []
    for S in (REF, PORT):
        import importlib

        pkg = "sdnmpi_tpu" if S is REF else "sdnmpi_tpu_torch"
        lg = importlib.import_module(f"{pkg}.control.loadgen")
        fabric, ctl = serving_stack(S, admission_rate=1e-6, admission_burst=5.0)
        macs = sorted(fabric.hosts)
        clipped, vip, agg = tuple(macs[:4]), tuple(macs[4:8]), tuple(macs[8:12])
        for m in vip:
            ctl.router.admission.assign(m, "vip", rate=1e9)
        ranks = lg.register_ranks(fabric, ctl.config, agg)
        clock = iter(np.arange(0.0, 1e4, 1e-3).tolist())
        reports = lg.LoadGen(ctl, fabric).run([
            lg.TenantSpec("clipped", rate=500.0, n_requests=30, macs=clipped),
            lg.TenantSpec("vip", rate=500.0, n_requests=30, macs=vip),
            lg.TenantSpec("agg", rate=500.0, n_requests=24, kind="alltoall",
                          macs=agg, ranks=tuple(ranks)),
        ], pace=False, now=lambda: next(clock))
        out.append((
            {n: (r.offered, r.completed, r.rejected) for n, r in reports.items()},
            ctl.router.fdb.to_dict(),
        ))
    assert out[1] == out[0]
    counts = out[0][0]
    assert counts["clipped"] == (30, 5, 25)
    assert counts["vip"] == (30, 30, 0)


# -- warm start ------------------------------------------------------------


def test_warm_serving_matches_the_reference():
    ref = _db(REF).warm_serving(shapes=(3, 100))
    db = _db(PORT)
    got = db.warm_serving(shapes=(3, 100))
    assert (got["shapes"], got["max_len"]) == (ref["shapes"], ref["max_len"]) == ([8, 104], 8)
    assert got["warm_s"] > 0
    assert _registry(PORT).get("serving_warmup_seconds").value == got["warm_s"]
    macs = sorted(db.hosts)
    assert int(db.find_routes_batch_dispatch([(macs[0], macs[-1])]).reap().hop_len[0]) > 0
    assert PORT.topogen.fattree(4).to_topology_db(backend="py").warm_serving() == {
        "warm_s": 0.0, "shapes": [], "max_len": 0,
    }


def test_enable_compile_cache_moves_the_build_directory(tmp_path, monkeypatch):
    from sdnmpi_tpu_torch.kernels import _build
    from sdnmpi_tpu_torch.oracle.engine import enable_compile_cache

    monkeypatch.setattr(_build, "_BUILD", _build._BUILD)
    assert not enable_compile_cache("")
    assert enable_compile_cache(str(tmp_path / "cc"))
    assert (tmp_path / "cc").is_dir()
    for name in _build.SOURCES:
        assert _build.library_path(name).parent == (tmp_path / "cc").resolve()


def test_a_restarted_process_loads_instead_of_building(tmp_path, monkeypatch):
    """A library an earlier process built is loaded, not built: a
    compile-cache hit, once per process."""
    from sdnmpi_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "_BUILD", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_built", set())
    loaded = []
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loaded.append(path) or path)
    lib = _build.library_path("bfs")
    lib.write_bytes(b"")
    reg = _registry(PORT)
    hits, misses = (reg.get(n).value for n in (
        "compile_cache_hits_total", "compile_cache_misses_total"))
    assert _build.load("bfs") == str(lib)
    assert _build.load("bfs") == str(lib)
    assert loaded == [str(lib)]
    assert reg.get("compile_cache_hits_total").value == hits + 1
    assert reg.get("compile_cache_misses_total").value == misses

"""The port's SLO plane against the JAX package's.

Target parsing, the multi-window burn-rate trigger on the same registry
snapshots, the dominant-stage attribution of the same span trees, and
the Router's per-tenant latency feed must agree with the reference's.
``tests/test_slo.py``'s end-to-end soak (a victim trickle against an
aggressor alltoall storm, bracketed by two Monitor passes) freezes an
SLO bundle naming the victim and its dominant stage in both packages;
its latencies are wall-clock readings, so the soak compares what fired
and what the bundle names, not the values.
"""

import importlib

import numpy as np
import pytest

from tests.test_torch_control import PORT, REF

SPECS = ["victim:50:0.99", "t0:25", "bulk:200:0.5", "", "t0", ":50", "t0:0",
         "t0:50:1.5", "t0:50:0", "a:b", "x:1:2:3"]


def mod(S, name):
    pkg = "sdnmpi_tpu" if S is REF else "sdnmpi_tpu_torch"
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _registries():
    for S in (REF, PORT):
        mod(S, "utils.metrics").REGISTRY.reset()
    yield
    for S in (REF, PORT):
        mod(S, "utils.metrics").REGISTRY.reset()


def _parse(S, spec):
    try:
        t = mod(S, "control.slo").parse_slo_target(spec)
    except ValueError as e:
        return ("ValueError", str(e))
    return (t.tenant, t.p99_ms, t.availability)


@pytest.mark.parametrize("spec", SPECS)
def test_targets_parse_as_the_reference(spec):
    assert _parse(PORT, spec) == _parse(REF, spec)


def _snap(S, tenant, counts, rejected=0):
    buckets = list(mod(S, "utils.metrics").LATENCY_BUCKETS_S)
    hist = mod(S, "control.slo").LATENCY_HIST
    return {
        "counters": {f"admission_rejections_total{{tenant={tenant}}}": rejected},
        "histograms": {f"{hist}{{tenant={tenant}}}": {
            "buckets": buckets, "counts": list(counts), "sum": 0.0,
            "count": sum(counts)}},
    }


def test_burn_trigger_matches_the_reference():
    """A seeded walk of interval histograms and rejections through one
    SLOBurn per package: every check (fired or not, and its detail),
    with a slow window over the snapshot ring."""
    def walk(S):
        slo = mod(S, "control.slo")
        n = len(mod(S, "utils.metrics").LATENCY_BUCKETS_S) + 1
        burn = slo.SLOBurn(slo.SLOTarget("v", 5.0, 0.99), burn_factor=4.0,
                           slow_flushes=4, min_count=8)
        rng = np.random.default_rng(3)
        counts, rejected = np.zeros(n, np.int64), 0
        window, out = [], []
        prev = _snap(S, "v", counts, rejected)
        for step in range(40):
            storm = 15 <= step < 25
            add = rng.poisson(3.0 if storm else 0.4, n) if step % 5 else np.zeros(n, np.int64)
            add[:6] += rng.integers(0, 12)
            counts = counts + add
            rejected += int(rng.integers(0, 6)) if storm else 0
            cur = _snap(S, "v", counts.tolist(), rejected)
            out.append(burn.check(prev, cur, window))
            window.append((float(step), cur))
            prev = cur
        fired = dict(mod(S, "utils.metrics").REGISTRY.get(
            "slo_burn_triggers_total").values)
        return out, fired, burn.name

    ref, got = walk(REF), walk(PORT)
    assert got == ref
    assert any(d is not None for d in got[0]) and got[1] == {"v": sum(
        d is not None for d in got[0])}


def test_dominant_stage_matches_the_reference():
    rng = np.random.default_rng(8)
    trees = []
    for t in range(6):
        nodes = {}
        for sid in range(1, 9):
            parent = 0 if sid == 1 else int(rng.integers(1, sid))
            nodes[sid] = {"name": f"stage{int(rng.integers(0, 4))}",
                          "wall_ms": float(rng.uniform(0.1, 9.0)),
                          "children": [], "parent": parent}
        for sid, rec in nodes.items():
            if rec["parent"]:
                nodes[rec["parent"]]["children"].append(sid)
        trees.append({"root": 1, "nodes": nodes})
    for got_trees in (trees, []):
        assert mod(PORT, "control.slo").dominant_stage(got_trees) == mod(
            REF, "control.slo").dominant_stage(got_trees)


def _storm(S):
    """``tests/test_slo.py``'s soak: fattree(4) on the wire, coalesced
    windows, the route cache off, an SLO on the victim; a baseline pass,
    the victim trickle against the aggressor storm, the trigger pass."""
    loadgen = mod(S, "control.loadgen")
    kw = dict(enable_monitor=False, coalesce_routes=True, coalesce_window_s=10.0,
              proactive_collectives=False, route_cache=False,
              admission_burst=16.0, slo_targets={"victim": (50.0, 0.999)},
              slo_burn_factor=8.0)
    kw.update(oracle_backend="jax") if S is REF else kw.update(device="cpu")
    fabric = S.topogen.fattree(4).to_fabric(wire=True)
    ctl = S.Controller(fabric, S.Config(**kw))
    ctl.attach()
    macs = sorted(fabric.hosts)
    vic, agg = macs[:4], macs[4:12]
    for mac in vic:
        ctl.router.admission.assign(mac, "victim")
    for mac in agg:
        ctl.router.admission.assign(mac, "aggressor")
    ranks = loadgen.register_ranks(fabric, ctl.config, agg)
    ctl.bus.publish(S.ev.EventStatsFlush())
    reports = loadgen.LoadGen(ctl, fabric).run([
        loadgen.TenantSpec("victim", rate=50.0, n_requests=60, macs=vic),
        loadgen.TenantSpec("aggressor", rate=6000.0, n_requests=1800,
                           kind="alltoall", macs=agg, ranks=tuple(ranks)),
    ])
    ctl.bus.publish(S.ev.EventStatsFlush())
    bundles = [b for b in ctl.flight.bundles if b["trigger"].startswith("slo:")]
    return {
        "completed": {t: (r.offered, r.completed, r.rejected) for t, r in reports.items()},
        "triggers": [b["trigger"] for b in bundles],
        "tenant": [b["detail"]["tenant"] for b in bundles],
        "detail_keys": [sorted(b["detail"]) for b in bundles],
        "slo_keys": [sorted(b["slo"]) for b in bundles],
        "targets": [b["slo"]["targets"] for b in bundles],
        "named_stage": [b["slo"]["dominant_stage"] is not None for b in bundles],
        "fed": {t: mod(S, "utils.metrics").REGISTRY.snapshot()["histograms"].get(
            f"slo_route_latency_seconds{{tenant={t}}}", {}).get("count", 0) > 0
            for t in ("victim", "aggressor")},
    }


def test_storm_freezes_the_same_slo_bundle_as_the_reference():
    ref, got = _storm(REF), _storm(PORT)
    assert got == ref
    assert got["triggers"] == ["slo:victim"] and all(got["named_stage"])
    assert got["fed"] == {"victim": True, "aggressor": False}

"""The port's metrics timeline against the JAX package's.

The same registry operations, snapshots and clock go through both
packages' ``MetricsTimeline``: the compact rows, the multi-resolution
merge, the queried series and the Perfetto counter tracks must be equal.
``estimate_p99`` (shared with the SLO plane and the flight recorder) is
held on seeded bucket counts. Both controllers record one row per
Monitor pass, riding the flight recorder's snapshot.
"""

import importlib

import numpy as np
import pytest

from tests.test_torch_control import PORT, REF, build, diamond, ip_packet, launch_all


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


def test_constants_match_the_reference():
    ref, got = mod(REF, "utils.timeline"), mod(PORT, "utils.timeline")
    assert got.DEFAULT_TRACKS == ref.DEFAULT_TRACKS
    assert got.P99_SERIES == ref.P99_SERIES
    assert got.LABELED_CHANNELS == ref.LABELED_CHANNELS


@pytest.mark.parametrize("seed", range(4))
def test_estimate_p99_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    buckets = sorted(rng.uniform(0, 1, 12).tolist())
    for _ in range(50):
        counts = rng.integers(0, 5, 13) * (rng.random(13) < 0.5)
        assert mod(PORT, "utils.timeline").estimate_p99(buckets, counts.tolist()) == \
            mod(REF, "utils.timeline").estimate_p99(buckets, counts.tolist())


def timeline_run(S, n_ticks, maxlen):
    """Seeded counter, gauge, histogram and labeled-family updates,
    one row per tick on a fake clock."""
    metrics = mod(S, "utils.metrics")
    reg = metrics.MetricsRegistry()  # whatever else this process registered
    tl = mod(S, "utils.timeline").MetricsTimeline(
        maxlen=maxlen, registry=reg, clock=iter(range(10**6)).__next__)
    rng = np.random.default_rng(7)
    hits = reg.counter("route_cache_hits_total")
    misses = reg.counter("route_cache_misses_total")
    depth = reg.gauge("coalescer_queue_depth")
    e2e = reg.histogram("install_e2e_seconds", metrics.LATENCY_BUCKETS_S)
    div = reg.labeled_counter("fabric_divergence_total", "kind")
    slo = reg.labeled_histogram("slo_route_latency_seconds", "tenant",
                                metrics.LATENCY_BUCKETS_S)
    keep = ("route_cache_", "coalescer_queue_depth", "install_e2e_seconds",
            "fabric_divergence_total", "slo_route_latency_seconds", "ts")

    def mine(row):
        return {k: v for k, v in row.items() if k.startswith(keep)}

    rows = []
    for i in range(n_ticks):
        hits.inc(int(rng.integers(0, 9)))
        misses.inc(int(rng.integers(0, 3)))
        depth.set(float(rng.integers(0, 64)))
        for _ in range(int(rng.integers(0, 30))):
            e2e.observe(float(rng.exponential(0.01)))
            slo.labels(f"t{int(rng.integers(0, 3))}").observe(float(rng.exponential(0.02)))
        if rng.random() < 0.2:
            div.inc(str(rng.choice(["missing", "orphan"])))
        row = tl.tick()
        rows.append(mine(row))
    merged = [mine(r) for r in tl.rows()]
    series = {k: v for k, v in tl.series()["series"].items() if k.startswith(keep)}
    tracks = [(t["name"], [v for _, v in t["points"]]) for t in tl.counter_tracks()]
    return rows, merged, series, tl.series(["install_e2e_seconds_p99_ms"]), tracks


@pytest.mark.parametrize("n_ticks,maxlen", [(20, 512), (150, 8)],
                         ids=["one-level", "decimated"])
def test_rows_series_and_tracks_match_the_reference(n_ticks, maxlen):
    ref = timeline_run(REF, n_ticks, maxlen)
    got = timeline_run(PORT, n_ticks, maxlen)
    assert got == ref
    rows, merged, series, p99, tracks = got
    assert "install_e2e_seconds_p99_ms" in rows[-1] and "route_cache_hit_rate" in rows[-1]
    assert "fabric_divergence_total" in series
    assert p99["n_rows"] == len(merged) and len(tracks) >= 3
    if maxlen == 8:
        assert len(merged) > maxlen  # the coarser levels extend the span


def test_controller_rows_match_the_reference():
    """Three Monitor passes of both controllers: one row each, every
    series of the port's among the reference's, and the
    controller-state series equal."""
    def rows(S):
        # every instrument of each package registered, as in a process
        # that imported all its subsystems
        mod(S, "api.telemetry")._import_instrumented()
        fabric, ctl, _ = build(S, diamond)
        launch_all(S, fabric, ["04:00:00:00:00:01", "04:00:00:00:00:04"])
        for t in range(3):
            fabric.hosts["04:00:00:00:00:01"].send(
                ip_packet(S, "04:00:00:00:00:01", "04:00:00:00:00:04"))
            ctl.monitor.poll(now=float(t))
        out = ctl.bus.request(S.ev.TimelineRequest(None)).timeline
        return out, ctl.flight.on_snapshot is not None

    (ref, ref_tee), (got, got_tee) = rows(REF), rows(PORT)
    assert got["n_rows"] == ref["n_rows"] == 3 and got_tee and ref_tee
    assert set(got["series"]) <= set(ref["series"])
    for name in ("desired_flows", "router_packet_ins_total",
                 "audit_sweeps_total", "trafficplane_epoch"):
        assert [v for _, v in got["series"][name]] == [v for _, v in ref["series"][name]]

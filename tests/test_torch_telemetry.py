"""The port's telemetry exposition and Perfetto export against the JAX
package's.

Every instrument the port registers exists in the reference's registry
under the same name, kind and label (so the README's metrics reference,
generated from the reference, covers both packages), and the owner
table assigns it the same subsystem. The Prometheus text of the same
snapshot, and the Chrome trace of the same span records and counter
tracks, are equal. Both controllers' ``telemetry()`` snapshots carry
the same sections, and ``--metrics-dump`` / ``--trace-dump`` write them
through the launcher.
"""

import asyncio
import importlib
import json

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


def rows(S):
    return {r["name"]: r for r in mod(S, "api.telemetry").instrument_rows()}


def test_every_port_instrument_is_a_reference_instrument():
    """Name, kind, label and owner of each of the port's instruments,
    as the reference registers and owns them."""
    ref, got = rows(REF), rows(PORT)
    assert len(got) >= 110
    missing = sorted(set(got) - set(ref))
    assert not missing, missing
    for name, r in got.items():
        for key in ("kind", "label", "owner"):
            assert r[key] == ref[name][key], (name, key)
    # what the reference has beyond the port: the sharded window legs
    # and the ring's overlap (A12 items 3 and 4) and the JAX trace
    # counter; the hierarchical oracle's instruments are all here
    extra = set(ref) - set(got)
    assert all(n.startswith(("shard_", "ring_exchange_", "jit_traces_"))
               for n in extra), sorted(extra)
    assert not extra & {"ring_exchange_stall_seconds", "shard_exchange_seconds"}
    assert {n for n in ref if n.startswith("hier_")} <= set(got)


def test_owner_table_and_modules_match_the_reference():
    ref, got = mod(REF, "api.telemetry"), mod(PORT, "api.telemetry")
    assert got.METRIC_OWNERS == ref.METRIC_OWNERS
    assert [m.replace("sdnmpi_tpu_torch.", "") for m in got.INSTRUMENTED_MODULES] == [
        m.replace("sdnmpi_tpu.", "") for m in ref.INSTRUMENTED_MODULES]
    for name in list(rows(REF))[:80] + ["nope", "fabric_divergence_total"]:
        assert got.owner_of(name) == ref.owner_of(name)


def seeded_snapshot(S):
    metrics = mod(S, "utils.metrics")
    reg = metrics.MetricsRegistry()
    rng = np.random.default_rng(4)
    reg.counter("a_total").inc(3)
    reg.gauge("g").set(2.5)
    lc = reg.labeled_counter("fabric_divergence_total", "kind")
    lc.inc("missing", 2)
    lc.inc('we"ird\\kind')
    h = reg.histogram("install_e2e_seconds", metrics.LATENCY_BUCKETS_S)
    lh = reg.labeled_histogram("slo_route_latency_seconds", "tenant",
                               metrics.LATENCY_BUCKETS_S)
    for _ in range(50):
        h.observe(float(rng.exponential(0.01)))
        lh.labels("t{1}").observe(float(rng.exponential(0.02)))
    snap = reg.snapshot()
    snap["oracle"] = {"find_route": {"count": 3, "mean_ms": 1.25, "p99_ms": 2.0}}
    return snap


def test_prometheus_text_matches_the_reference():
    ref = mod(REF, "api.telemetry").render(seeded_snapshot(REF))
    got = mod(PORT, "api.telemetry").render(seeded_snapshot(PORT))
    assert got == ref
    assert 'fabric_divergence_total{kind="we\\"ird\\\\kind"} 1' in got
    assert 'slo_route_latency_seconds_bucket{tenant="t{1}",le="+Inf"} 50' in got


def span_stream(seed):
    rng = np.random.default_rng(seed)
    recs, t = [], 100.0
    for sid in range(1, 30):
        parent = 0 if sid % 6 == 1 else int(rng.integers(max(1, sid - 5), sid))
        t0 = t + float(rng.uniform(0, 0.01))
        recs.append({"kind": "span", "span": sid, "parent": parent,
                     "name": f"stage{sid % 4}", "t0": t0,
                     "t1": t0 + float(rng.uniform(0, 0.02)), "wall_ms": 1.0,
                     "pairs": int(rng.integers(0, 9))})
        t += 0.005
    recs.append({"kind": "span_link", "span": 8, "parent": 2})
    recs.append({"kind": "oracle", "op": "x"})
    counters = [{"name": "route_cache_hit_rate",
                 "points": [[100.0 + i, 0.1 * i] for i in range(5)]},
                {"name": "empty", "points": []}]
    return recs, counters


@pytest.mark.parametrize("seed", [0, 1])
def test_chrome_trace_matches_the_reference(seed):
    recs, counters = span_stream(seed)
    for c in (counters, None):
        got = mod(PORT, "api.traceview").chrome_trace(recs, counters=c)
        assert got == mod(REF, "api.traceview").chrome_trace(recs, counters=c)
    phases = {e["ph"] for e in got["traceEvents"]}
    assert {"X", "M"} <= phases
    assert mod(PORT, "api.traceview").chrome_trace([]) == mod(
        REF, "api.traceview").chrome_trace([])


def test_controller_snapshots_carry_the_reference_sections():
    def snap(S):
        fabric, ctl, _ = build(S, diamond)
        launch_all(S, fabric, ["04:00:00:00:00:01", "04:00:00:00:00:04"])
        fabric.hosts["04:00:00:00:00:01"].send(
            ip_packet(S, "04:00:00:00:00:01", "04:00:00:00:00:04"))
        ctl.monitor.poll(now=0.0)
        ctl.monitor.poll(now=1.0)
        s = ctl.telemetry()
        return sorted(s), s["counters"]

    (ref_keys, ref_c), (got_keys, got_c) = snap(REF), snap(PORT)
    assert got_keys == ref_keys
    for name in ("router_packet_ins_total", "audit_sweeps_total",
                 "trafficplane_flushes_total", "sentinel_sweeps_total",
                 "monitor_passes_total"):
        assert got_c[name] == ref_c[name], name


def test_launcher_dumps_metrics_and_perfetto_trace(tmp_path, monkeypatch):
    """``--metrics-dump`` and ``--trace-dump`` through the port's
    launcher: the exposition lists the registry's instruments, the trace
    loads with span slices."""
    from sdnmpi_tpu_torch import launch

    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--topo", "fattree:4", "--demo", "--no-rpc",
            "--duration", "0.05", "--metrics-dump", str(tmp_path / "m.txt"),
            "--trace-dump", str(tmp_path / "t.json")]
    asyncio.run(launch.amain(launch.build_parser().parse_args(argv)))
    text = (tmp_path / "m.txt").read_text()
    for name in ("router_packet_ins_total", "audit_sweeps_total",
                 "install_e2e_seconds_bucket", "trafficplane_epoch"):
        assert name in text, name
    trace = json.loads((tmp_path / "t.json").read_text())
    assert any(e.get("ph") == "X" for e in trace["traceEvents"])

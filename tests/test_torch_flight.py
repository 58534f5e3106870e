"""The port's flight recorder against the JAX package's.

Both recorders get the same span records (the trace stream a recorder
tees), the same registry operations, clock and bus events: the retained
trees, the trigger passes, the frozen bundles and their dump files must
be equal. Both controllers, armed by default, freeze the same bundles
under the same triggers for the same scenario, and the RPC mirror
encodes replies with the flight recorder's ``json_default``.
"""

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
        rec = mod(S, "utils.flight").RECORDER
        if rec is not None:
            rec.disarm()
    yield
    for S in (REF, PORT):
        mod(S, "utils.metrics").REGISTRY.reset()
        rec = mod(S, "utils.flight").RECORDER
        if rec is not None:
            rec.disarm()


def span_records(seed, n_roots=12):
    """A seeded span stream: roots with nested children ending before
    and after their parents, links, and non-span records."""
    rng = np.random.default_rng(seed)
    out, sid = [], 0
    for _ in range(n_roots):
        sid += 1
        root = sid
        kids = []
        for _ in range(int(rng.integers(1, 5))):
            sid += 1
            kids.append(sid)
            parent = root if not kids[:-1] or rng.random() < 0.5 else int(rng.choice(kids[:-1]))
            out.append({"kind": "span", "span": sid, "parent": parent,
                        "name": f"stage{int(rng.integers(0, 3))}",
                        "wall_ms": round(float(rng.uniform(0, 5)), 3)})
        if rng.random() < 0.3:
            out.append({"kind": "span_link", "span": kids[0], "parent": root})
        late = out.pop() if rng.random() < 0.3 else None
        out.append({"kind": "span", "span": root, "parent": 0, "name": "root",
                    "wall_ms": 9.0})
        if late is not None:
            out.append(late)  # a child ending after its root
        out.append({"kind": "oracle", "op": "x"})
    return out


def recorder_run(S, seed, tmp_path):
    fl = mod(S, "utils.flight")
    reg = mod(S, "utils.metrics").MetricsRegistry()
    t = iter(range(10**6))
    rec = fl.FlightRecorder(max_trees=5, max_snapshots=4, registry=reg,
                            dump_dir=str(tmp_path / S.ev.__name__.split(".")[0]),
                            clock=lambda: float(next(t)))
    rec.add_counter_triggers()
    hist = reg.histogram("install_e2e_seconds", mod(S, "utils.metrics").LATENCY_BUCKETS_S)
    rec.triggers.append(fl.HistogramThreshold("install_e2e_seconds", 0.05))
    rec.triggers.append(fl.P99Regression("install_e2e_seconds", factor=3.0))
    rec.add_context("static", lambda: {"k": 1, "s": {3, 1}})
    for r in span_records(seed):
        rec.record(r)
    rng = np.random.default_rng(seed)
    fired = []
    for step in range(14):
        for _ in range(20):
            hist.observe(float(rng.exponential(0.004 if step < 9 else 0.08)))
        if step in (4, 11):
            reg.counter("install_resyncs_total").inc()
        rec.event_tap(S.ev.EventStatsFlush())
        fired += [(b["trigger"], b["detail"]) for b in rec.snapshot_tick(now=float(step))]
    manual = rec.freeze("manual", {"why": "test"})
    files = sorted(p.name for p in (tmp_path / S.ev.__name__.split(".")[0]).iterdir())
    return {
        "trees": rec.trees(),
        "tree_for": [rec.tree_for(i) for i in (1, 2, 5, 40)],
        "fired": fired,
        "manual_keys": sorted(manual),
        "context": manual["static"],
        "events": manual["events_tail"][-3:],
        "files": [f.split("-")[0] for f in files],
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recorder_matches_the_reference(seed, tmp_path):
    ref = recorder_run(REF, seed, tmp_path / "ref")
    got = recorder_run(PORT, seed, tmp_path / "port")
    assert got == ref
    assert got["trees"] and got["fired"]
    assert {t for t, _ in got["fired"]} >= {"counter:install_resyncs_total"}


def test_json_default_is_the_rpc_mirrors_encoder():
    """The RPC mirror encodes replies with the flight recorder's
    ``json_default`` (its own copy is gone), which encodes like the
    reference's."""
    import inspect

    fl, rpc = mod(PORT, "utils.flight"), mod(PORT, "api.rpc")
    assert "from sdnmpi_tpu_torch.utils.flight import json_default" in inspect.getsource(rpc)
    assert not hasattr(rpc, "json_default")
    import torch

    values = [np.float32(1.5), np.int64(3), {2, 1}, frozenset({"b", "a"}),
              np.arange(3), torch.tensor(2.5), torch.arange(2), object]
    ref = mod(REF, "utils.flight").json_default
    for v in values[:5]:
        assert fl.json_default(v) == ref(v)
    assert fl.json_default(values[5]) == 2.5 and fl.json_default(values[6]) == [0, 1]
    assert fl.json_default(object) == repr(object)


def scenario(S):
    """The diamond at both packages' defaults with a low latency
    threshold: routed pairs between two Monitor passes freeze a latency
    bundle, and a forced resync a counter bundle."""
    fabric, ctl, _ = build(S, diamond, flight_latency_threshold_s=1e-9,
                           flight_p99_factor=0.0, coalesce_routes=True)
    ctl.flight.clock = iter(range(10**6)).__next__
    launch_all(S, fabric, ["04:00:00:00:00:01", "04:00:00:00:00:04"])
    ctl.monitor.poll(now=0.0)
    fabric.hosts["04:00:00:00:00:01"].send(
        ip_packet(S, "04:00:00:00:00:01", "04:00:00:00:00:04"))
    ctl.monitor.poll(now=1.0)
    mod(S, "utils.metrics").REGISTRY.counter("install_resyncs_total").inc()
    ctl.monitor.poll(now=2.0)
    bundles = ctl.flight.bundles
    return {
        "triggers": [b["trigger"] for b in bundles],
        "keys": [sorted(b) for b in bundles],
        "contexts": [sorted(b["topology"]) for b in bundles],
        "detail": [b["detail"] for b in bundles if b["trigger"].startswith("counter")],
        "tree_names": sorted({n["name"] for t in ctl.flight.trees()
                              for n in t["nodes"].values()}),
    }


def test_controller_bundles_match_the_reference():
    ref, got = scenario(REF), scenario(PORT)
    assert got["triggers"] == ref["triggers"]
    assert got["keys"] == ref["keys"] and got["contexts"] == ref["contexts"]
    assert got["detail"] == ref["detail"]
    assert any(t.startswith("latency:") for t in got["triggers"])
    assert "counter:install_resyncs_total" in got["triggers"]
    # the port's spans are the reference's, less the JAX trace records
    assert set(got["tree_names"]) <= set(ref["tree_names"]) and got["tree_names"]


def test_anomaly_opens_and_a_later_flush_closes_the_profile_capture(tmp_path):
    """``--profile-dump``: a firing trigger opens a ``torch.profiler``
    window, and the first Monitor pass past ``profile_capture_s`` closes
    it and writes the Chrome trace, as the reference's does with its
    JAX profile."""
    fabric, ctl, _ = build(PORT, diamond, flight_latency_threshold_s=1e-9,
                           coalesce_routes=True, profile_capture_s=0.0,
                           profile_dump_dir=str(tmp_path / "prof"))
    cap = ctl.profile_capture
    launch_all(PORT, fabric, ["04:00:00:00:00:01", "04:00:00:00:00:04"])
    ctl.monitor.poll(now=0.0)
    assert not cap.active
    fabric.hosts["04:00:00:00:00:01"].send(
        ip_packet(PORT, "04:00:00:00:00:01", "04:00:00:00:00:04"))
    ctl.monitor.poll(now=1.0)
    assert ctl.flight.bundles and cap.n_captures == 1
    assert not cap.active  # the same pass's tick closed it (0 s window)
    files = list((tmp_path / "prof").iterdir())
    assert len(files) == 1 and files[0].name.startswith("anomaly-")
    assert json.loads(files[0].read_text())["traceEvents"] is not None

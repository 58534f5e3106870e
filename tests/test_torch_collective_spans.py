"""Stage spans of the oracle's collective path, on the profiler's clock.

A flat balanced collective and a phased one on a k=4 fat-tree, run under
``torch.profiler``, show every stage as an ``sdnmpi.*`` range, nested as
the spans are: the stages inside their ``collective`` or
``collective_reap``, the phases' ``collective`` inside ``phased`` and,
after them, the ``enqueue`` that launches the phases' scans together, no
stage inside another. A list sink sees the same spans with the same
parent links; with neither armed no span is live; and the routes are
bit-equal with tracing on and off.
"""

import numpy as np
import pytest
import torch

from sdnmpi_tpu_torch.topogen import fattree
from sdnmpi_tpu_torch.utils import tracing
from sdnmpi_tpu_torch.utils.metrics import CURRENT_SPAN

#: each span of the path by the span that holds it (None: the caller's)
FLAT = {
    "collective": None, "resolve": "collective", "group": "collective",
    "deal": "collective", "enqueue": "collective", "base": "collective",
    "collective_reap": None, "wait": "collective_reap",
    "decode": "collective_reap", "fdbs": "collective_reap",
    "congestion": "collective_reap",
}
#: the phased program: the scanner's phases have no slot decode, and
#: ``enqueue`` is both a phase's stage and the program's own last one
PHASED = {
    **{k: v for k, v in FLAT.items() if k != "decode"},
    "phased": None, "pack": "phased", "collective": "phased",
    "enqueue": ("collective", "phased"),
}
LEAVES = {"resolve", "group", "deal", "enqueue", "base", "wait", "decode", "fdbs",
          "congestion", "pack"}


@pytest.fixture(autouse=True)
def _no_sinks(monkeypatch):
    """No sink an earlier test of the process left armed (a Controller's
    flight recorder tees into the span stream): each test arms its own."""
    monkeypatch.setattr(tracing, "_sink", None)
    monkeypatch.setattr(tracing, "_extra_sinks", [])


def _collective():
    db = fattree(4).to_topology_db(backend="torch", device="cpu")
    macs = sorted(db.hosts)
    src, dst = np.nonzero(~np.eye(len(macs), dtype=bool))
    return db, macs, src.astype(np.int32), dst.astype(np.int32)


def _route(phased: bool):
    """One collective through the engine (no route cache); returns what
    a caller reads of it."""
    db, macs, src, dst = _collective()
    oracle = db._oracle_engine()
    if phased:
        program = oracle.routes_collective_phased(db, macs, src, dst, "balanced")
        routes = [plan.reap() for plan in program.phases]
        return {"pair_phase": program.pair_phase, "routes": routes}
    return {"pair_phase": None,
            "routes": [oracle.routes_collective(db, macs, src, dst, "balanced")]}


def _ranges(prof) -> list:
    """``(name, start, end)`` of every ``sdnmpi.*`` range the profiler
    kept on the host."""
    from torch.autograd import DeviceType

    return sorted(
        ((ev.name()[len(tracing.RANGE_PREFIX):], ev.start_ns(),
          ev.start_ns() + ev.duration_ns())
         for ev in prof.profiler.kineto_results.events()
         if ev.name().startswith(tracing.RANGE_PREFIX)
         and ev.device_type() == DeviceType.CPU),
        key=lambda r: (r[1], -r[2]))


def _holders(ranges) -> list:
    """Each range's name beside the name of the innermost range that
    holds it (None where none does)."""
    out = []
    for i, (name, s, e) in enumerate(ranges):
        held = [r for j, r in enumerate(ranges) if j != i and r[1] <= s and e <= r[2]]
        inner = min(held, key=lambda r: r[2] - r[1], default=None)
        out.append((name, None if inner is None else inner[0]))
    return out


def _profiled(phased: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        got = _route(phased)
    return got, _ranges(prof)


@pytest.mark.parametrize("phased", [False, True], ids=["flat", "phased"])
def test_stages_are_profiler_ranges_nested_as_the_spans(phased):
    want = PHASED if phased else FLAT
    _, ranges = _profiled(phased)
    holders = _holders(ranges)
    assert {name for name, _ in holders} == set(want)
    for name, holder in holders:
        allowed = want[name] if isinstance(want[name], tuple) else (want[name],)
        assert holder in allowed, (name, holder)
        assert holder not in LEAVES
    # the flat dispatch's stages in order: the hop budget, the base, the device leg
    order = [n for n, h in holders if h == "collective"]
    assert order[:6] == ["resolve", "group", "deal", "enqueue", "base", "enqueue"]
    if phased:
        n_phases = sum(n == "collective" for n, _ in holders)
        assert n_phases >= 2
        assert sum(n == "collective_reap" for n, _ in holders) == n_phases


@pytest.mark.parametrize("phased", [False, True], ids=["flat", "phased"])
def test_a_sink_sees_the_same_spans_and_links(phased):
    _, ranges = _profiled(phased)
    records = []
    tracing.add_trace_sink(records.append)
    try:
        _route(phased)
    finally:
        tracing.remove_trace_sink(records.append)
    spans = {r["span"]: r for r in records if r["kind"] == "span"}
    linked = sorted((r["name"], spans[r["parent"]]["name"] if r["parent"] in spans else None)
                    for r in spans.values())
    assert linked == sorted(_holders(ranges))
    fields = [r for r in spans.values() if r["name"] in ("collective", "collective_reap")]
    assert all(r["policy"] == "balanced" and r["n_pairs"] > 0 for r in fields)
    assert all(("phase" in r) == phased for r in fields)
    assert all(r["t0"] <= r["t1"] for r in spans.values())


def test_phased_enqueue_follows_the_phases():
    """The phased program's own stages: ``pack``, then every phase's
    ``collective``, then one ``enqueue`` that uploads the phases' scanner
    tables and launches them together."""
    _, ranges = _profiled(True)
    order = [n for n, h in _holders(ranges) if h == "phased"]
    n_phases = order.count("collective")
    assert n_phases >= 2
    assert order == ["pack"] + ["collective"] * n_phases + ["enqueue"]


def test_no_span_is_live_with_neither_armed():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.start_span("collective") is tracing.NULL_SPAN
    assert tracing.start_child_span("resolve") is tracing.NULL_SPAN
    with tracing.Stages(tracing.start_child_span("collective")) as st:
        st.stage("resolve")
        assert st.span is tracing.NULL_SPAN and st._stage is tracing.NULL_SPAN


@pytest.mark.parametrize("phased", [False, True], ids=["flat", "phased"])
def test_routes_are_bit_equal_with_tracing_on_and_off(phased):
    off = _route(phased)
    records = []
    tracing.add_trace_sink(records.append)
    try:
        on, _ = _profiled(phased)
    finally:
        tracing.remove_trace_sink(records.append)
    assert records
    if phased:
        np.testing.assert_array_equal(on["pair_phase"], off["pair_phase"])
    assert len(on["routes"]) == len(off["routes"])
    for a, b in zip(on["routes"], off["routes"]):
        for field in ("pair_sub", "final_port", "hop_dpid", "hop_port", "hop_len",
                      "endpoint_port"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert a.max_congestion == b.max_congestion


def test_stages_end_when_the_call_raises():
    """A stage open when the body raises ends with its span, and the
    ambient span is the caller's again."""
    records = []
    tracing.add_trace_sink(records.append)
    try:
        root = tracing.start_span("route_window")
        with pytest.raises(RuntimeError):
            with tracing.Stages(tracing.start_child_span("collective")) as st:
                st.stage("resolve")
                raise RuntimeError("refused")
        assert CURRENT_SPAN[0] == root.id
        root.end()
    finally:
        tracing.remove_trace_sink(records.append)
    by_name = {r["name"]: r for r in records if r["kind"] == "span"}
    assert by_name["resolve"]["parent"] == by_name["collective"]["span"]
    assert by_name["collective"]["parent"] == by_name["route_window"]["span"]


def test_a_range_may_end_after_the_profiler_stops_and_out_of_order():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        parked = tracing.start_span("parked")
        inner = tracing.start_span("inner", parent=parked)
        parked.end()  # before its child: out of LIFO order
        late = tracing.start_span("late")
    inner.end()
    late.end()
    names = {name for name, _, _ in _ranges(prof)}
    assert "parked" in names
    assert tracing.start_span("after") is tracing.NULL_SPAN

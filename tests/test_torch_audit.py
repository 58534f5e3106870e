"""The port's fabric audit plane against the JAX package's.

Both controllers (the reference on backend ``"jax"``, the port on
``device="cpu"``) audit the same wire-mode fat-tree with the same routed
pairs, pumped traffic and seeded table mutations
(``control/faults.FaultPlan``), in the scenarios of
``tests/test_audit.py``. Their confirmed divergences, heals, forensics,
windowed reports, flow tables and registry counters must be equal.
"""

import importlib

import pytest

from tests.test_torch_control import PORT, REF

MUTATIONS = ("drop_row", "insert_row", "blackhole", "freeze")


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


def make(S, **overrides):
    """``tests/test_audit.py``'s stack: fattree(4) on the wire, the audit
    full-fabric, eight routed ring pairs."""
    kw = dict(coalesce_routes=True, audit_switches_per_flush=0,
              audit_confirm_sweeps=2, install_retry_backoff_s=0.0,
              barrier_timeout_s=0.0)
    kw.update(overrides)
    if S is REF:
        kw["oracle_backend"] = "jax"
    else:
        kw["device"] = "cpu"
    fabric = S.topogen.fattree(4).to_fabric(wire=True)
    ctl = S.Controller(fabric, S.Config(**kw))
    ctl.attach()
    macs = sorted(fabric.hosts)
    pairs = [(macs[i], macs[(i + 1) % len(macs)]) for i in range(8)]
    ctl.router.reinstall_pairs(pairs)
    return fabric, ctl, pairs


def sweep(S, ctl, fabric, pairs, traffic=True):
    if traffic:
        for src, dst in pairs:
            fabric.hosts[src].send(S.of.Packet(src, dst, S.of.ETH_TYPE_IP))
    ctl.bus.publish(S.ev.EventStatsFlush())


def tables(fabric):
    return {
        d: sorted((e.priority, repr(e.match), repr(e.actions), e.cookie,
                   e.packet_count, e.byte_count, getattr(e, "frozen", False))
                  for e in sw.flow_table)
        for d, sw in sorted(fabric.switches.items())
    }


def counters(S, prefixes=("audit_", "fabric_")):
    snap = mod(S, "utils.metrics").REGISTRY.snapshot()["counters"]
    return {k: v for k, v in snap.items() if k.startswith(prefixes)}


def audit_state(S, fabric, ctl, plan=None):
    audit = ctl.audit
    report = audit.report()
    report.pop("window_s")
    report.pop("tenant_bps")
    return {
        "recent": [{k: v for k, v in r.items() if k != "ts"}
                   for r in audit.recent],
        "forensics": {k: v for k, v in audit.forensics().items()
                      if k != "recent"},
        "report": report,
        "counters": counters(S),
        "tables": tables(fabric),
        "mutations": None if plan is None else list(plan.mutations),
        "bundles": [b["trigger"] for b in ctl.flight.bundles],
    }


def assert_twins(scenario, *args):
    ref, got = scenario(REF, *args), scenario(PORT, *args)
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key] == ref[key], key
    return got


@pytest.mark.parametrize("kind", MUTATIONS)
def test_each_mutation_detected_and_healed_as_the_reference(kind):
    """One seeded mutation of each kind, confirmed after two sweeps and
    healed by a targeted re-drive, in both packages alike."""
    def scenario(S):
        fabric, ctl, pairs = make(S)
        sweep(S, ctl, fabric, pairs)
        sweep(S, ctl, fabric, pairs)
        plan = mod(S, "control.faults").FaultPlan(
            seed=5, mutate_priority=ctl.config.priority_default).attach(fabric)
        rec = plan.mutate(kind=kind)
        assert rec is not None and rec[1] == kind
        for _ in range(5):
            sweep(S, ctl, fabric, pairs)
        return audit_state(S, fabric, ctl, plan)

    got = assert_twins(scenario)
    expect = {"drop_row": "missing", "insert_row": "orphan",
              "blackhole": "missing", "freeze": "counter_dead"}[kind]
    assert got["counters"][f"fabric_divergence_total{{kind={expect}}}"] == 1
    assert "fabric:divergence" in got["bundles"]


@pytest.mark.parametrize("seed", [42, 7])
def test_mutation_soak_matches_the_reference(seed):
    """``tests/test_audit.py``'s soak: a seeded plan mutating half its
    steps over 24 sweeps, quiesced, then swept to convergence. Every
    confirmed divergence, heal, named row and final table is equal."""
    def scenario(S):
        fabric, ctl, pairs = make(S)
        sweep(S, ctl, fabric, pairs)
        plan = mod(S, "control.faults").FaultPlan(
            seed=seed, p_mutate=0.5,
            mutate_priority=ctl.config.priority_default).attach(fabric)
        for _ in range(24):
            plan.step()
            sweep(S, ctl, fabric, pairs)
        plan.quiesce()
        for _ in range(13):
            sweep(S, ctl, fabric, pairs)
        return audit_state(S, fabric, ctl, plan)

    got = assert_twins(scenario)
    assert got["mutations"]
    assert sum(v for k, v in got["counters"].items()
               if k.startswith("fabric_divergence_total")) == len(got["mutations"])


def test_paced_sweeps_and_attribution_match_the_reference():
    """Paced sweeps (3 switches a flush) with tenants assigned: the
    cursor, cycle, tenant byte roll-ups and the windowed report."""
    def scenario(S):
        fabric, ctl, pairs = make(S, audit_switches_per_flush=3)
        ctl.router.admission.assign(pairs[0][0], "t0")
        ctl.router.admission.assign(pairs[1][0], "t1")
        for _ in range(16):
            sweep(S, ctl, fabric, pairs)
        out = audit_state(S, fabric, ctl)
        out["cursor"] = (ctl.audit._cursor, ctl.audit.cycle)
        return out

    got = assert_twins(scenario)
    assert got["cursor"][1] >= 2 and got["report"]["tenant_bytes"]


def test_checkpointed_baselines_restore_across_packages():
    """The audit baselines a checkpoint carries restore into the other
    package's audit: the first sweep after the restore attributes only
    the new bytes, as in the writer's own package."""
    def writer(S):
        fabric, ctl, pairs = make(S)
        for _ in range(3):
            sweep(S, ctl, fabric, pairs)
        return mod(S, "api.snapshot").snapshot_controller(ctl)

    for w, r in ((REF, PORT), (PORT, REF)):
        snap = writer(w)
        fabric, ctl, pairs = make(r)
        # the reader's fabric starts with the writer's counters
        for _ in range(3):
            for src, dst in pairs:
                fabric.hosts[src].send(r.of.Packet(src, dst, r.of.ETH_TYPE_IP))
        mod(r, "api.snapshot").restore_controller(ctl, snap)
        assert ctl.audit.cycle == snap["audit_baselines"]["cycle"]
        assert sorted(
            [d, s, t, p, b] for d, tab in ctl.audit._counters.items()
            for (s, t), (p, b) in tab.items()
        ) == sorted(snap["audit_baselines"]["rows"])

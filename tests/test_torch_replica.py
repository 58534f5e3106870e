"""The port's controller pair (ownership, fencing, replication, lease
failover) against the JAX package's.

Both packages build the pair of ``tests/test_replica.py`` over the same
fabric with the same deterministic clock, packets, drops and kills; the
flow tables (cookies included), the desired stores, the replica status,
the ownership maps and the replica counters must be equal. The chaos
acceptance runs ``tests/test_replica.py``'s seeded storm with a peer
killed mid-storm in both. ``mesh_replica_index`` reads the
``torch.distributed`` rank where the reference reads
``jax.process_index()``: 0 without a process group.
"""

import importlib

import numpy as np
import pytest

from tests.test_torch_control import PORT, REF, announce, diamond, ip_packet

FAST_RECOVERY = dict(install_retry_backoff_s=0.0, barrier_timeout_s=0.0,
                     install_retry_max=3)


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


class Clock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def make_pair(S, fabric=None, clock=None, backend="py", **overrides):
    fabric = diamond(S) if fabric is None else fabric
    kw = dict(coalesce_routes=True, **{**FAST_RECOVERY, **overrides})
    if backend == "py":
        kw["oracle_backend"] = "py"
    elif S is REF:
        kw["oracle_backend"] = "jax"
    else:
        kw["device"] = "cpu"
    pair = mod(S, "control.replica").build_pair(
        fabric, S.Config(**kw), clock=clock or Clock())
    pair.attach()
    return fabric, pair


def tick_pair(pair, n=3):
    for _ in range(n):
        for i, c in enumerate(pair.controllers):
            if i not in pair.mux.dead:
                c.replica.tick()


def flows(fabric):
    return sorted(
        (d, e.match.dl_src, e.match.dl_dst, repr(e.actions), e.priority, e.cookie)
        for d, sw in fabric.switches.items() for e in sw.flow_table
        if e.match.dl_src is not None
    )


def desired(ctl):
    return {d: {k: repr(v) for k, v in t.items()}
            for d, t in sorted(ctl.router.recovery.desired.flows.items())}


def counters(S, prefixes=("replica_", "replication_", "ownership_", "audit_heals",
                          "fabric_divergence")):
    snap = mod(S, "utils.metrics").REGISTRY.snapshot()
    out = {k: v for k, v in snap["counters"].items() if k.startswith(prefixes)}
    out.update({k: v for k, v in snap["gauges"].items() if k.startswith(prefixes)})
    return out


def pair_state(S, fabric, pair):
    return {
        "flows": flows(fabric),
        "desired": [desired(c) for c in pair.controllers],
        "status": [c.replica.status() for c in pair.controllers],
        "ownership": [c.ownership.to_dict() for c in pair.controllers],
        "ranks": [c.process_manager.rankdb.ranks() for c in pair.controllers],
        "counters": counters(S),
    }


def test_ownership_and_cookies_match_the_reference():
    ref, got = mod(REF, "control.ownership"), mod(PORT, "control.ownership")
    for shard, epoch in ((0, 0), (1, 7), (513, 2**24 + 3), (65535, 1)):
        tok = got.cookie_token(shard, epoch)
        assert tok == ref.cookie_token(shard, epoch)
        assert got.decode_cookie(tok) == ref.decode_cookie(tok)
        assert got.is_owner_cookie(tok) and not got.is_owner_cookie(shard)
    om_r, om_g = ref.OwnershipMap(3, 1), got.OwnershipMap(3, 1)
    for om in (om_r, om_g):
        om.adopt(2)
        om.adopt(2)
    assert om_g.to_dict() == om_r.to_dict()
    assert [om_g.cookie_token(d) for d in range(12)] == [
        om_r.cookie_token(d) for d in range(12)]
    with pytest.raises(ValueError):
        got.OwnershipMap(2, 2)


def test_mesh_replica_index_reads_the_process_group(monkeypatch):
    """0 without ``torch.distributed``; the group's rank modulo the
    count when one is initialized."""
    import torch.distributed as dist

    own = mod(PORT, "control.ownership")
    assert not dist.is_initialized()
    assert own.mesh_replica_index(2) == 0 == own.mesh_replica_index(1)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    assert own.mesh_replica_index(2) == 1 and own.mesh_replica_index(4) == 3


@pytest.mark.parametrize("backend", ["py", "device"])
def test_pair_converges_and_stamps_as_the_reference(backend):
    def scenario(S):
        fabric, pair = make_pair(S, backend=backend)
        m1, m2, m3, m4 = (f"04:00:00:00:00:0{i}" for i in (1, 2, 3, 4))
        announce(S, fabric, m1, "LAUNCH", 0)
        fabric.hosts[m1].send(ip_packet(S, m1, m4))
        # swallow replica 0's next op batch: the peer sees the sequence
        # jump and backfills from a snapshot
        pair.links[0].drop_next = 1
        tick_pair(pair, n=1)
        fabric.hosts[m4].send(ip_packet(S, m4, m1))
        tick_pair(pair, n=4)
        announce(S, fabric, m4, "LAUNCH", 1)
        fabric.hosts[m2].send(ip_packet(S, m2, m3))
        tick_pair(pair)
        return pair_state(S, fabric, pair)

    ref, got = scenario(REF), scenario(PORT)
    assert got == ref
    assert got["flows"] and got["counters"]["replica_seq_gaps_total"] >= 1


@pytest.mark.parametrize("victim", [0, 1])
def test_failover_matches_the_reference(victim):
    def scenario(S):
        clock = Clock()
        fabric, pair = make_pair(S, clock=clock)
        for rank, h in enumerate((1, 4)):
            announce(S, fabric, f"04:00:00:00:00:0{h}", "LAUNCH", rank)
        fabric.hosts["04:00:00:00:00:01"].send(
            ip_packet(S, "04:00:00:00:00:01", "04:00:00:00:00:04"))
        fabric.hosts["04:00:00:00:00:04"].send(
            ip_packet(S, "04:00:00:00:00:04", "04:00:00:00:00:01"))
        tick_pair(pair)
        pair.kill(victim)
        surv = pair.survivor()
        clock.t = 10.0
        surv.replica.tick()
        clock.t = 20.0
        surv.replica.tick()
        for k in range(1 + int(surv.config.install_retry_max) * 2):
            fabric.release_stalls()
            surv.monitor.poll(now=100.0 + k)
        return pair_state(S, fabric, pair)

    ref, got = scenario(REF), scenario(PORT)
    assert got == ref
    assert got["counters"]["replica_adoptions_total"] >= 1


def _storm(S, steps, seed, victim, kill_at, wire):
    """``tests/test_replica.py``'s chaos acceptance: two controllers over
    fattree(4) under the full seeded FaultPlan, one killed mid-storm,
    then quiesced."""
    spec = S.topogen.fattree(4)
    fabric = spec.to_fabric(wire=wire)
    clock = Clock()
    # the coalescer also flushes when coalesce_window_s of wall time has
    # passed since a burst opened; a pause that long inside one package's
    # run (a collection, a loaded worker) cuts its bursts apart and the
    # seeded plan then draws its faults against other sends. A window no
    # storm reaches leaves the flushes to the batch cap and the fabric's
    # idle edge, which both packages hit at the same sends.
    cfg = S.Config(oracle_backend="py", proactive_collectives=False,
                   coalesce_routes=True, coalesce_window_s=3600.0,
                   **FAST_RECOVERY)
    pair = mod(S, "control.replica").build_pair(fabric, cfg, clock=clock)
    pair.attach()
    macs = [S.topogen.host_mac(r) for r in range(8)]
    for rank, mac in enumerate(macs):
        announce(S, fabric, mac, "LAUNCH", rank)
    plan = mod(S, "control.faults").FaultPlan(
        seed=seed, p_send_drop=0.08, p_send_stall=0.05, p_send_truncate=0.04,
        p_ack_drop=0.05, p_stats_delay=0.15, p_crash=0.06, p_redial=0.4,
        p_flap=0.10, p_restore=0.5, p_release=0.5, max_crashed=3,
    ).attach(fabric)
    rng = np.random.default_rng(seed)
    hosts = sorted(fabric.hosts)
    for step in range(steps):
        clock.t = float(step)
        if step == kill_at:
            pair.kill(victim)
        plan.step()
        for _ in range(3):
            a, b = rng.choice(len(hosts), size=2, replace=False)
            ha, hb = fabric.hosts[hosts[a]], fabric.hosts[hosts[b]]
            if ha.dpid in fabric.switches and hb.dpid in fabric.switches:
                ha.send(ip_packet(S, hosts[a], hosts[b]))
        if step % 7 == 0:
            s, d = int(rng.integers(0, 8)), int(rng.integers(0, 8))
            if s != d and fabric.hosts[macs[s]].dpid in fabric.switches:
                fabric.hosts[macs[s]].send(ip_packet(
                    S, macs[s], S.VirtualMac(S.CollectiveType.P2P, s, d).encode()))
        pair.poll(now=float(step))
        fabric.tick(float(step))
    plan.quiesce()
    for k in range(4 + int(cfg.install_retry_max) * 2):
        clock.t = float(steps + 3 * k)
        fabric.release_stalls()
        pair.poll(now=float(steps + k))
    out = pair_state(S, fabric, pair)
    out["plan"] = (dict(plan.counts), list(plan.mutations))
    surv = pair.survivor()
    out["converged"] = {(d, src, dst) for d, src, dst, *_ in flows(fabric)} == {
        (d, src, dst) for d, tab in surv.router.recovery.desired.flows.items()
        for (src, dst) in tab}
    return out


@pytest.mark.parametrize("wire", [False, True])
def test_pair_chaos_storm_matches_the_reference(wire):
    """60 seeded steps, controller 0 killed at step 30: the same faults,
    the same adoption, and the same converged fabric in both packages."""
    ref = _storm(REF, 60, 29, 0, 30, wire)
    got = _storm(PORT, 60, 29, 0, 30, wire)
    assert got == ref
    assert got["converged"] and got["plan"][0]["crash"] > 0
    assert got["counters"]["replica_lease_expiries_total"] >= 1

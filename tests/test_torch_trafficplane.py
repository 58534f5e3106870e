"""The port's measured traffic matrix and route sentinel against the JAX
package's.

The same seeded ingest streams (edge switch, source and destination
host, tenant, bytes) and flush clocks go through both packages'
``TrafficPlane`` over the same fat-tree: the published matrix, its
state dict and the hot-pair gauge are equal bit for bit at
``alpha = 1``, and within :data:`EWMA_RTOL` below it. Both controllers
run ``tests/test_trafficplane.py``'s sentinel scenarios (the steady
replay, the cross-pod shift, a broken walk) with the same results. The
CUDA hazards of the port's tensor updates each have a test here: a
published epoch stays unchanged by later flushes, padded index sets
never scatter their pads, and the sentinel keeps its pow2 pads.
"""

import importlib

import numpy as np
import pytest
import torch

from tests.test_torch_control import PORT, REF

#: relative tolerance between the two packages' matrices at alpha < 1:
#: four f32 units in the last place. Each fold is ``old * (1 - a) +
#: bps * a`` in f32 in both, and the difference carries into later
#: folds through ``old``. At a = 0.5 (both products exact) the CPU runs
#: of this file are bit-equal; at a = 0.3, 0.9 and 0.123, 16 to 27 of
#: the 2,088 published cells of the stream differ, by at most 1.43e-7
#: relative (XLA-CPU and torch round the fold differently)
EWMA_RTOL = 2 ** -21


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


def plane(S, k=4, **kw):
    """A TrafficPlane over fattree(k)'s TopologyDB (host backend, so the
    matrix is the only device state), with ``kw`` on its Config."""
    db = S.topogen.fattree(k).to_topology_db(backend="py")
    cfg = S.Config(oracle_backend="py", **kw) if S is REF else S.Config(
        oracle_backend="torch", device="cpu", **kw)
    return db, mod(S, "oracle.trafficplane").TrafficPlane(db, cfg)


def stream(db, seed, n_flushes, n_tenants, per_flush=40):
    """A seeded ingest stream: per flush, ``per_flush`` deltas from
    random source hosts (at their own edge switch, plus some at a wrong
    switch that must be ignored) to random destinations."""
    rng = np.random.default_rng(seed)
    macs = sorted(db.hosts)
    out = []
    for f in range(n_flushes):
        batch = []
        for _ in range(per_flush):
            s, d = rng.choice(len(macs), 2, replace=False)
            src, dst = macs[s], macs[d]
            dpid = db.hosts[src].port.dpid
            if rng.random() < 0.15:
                dpid = db.hosts[dst].port.dpid  # a transit hop: not counted
            tenant = f"t{rng.integers(n_tenants)}" if rng.random() < 0.8 else "-"
            batch.append((int(dpid), src, dst, tenant, int(rng.integers(1, 10**6))))
        # some flushes carry nothing: active cells decay or clear
        out.append(batch if f % 4 != 3 else [])
    return out


def drive(S, k, alpha, seed, n_tenants, n_flushes=12):
    db, tp = plane(S, k, traffic_ewma_alpha=alpha)
    snaps = []
    for i, batch in enumerate(stream(db, seed, n_flushes, n_tenants)):
        for rec in batch:
            tp.ingest(*rec)
        tp.flush(now=0.5 * i)
        snaps.append(tp.matrix())
    gauge = mod(S, "utils.metrics").REGISTRY.get("trafficplane_hot_pair_bps").value
    return tp, snaps, gauge


@pytest.mark.parametrize("k,n_tenants,seed", [(4, 3, 0), (6, 11, 1), (4, 1, 2)],
                         ids=["k4", "regrow", "one-tenant"])
def test_matrix_bit_equal_at_alpha_one(k, n_tenants, seed):
    """Every published epoch's cells, the state dict and the hot-pair
    gauge equal the reference's bit for bit; ``regrow`` outgrows both
    the tenant and the endpoint capacity (8), carrying cells over."""
    ref, ref_snaps, ref_hot = drive(REF, k, 1.0, seed, n_tenants)
    got, got_snaps, got_hot = drive(PORT, k, 1.0, seed, n_tenants)
    assert got_snaps == ref_snaps
    assert any(s["cells"] for s in got_snaps)
    assert got.state_dict() == ref.state_dict()
    assert got_hot == ref_hot
    assert (got.epoch, got.rebuild_count) == (ref.epoch, ref.rebuild_count)
    if n_tenants > 8:
        assert got.rebuild_count >= 2  # tenant and endpoint growth


@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.9])
def test_matrix_within_tolerance_below_alpha_one(alpha):
    ref, ref_snaps, _ = drive(REF, 6, alpha, 3, 4)
    got, got_snaps, _ = drive(PORT, 6, alpha, 3, 4)
    assert len(got_snaps) == len(ref_snaps)
    for g, r in zip(got_snaps, ref_snaps):
        assert [c[:3] for c in g["cells"]] == [c[:3] for c in r["cells"]]
        np.testing.assert_allclose([c[3] for c in g["cells"]],
                                   [c[3] for c in r["cells"]], rtol=EWMA_RTOL)
    assert [c[4] for c in got.state_dict()["cells"]] == [
        c[4] for c in ref.state_dict()["cells"]]


def test_state_dict_restores_across_packages():
    """``load_state`` of one package's state dict into the other's plane
    publishes the same matrix."""
    for w, r in ((REF, PORT), (PORT, REF)):
        src, _, _ = drive(w, 4, 1.0, 5, 3)
        state = src.state_dict()
        _, dst = plane(r, 4)
        assert dst.load_state(state) == len(
            [c for c in state["cells"] if c[3] > 0.0])
        assert dst.matrix()["cells"] == src.matrix()["cells"]


def test_published_epoch_survives_a_later_flush():
    """A reader's published tensor is never written by a later flush or
    a regrow (the reference's arrays are immutable; the port builds a
    new tensor per update)."""
    db, tp = plane(PORT, 6)
    recs = stream(db, 4, 3, 2)
    for rec in recs[0]:
        tp.ingest(*rec)
    tp.flush(now=0.0)
    held = tp._snap
    frozen = held.clone()
    matrix = tp.matrix()
    for rec in recs[1]:
        tp.ingest(*rec)
    for i in range(12):  # tenant growth past 8: a regrow carries cells
        tp.ingest(recs[1][0][0], recs[1][0][1], recs[1][0][2], f"x{i}", 7)
    tp.flush(now=1.0)
    assert tp._snap is not held and tp.rebuild_count >= 1
    assert torch.equal(held, frozen)
    assert not torch.equal(tp._snap[: held.numel()], held) or held.numel() != tp._snap.numel()
    assert matrix["epoch"] == 1 and tp.epoch == 2


def test_padded_index_sets_never_scatter_their_pads():
    """The pads of a bucket-padded index set carry the out-of-range index
    ``cap``: gathers clamp it and every update writes the real entries
    only (an out-of-range ``index_put`` raises on the CPU and is a
    device-side assert on the card)."""
    tpm = mod(PORT, "oracle.trafficplane")
    tiling = mod(PORT, "kernels.tiling")
    cap = 64
    live = torch.arange(cap, dtype=torch.float32)
    idx, vals = tiling.bucket_pad([3, 9, 17], cap, cap, [1.5, 2.5, 3.5])
    assert len(idx) == 8 and (idx[3:] == cap).all()
    keep, gain = torch.tensor(0.25), torch.tensor(0.75)
    out = tpm._scatter_ewma(live, torch.from_numpy(idx), torch.from_numpy(vals),
                            3, keep, gain)
    want = live.clone()
    want[[3, 9, 17]] = live[[3, 9, 17]] * keep + torch.tensor([1.5, 2.5, 3.5]) * gain
    assert torch.equal(out, want) and torch.equal(live, torch.arange(cap, dtype=torch.float32))
    cleared = tpm._clear_cells(out, torch.from_numpy(idx), 3)
    assert cleared[[3, 9, 17]].eq(0).all() and cleared.sum() == out.sum() - out[[3, 9, 17]].sum()
    new_idx, _ = tiling.bucket_pad([0, 1, 2], 128, 128)
    carried = tpm._carry_cells(out, torch.from_numpy(idx), torch.from_numpy(new_idx),
                               3, torch.zeros(128))
    assert torch.equal(carried[:3], out[[3, 9, 17]]) and carried[3:].eq(0).all()
    # the full-size call: every real index, no room left for a pad
    full = torch.arange(cap, dtype=torch.int32)
    assert torch.equal(tpm._clear_cells(live, full, cap), torch.zeros(cap))


# -- the route sentinel ------------------------------------------------------


def controller(S, **overrides):
    """``tests/test_trafficplane.py``'s stack: fattree(4) on the wire,
    the audit full-fabric, the sentinel sampling everything, a 1 Hz
    flush clock on the traffic plane."""
    kw = dict(coalesce_routes=True, audit_switches_per_flush=0,
              install_retry_backoff_s=0.0, barrier_timeout_s=0.0,
              sentinel_sample_per_flush=0, sentinel_divergence_factor=1.5)
    kw.update(overrides)
    kw.update(oracle_backend="jax") if S is REF else kw.update(device="cpu")
    fabric = S.topogen.fattree(4).to_fabric(wire=True)
    ctl = S.Controller(fabric, S.Config(**kw))
    ctl.attach()
    ctl.traffic.clock = iter(range(1, 10**6)).__next__
    return fabric, ctl


def by_edge(fabric):
    out: dict = {}
    for mac in sorted(fabric.hosts):
        out.setdefault(fabric.hosts[mac].dpid, []).append(mac)
    return out


def ring_pairs(fabric):
    macs = sorted(fabric.hosts)
    return [(macs[i], macs[(i + 1) % len(macs)]) for i in range(8)]


def shift_pairs(fabric):
    edges = by_edge(fabric)
    order = sorted(edges)
    return [(s, edges[e][0]) for s in edges[order[0]] for e in order[-2:]]


def edge(S, ctl, fabric, counts):
    for (src, dst), n in counts.items():
        for _ in range(n):
            fabric.hosts[src].send(S.of.Packet(src, dst, S.of.ETH_TYPE_IP))
    ctl.bus.publish(S.ev.EventStatsFlush())


def sentinel_state(S, ctl):
    reg = mod(S, "utils.metrics").REGISTRY
    return {
        "last": dict(ctl.sentinel._last),
        "recent": list(ctl.sentinel.recent),
        "divergence": dict(reg.get("sentinel_divergence_total").values),
        "gauges": (reg.get("route_staleness_ratio").value,
                   reg.get("measured_vs_modeled_divergence").value),
        "shadow": reg.get("sentinel_shadow_routes_total").value,
        "matrix": ctl.traffic.matrix(),
        "bundles": [(b["trigger"], [
            {k: v for k, v in d.items()} for d in b["detail"].get("recent", [])])
            for b in ctl.flight.bundles if b["trigger"] == "sentinel:divergence"],
    }


def test_sentinel_shift_matches_the_reference():
    """Five steady flush edges of the ring, then a cross-pod burst of one
    edge's hosts: both sentinels confirm the same divergence (tenant,
    pod pair, hot link, loads) on the same edge and freeze the same
    bundle; the steady phase fires in neither."""
    def scenario(S):
        fabric, ctl = controller(S)
        ring, shift = ring_pairs(fabric), shift_pairs(fabric)
        for src, _ in shift:
            ctl.router.admission.assign(src, "bursty")
        ctl.router.reinstall_pairs(ring + shift)
        states = []
        for _ in range(5):
            edge(S, ctl, fabric, {p: 1 for p in ring})
        states.append(sentinel_state(S, ctl))
        for _ in range(2):
            edge(S, ctl, fabric, {p: 2 for p in shift})
            states.append(sentinel_state(S, ctl))
        return states

    ref, got = scenario(REF), scenario(PORT)
    assert got == ref
    assert got[0]["divergence"] == {} and got[-1]["divergence"]
    assert got[-1]["recent"][-1]["tenant"] == "bursty" and got[-1]["bundles"]


def test_sentinel_steady_replay_and_broken_walk_match_the_reference():
    """Fifteen steady edges of the ring fire nothing in either package;
    a hop knocked out of one pair's desired chain counts stale in both."""
    def scenario(S):
        fabric, ctl = controller(S)
        pairs = ring_pairs(fabric)
        ctl.router.reinstall_pairs(pairs)
        for _ in range(15):
            edge(S, ctl, fabric, {p: 1 for p in pairs})
        steady = sentinel_state(S, ctl)
        src, dst = next(p for p in pairs
                        if fabric.hosts[p[0]].dpid != fabric.hosts[p[1]].dpid)
        ctl.router.recovery.desired.remove(fabric.hosts[src].dpid, src, dst)
        edge(S, ctl, fabric, {p: 1 for p in pairs})
        return steady, sentinel_state(S, ctl)

    ref, got = scenario(REF), scenario(PORT)
    assert got == ref
    assert got[0]["divergence"] == {} and got[1]["gauges"][0] > 0.0


@pytest.mark.parametrize("n", [1, 5, 8, 13, 31])
def test_sentinel_keeps_its_pow2_pads(n):
    """``_shadow_links`` pads the sample to ``col_bucket(n, 4096)`` by
    repeating its last pair, as the reference does (the pads change the
    balanced assignment of the real pairs, so the port keeps them): the
    batch the port's oracle receives, and the fresh links it returns,
    are the reference's."""
    def scenario(S):
        fabric, ctl = controller(S)
        macs = sorted(fabric.hosts)
        pool = [(macs[i], macs[(i + j) % len(macs)])
                for j in (1, 3, 5) for i in range(len(macs))]
        db = ctl.sentinel.db
        seen = []
        real = db.find_routes_batch_balanced

        def spy(pairs, *a, **kw):
            seen.append(list(pairs))
            return real(pairs, *a, **kw)

        db.find_routes_batch_balanced = spy
        links = ctl.sentinel._shadow_links(pool[:n], ctl.sentinel._hop_map())
        return seen, links

    (ref_seen, ref_links), (got_seen, got_links) = scenario(REF), scenario(PORT)
    assert got_seen == ref_seen and got_links == ref_links
    bucket = mod(PORT, "kernels.tiling").col_bucket(n, 4096)
    assert len(got_seen) == 1 and len(got_seen[0]) == bucket
    assert got_seen[0][n:] == [got_seen[0][n - 1]] * (bucket - n)


def test_matrix_pulls_match_the_reference():
    """The ``traffic_matrix`` pull and the checkpoint's traffic section
    after a soak, and their restore into the other package."""
    def scenario(S):
        fabric, ctl = controller(S)
        pairs = ring_pairs(fabric)
        for src, _ in pairs:
            ctl.router.admission.assign(src, "t0")
        ctl.router.reinstall_pairs(pairs)
        for _ in range(4):
            edge(S, ctl, fabric, {p: 1 for p in pairs})
        rpc = mod(S, "api.rpc").RPCInterface(ctl.bus, ctl.config)
        pulled = rpc.handle_request(
            {"jsonrpc": "2.0", "id": 1, "method": "traffic_matrix"})["result"]
        snap = mod(S, "api.snapshot").snapshot_controller(ctl)
        return pulled, snap["traffic_plane"], snap

    ref_pull, ref_tp, ref_snap = scenario(REF)
    got_pull, got_tp, got_snap = scenario(PORT)
    assert got_pull == ref_pull and got_pull["cells"]
    assert got_tp == ref_tp
    for writer, reader in ((ref_snap, PORT), (got_snap, REF)):
        fabric, ctl = controller(reader)
        mod(reader, "api.snapshot").restore_controller(ctl, writer)
        assert ctl.traffic.matrix()["cells"] == got_pull["cells"]

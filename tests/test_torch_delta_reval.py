"""The port's delta-narrowed revalidation against the JAX package's.

The oracle leg (``routes_batch_delta`` and its dispatch twin) routes as
the plain batch does and sets each pair's ``touched`` flag; it is held
against the reference's on the device leg, the host chase and the
pure-Python backend. The control-plane leg runs seeded churn through a
controller of each package with ``delta_reval`` on (the default) and
through the port's with it off: after every flap the port's narrowed
controller leaves the fabric, its stores and the bus exactly as the
reference's narrowed controller does, and its FDB, flow tables and
desired-flow store equal the port's full pass, which re-routes more
pairs. The cases are those of ``tests/test_delta_reval.py``.
"""

import numpy as np
import pytest

from tests.test_torch_control import PORT, REF, make_config, state

SPECS = {"fattree4": ("fattree", (4,)), "torus3x3": ("torus", ((3, 3),))}


def _dbs(backend="torch"):
    from sdnmpi_tpu.topogen import fattree as j_fattree
    from sdnmpi_tpu_torch.topogen import fattree as p_fattree

    ref = j_fattree(4).to_topology_db(backend="jax")
    kw = {"device": "cpu"} if backend == "torch" else {}
    return ref, p_fattree(4).to_topology_db(backend=backend, **kw)


def _pairs(db, n=10):
    macs = sorted(db.hosts)
    pairs = [(macs[i], macs[(i * 5 + 3) % len(macs)]) for i in range(n)]
    return [(s, d) for s, d in pairs if s != d]


def _dirty(db):
    a = sorted(db.links)[0]
    return {a, sorted(db.links[a])[0]}


def _window(wr):
    return wr.fdbs(), wr.touched.tolist()


@pytest.mark.parametrize("leg", ["host", "device", "py"])
def test_routes_batch_delta_matches_reference(leg):
    """Each leg's fdbs equal the plain batch's and the reference's, and
    ``touched`` is the exact set intersection, on a fixture with both
    touched and untouched pairs."""
    ref, got = _dbs("py" if leg == "py" else "torch")
    pairs, dirty = _pairs(got), _dirty(got)
    if leg == "device":
        got._oracle_engine().host_chase_hop_budget = 0
    wr = got.find_routes_batch_delta_dispatch(pairs, dirty).reap()
    want = ref.find_routes_batch_delta_dispatch(pairs, dirty).reap()
    assert _window(wr) == _window(want)
    assert wr.fdbs() == got.find_routes_batch(pairs)
    touched = [any(d in dirty for d, _ in fdb) for fdb in wr.fdbs()]
    assert wr.touched.tolist() == touched and any(touched) and not all(touched)


def test_unresolvable_and_empty_batches_carry_touched():
    ref, got = _dbs()
    for pairs in ([], [("aa:bb:cc:dd:ee:ff", "ff:ee:dd:cc:bb:aa")]):
        wr = got.find_routes_batch_delta_dispatch(pairs, _dirty(got)).reap()
        assert _window(wr) == _window(
            ref.find_routes_batch_delta_dispatch(pairs, _dirty(ref)).reap())
    assert wr.fdbs() == [[]] and wr.touched.tolist() == [False]


def test_flap_storm_rides_the_repair():
    """A storm of flaps with varying affected-batch sizes on the device
    leg: every window equals the reference's, and every refresh of the
    storm is an in-place repair (the delta log, never a full refresh)."""
    from sdnmpi_tpu.core import topology_db as j_tdb
    from sdnmpi_tpu_torch.core import topology_db as p_tdb

    ref, got = _dbs()
    j_oracle, p_oracle = ref._jax_oracle(), got._oracle_engine()
    j_oracle.host_chase_hop_budget = p_oracle.host_chase_hop_budget = 0
    pairs = _pairs(got, n=14)
    cables = [(a, b) for a in sorted(got.links) for b in sorted(got.links[a]) if a < b]
    rng = np.random.default_rng(7)
    for i in range(6):
        a, b = cables[int(rng.integers(1, len(cables)))]
        dirty = {a, b}
        for db, o, tdb in ((ref, j_oracle, j_tdb), (got, p_oracle, p_tdb)):
            links = [db.links[a][b], db.links[b][a]]
            for lk in links:
                db.delete_link(lk)
            wr_down = o.routes_batch_delta(db, pairs[: 9 + (i % 6)], dirty)
            for lk in links:
                db.add_link(tdb.Link(tdb.Port(lk.src.dpid, lk.src.port_no),
                                     tdb.Port(lk.dst.dpid, lk.dst.port_no)))
            wr_up = o.routes_batch_delta(db, pairs[: 9 + ((i + 3) % 6)], dirty)
            if db is ref:
                want = (_window(wr_down), _window(wr_up))
        assert (_window(wr_down), _window(wr_up)) == want
        assert not any(fdb and any(
            x == a and y == b for (x, _), (y, _) in zip(fdb, fdb[1:]))
            for fdb in wr_down.fdbs())
    assert p_oracle.full_refresh_count == j_oracle.full_refresh_count == 1
    assert p_oracle.repair_count == j_oracle.repair_count > 0


def test_pow2_bucketing():
    from sdnmpi_tpu_torch.oracle.batch import bucket_pow2, pad_flow_batch

    assert [bucket_pow2(n) for n in (1, 8, 9, 16, 17, 100)] == [8, 8, 16, 16, 32, 128]
    (a,) = pad_flow_batch(np.arange(9, dtype=np.int32), pow2=True)
    assert len(a) == 16 and a[9:].tolist() == [-1] * 7


# -- the churn replay through both controllers ---------------------------------


def _stack(S, topo, wire=False, **config_kw):
    fn, args = SPECS[topo]
    spec = getattr(S.topogen, fn)(*args)
    fabric = spec.to_fabric(wire=wire)
    ctl = S.Controller(fabric, make_config(S, enable_monitor=False, **config_kw))
    events: list = []
    ctl.bus.tap(events.append)
    ctl.attach()
    return spec, fabric, ctl, events


def _install_traffic(S, fabric, seed=3, n_pairs=12):
    """A seeded population of unicast flows, two ranks and one vMAC flow
    (last-hop rewrites ride the comparison too)."""
    macs = sorted(fabric.hosts)
    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < min(n_pairs, len(macs) * (len(macs) - 1) // 2):
        i, j = rng.integers(0, len(macs), 2)
        if i != j:
            pairs.add((macs[int(i)], macs[int(j)]))
    for src, dst in sorted(pairs):
        fabric.hosts[src].send(S.of.Packet(src, dst, payload=b"x"))
    for mac, rank in ((macs[0], 0), (macs[-1], 1)):
        fabric.hosts[mac].send(S.of.Packet(
            mac, "ff:ff:ff:ff:ff:ff", ip_proto=S.of.IPPROTO_UDP, udp_dst=61000,
            payload=S.Announcement(S.AnnouncementType.LAUNCH, rank).encode(),
        ))
    vmac = S.VirtualMac(S.CollectiveType.P2P, 0, 1).encode()
    fabric.hosts[macs[0]].send(S.of.Packet(macs[0], vmac, payload=b"m"))


def _count_pairs(S, ctl):
    counts = {"pairs": 0, "dispatch": 0, "batch": 0, "dirty": []}
    for req_type, key in ((S.ev.FindRoutesBatchRequest, "batch"),
                          (S.ev.DispatchRoutesBatchRequest, "dispatch")):
        handler = ctl.bus._request_handlers[req_type]

        def counting(req, handler=handler, key=key):
            counts[key] += 1
            counts["pairs"] += len(req.pairs)
            if key == "dispatch":
                counts["dirty"].append(req.dirty)
            return handler(req)

        ctl.bus._request_handlers[req_type] = counting
    return counts


def _flows(fabric):
    return {(d, repr(e.match), repr(e.actions)) for d, sw in fabric.switches.items()
            for e in sw.flow_table if e.priority == 0x8000}


def _desired(ctl):
    return {d: {k: repr(v) for k, v in t.items()}
            for d, t in ctl.router.recovery.desired.flows.items() if t}


@pytest.mark.parametrize("wire", [False, True], ids=["sim", "wire"])
@pytest.mark.parametrize("topo", sorted(SPECS))
def test_narrowed_matches_reference_and_full_pass(topo, wire):
    """Eight seeded flap steps. After every step the port's narrowed
    controller's state (flow tables, FDB, desired store, every bus
    event) equals the reference's narrowed controller's, and its FDB the
    port's full pass's; at the end the flow tables and desired stores
    equal the full pass's too, which examined strictly more pairs."""
    ref = _stack(REF, topo, wire)
    got = _stack(PORT, topo, wire)
    full = _stack(PORT, topo, wire, delta_reval=False)
    for S, (_, fabric, _, _) in ((REF, ref), (PORT, got), (PORT, full)):
        _install_traffic(S, fabric)
    c_got, c_full = _count_pairs(PORT, got[2]), _count_pairs(PORT, full[2])
    cables = sorted(got[0].links)
    rng = np.random.default_rng(11)
    removed = None
    for step in range(8):
        stacks = ((REF, ref), (PORT, got), (PORT, full))
        if removed is None:
            removed = cables[int(rng.integers(0, len(cables)))]
            for S, (_, fabric, ctl, _) in stacks:
                fabric.remove_link(*removed)
        else:
            for S, (_, fabric, ctl, _) in stacks:
                fabric.add_link(*removed)
                ctl.bus.publish(S.ev.EventTopologyChanged())
            removed = None
        assert state(*got[1:]) == state(*ref[1:]), f"step {step}"
        assert set(got[2].router.fdb.entries()) == set(full[2].router.fdb.entries())
    assert _flows(got[1]) == _flows(full[1])
    assert _desired(got[2]) == _desired(full[2])
    assert c_got["pairs"] < c_full["pairs"]
    oracle = got[2].topology_manager.topologydb._oracle_engine()
    assert oracle.full_refresh_count == 1 and oracle.repair_count > 0


def test_escape_hatch_full_pass_examines_everything():
    got = _stack(PORT, "fattree4")
    full = _stack(PORT, "fattree4", delta_reval=False)
    counts = []
    for _, fabric, ctl, _ in (got, full):
        _install_traffic(PORT, fabric)
        counts.append(_count_pairs(PORT, ctl))
    cable = sorted(got[0].links)[0]
    for _, fabric, ctl, _ in (got, full):
        fabric.remove_link(*cable)
        fabric.add_link(*cable)
        ctl.bus.publish(PORT.ev.EventTopologyChanged())
    assert counts[1]["pairs"] >= counts[0]["pairs"]
    assert counts[1]["batch"] + counts[1]["dispatch"] >= 2


def test_narrowed_pass_uses_dispatch_windows_with_dirty():
    """The surviving flows are re-scored through the split-phase window
    path, chunked at ``coalesce_max_batch``, with the dirty set on each
    request, in both packages alike."""
    from collections import Counter

    seen = []
    for S in (REF, PORT):
        spec, fabric, ctl, events = _stack(S, "fattree4", coalesce_max_batch=2)
        _install_traffic(S, fabric, n_pairs=8)
        counts = _count_pairs(S, ctl)
        ctl.bus.publish(S.ev.EventTopologyChanged())
        counts.update(dispatch=0, batch=0, dirty=[])
        load = Counter(dpid for dpid, *_ in ctl.router.fdb.entries())
        dpid = load.most_common(1)[0][0]
        cable = next(c for c in sorted(spec.links) if dpid in (c[0], c[2]))
        fabric.remove_link(*cable)
        assert counts["dispatch"] >= 2 and counts["batch"] == 0
        assert all(d for d in counts["dirty"])
        seen.append((counts["dispatch"], [sorted(d) for d in counts["dirty"]],
                     state(fabric, ctl, events)))
    assert seen[0] == seen[1]


def test_disjoint_flap_skips_collective_reinstall():
    """A block-installed collective re-routes only when the dirty set
    meets the switches its blocks ride: the same events in both
    packages for a disjoint flap and a ridden one."""
    outs = []
    for S in (REF, PORT):
        spec, fabric, ctl, events = _stack(S, "fattree4", block_install_threshold=2)
        macs = sorted(fabric.hosts)[:4]
        for rank, mac in enumerate(macs):
            fabric.hosts[mac].send(S.of.Packet(
                mac, "ff:ff:ff:ff:ff:ff", ip_proto=S.of.IPPROTO_UDP, udp_dst=61000,
                payload=S.Announcement(S.AnnouncementType.LAUNCH, rank).encode(),
            ))
        vmac = S.VirtualMac(S.CollectiveType.ALLTOALL, 0, 1).encode()
        fabric.hosts[macs[0]].send(S.of.Packet(macs[0], vmac, payload=b"m"))
        install = next(iter(ctl.router.collectives))
        ridden = next(c for c in sorted(spec.links)
                      if c[0] in install.switches and c[2] in install.switches)
        disjoint = next(c for c in sorted(spec.links)
                        if c[0] not in install.switches and c[2] not in install.switches)
        for cable in (disjoint, ridden):
            fabric.remove_link(*cable)
        outs.append(state(fabric, ctl, events))
    assert outs[0] == outs[1]

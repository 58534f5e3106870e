"""The port's control plane against the JAX package's.

The reference controller (backend ``"jax"`` on the CPU) and the port's
(backend ``"torch"``, ``device="cpu"``) get the same ``Config`` knobs,
the same fabric, and the same announcements, packets and faults, in the
scenarios of ``tests/test_control.py``, ``test_collective_blocks.py``,
``test_discovery.py``, ``test_flow_expiry.py`` and the non-fault parts of
``test_recovery.py``. Each run is reduced to the state an operator could
read off the fabric and the controller (:func:`state`): every switch's
flow table in install order, the block tables and their collective
blocks, the packets each host received, the SwitchFDB, the installed
collectives, the rank DB, the desired-flow store and every event
published on the bus. The two must be equal.

Both controllers run at their defaults: the device utilization plane,
the delta-narrowed revalidation, the fabric audit, the traffic plane and
its sentinel, the flight recorder and the metrics timeline are on in
both, as both packages' defaults have them.

The sampler near-tie rule of ``tests/test_torch_slice.py`` (ROADMAP C1)
is not needed here: at these sizes every sampled decision of the
balanced and adaptive installs has a margin far above the last-bit
difference of ``log``, and the tables compare exactly. The larger
block installs of ``tests/test_torch_install_plane.py`` apply it.
"""

import dataclasses
import importlib
import types

import numpy as np
import pytest

MAC = {i: f"04:00:00:00:00:0{i}" for i in range(1, 7)}


def _side(pkg: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    ann = mod("protocol.announcement")
    vmac = mod("protocol.vmac")
    return types.SimpleNamespace(
        Config=mod("config").Config,
        Controller=mod("control.controller").Controller,
        Fabric=mod("control.fabric").Fabric,
        ev=mod("control.events"),
        of=mod("protocol.openflow"),
        Announcement=ann.Announcement,
        AnnouncementType=ann.AnnouncementType,
        VirtualMac=vmac.VirtualMac,
        CollectiveType=vmac.CollectiveType,
        topogen=mod("topogen"),
    )


REF = _side("sdnmpi_tpu")
PORT = _side("sdnmpi_tpu_torch")


def make_config(S, **kw):
    """One Config for one side: the same knobs, each side's oracle."""
    if S is REF:
        return S.Config(oracle_backend="jax", **kw)
    return S.Config(oracle_backend="torch", device="cpu", **kw)


# -- fabrics ---------------------------------------------------------------


def diamond(S, **fabric_kw):
    """The reference's 4-switch diamond (``tests/test_control.py``)."""
    fabric = S.Fabric(**fabric_kw)
    for d in (1, 2, 3, 4):
        fabric.add_switch(d)
    fabric.add_link(1, 2, 2, 2)
    fabric.add_link(1, 3, 3, 3)
    fabric.add_link(2, 3, 4, 2)
    fabric.add_link(3, 2, 4, 3)
    for d in (1, 2, 3, 4):
        fabric.add_host(MAC[d], d, 1)
    return fabric


def line(S, **fabric_kw):
    """``tests/test_install_plane.py``'s 1 - 2 - 3 line with two hosts
    per edge switch, plus an isolated 4 - 5 pair."""
    fabric = S.Fabric(**fabric_kw)
    for d in (1, 2, 3, 4, 5):
        fabric.add_switch(d)
    fabric.add_link(1, 1, 2, 1)
    fabric.add_link(2, 2, 3, 1)
    fabric.add_link(4, 1, 5, 1)
    for mac, dpid, port in ((1, 1, 2), (2, 1, 3), (3, 3, 2), (4, 3, 3),
                            (5, 4, 2), (6, 5, 2)):
        fabric.add_host(MAC[mac], dpid, port)
    return fabric


def build(S, fabric_fn, fabric_kw=None, **config_kw):
    """Fabric, controller (attached) and the list of every event the
    bus published."""
    fabric = fabric_fn(S, **(fabric_kw or {}))
    ctl = S.Controller(fabric, make_config(S, **config_kw))
    events: list = []
    ctl.bus.tap(events.append)
    ctl.attach()
    return fabric, ctl, events


# -- drivers ---------------------------------------------------------------


def ip_packet(S, src, dst, **kw):
    return S.of.Packet(eth_src=src, eth_dst=dst, eth_type=S.of.ETH_TYPE_IP, **kw)


def announce(S, fabric, mac, kind, rank):
    fabric.hosts[mac].send(S.of.Packet(
        eth_src=mac, eth_dst="ff:ff:ff:ff:ff:ff", eth_type=S.of.ETH_TYPE_IP,
        ip_proto=S.of.IPPROTO_UDP, udp_dst=61000,
        payload=S.Announcement(getattr(S.AnnouncementType, kind), rank).encode(),
    ))


def send_vmac(S, fabric, mac, coll, s, d):
    vmac = S.VirtualMac(getattr(S.CollectiveType, coll), s, d).encode()
    fabric.hosts[mac].send(ip_packet(S, mac, vmac))


def launch_all(S, fabric, macs):
    for rank, mac in enumerate(macs):
        announce(S, fabric, mac, "LAUNCH", rank)


# -- the state both controllers must agree on -------------------------------


def _arr(x):
    return None if x is None else np.asarray(x).tolist()


def _block(b) -> tuple:
    return (
        b.priority, b.cookie, _arr(b.hop_dpid), _arr(b.hop_port),
        _arr(b.hop_len), _arr(b.bounds), _arr(b.src), _arr(b.dst),
        _arr(b.final_port), _arr(b.rewrite),
    )


def _install(c) -> tuple:
    return (
        c.cookie, int(c.coll_type), tuple(c.ranks), c.root, c.policy,
        list(c.macs), _arr(c.src_idx), _arr(c.dst_idx), c.n_pairs, c.n_flows,
        float(c.max_congestion), sorted(c.switches), sorted(c.links),
        c.n_phases,
    )


def _event(e) -> tuple:
    """An event as its class name and fields; fields that hold objects
    without a value repr (windows, buffers) count by type only."""
    out = [type(e).__name__]
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, np.ndarray):
            out.append(v.tolist())
        else:
            r = repr(v)
            out.append(type(v).__name__ if " at 0x" in r else r)
    return tuple(out)


def state(fabric, ctl, events) -> dict:
    """Everything an operator can read off the fabric and the
    controller after a scenario."""
    blocks = {}
    for sw in fabric.switches.values():
        for b in sw.block_table:
            blocks[b.block.cookie] = _block(b.block)
    desired = getattr(ctl.router.recovery, "desired", None)
    return {
        "tables": {
            d: [(e.priority, repr(e.match), repr(e.actions), e.cookie,
                 e.idle_timeout, e.hard_timeout) for e in sw.flow_table]
            for d, sw in sorted(fabric.switches.items())
        },
        "block_tables": {
            d: [(b.priority, b.seq, b.block.cookie, b.sub_rows.tolist(),
                 b.hop_rows.tolist()) for b in sw.block_table]
            for d, sw in sorted(fabric.switches.items())
        },
        "blocks": blocks,
        "received": {
            m: [repr(p) for p in h.received]
            for m, h in sorted(fabric.hosts.items())
        },
        "fdb": {d: dict(t) for d, t in ctl.router.fdb.fdb.items()},
        "fdb_pairs": sorted(ctl.router.fdb.pairs()),
        "collectives": [_install(c) for c in ctl.router.collectives],
        "ranks": dict(ctl.process_manager.rankdb.processes),
        "desired": None if desired is None else {
            d: {k: repr(v) for k, v in t.items()}
            for d, t in desired.flows.items()
        },
        "links": sorted(
            (s, d) for s, m in ctl.topology_manager.topologydb.links.items()
            for d in m
        ),
        "hosts": sorted(
            (m, h.port.dpid, h.port.port_no)
            for m, h in ctl.topology_manager.topologydb.hosts.items()
        ),
        "events": [_event(e) for e in events],
    }


def run_both(scenario, *args):
    """Run ``scenario(S, *args)`` on both sides; return their states."""
    return scenario(REF, *args), scenario(PORT, *args)


def assert_same(scenario, *args):
    ref, got = run_both(scenario, *args)
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key] == ref[key], key
    return ref


# -- scenarios: tests/test_control.py --------------------------------------


def sc_discovery(S):
    return state(*build(S, diamond))


def sc_process_lifecycle(S):
    fabric, ctl, events = build(S, diamond)
    announce(S, fabric, MAC[1], "LAUNCH", 0)
    announce(S, fabric, MAC[4], "LAUNCH", 1)
    announce(S, fabric, MAC[1], "EXIT", 0)
    payload = b"".join(
        S.Announcement(S.AnnouncementType.LAUNCH, r).encode() for r in range(5)
    )
    for data in (payload, b"\x07\x00"):  # a batch, then a malformed record
        fabric.hosts[MAC[2]].send(S.of.Packet(
            eth_src=MAC[2], eth_dst="ff:ff:ff:ff:ff:ff",
            eth_type=S.of.ETH_TYPE_IP, ip_proto=S.of.IPPROTO_UDP,
            udp_dst=61000, payload=data,
        ))
    return state(fabric, ctl, events)


def sc_unicast(S):
    fabric, ctl, events = build(S, diamond)
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
    fabric.hosts[MAC[3]].send(ip_packet(S, MAC[3], MAC[2]))
    return state(fabric, ctl, events)


def sc_broadcast(S):
    fabric, ctl, events = build(S, diamond)
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], "04:00:00:00:00:99"))
    fabric.hosts[MAC[2]].send(ip_packet(S, MAC[2], "ff:ff:ff:ff:ff:ff"))
    fabric.hosts[MAC[2]].send(ip_packet(S, MAC[2], "33:33:00:00:00:01"))
    return state(fabric, ctl, events)


def sc_mpi_p2p(S):
    fabric, ctl, events = build(S, diamond)
    announce(S, fabric, MAC[1], "LAUNCH", 0)
    announce(S, fabric, MAC[4], "LAUNCH", 1)
    send_vmac(S, fabric, MAC[1], "P2P", 0, 1)
    send_vmac(S, fabric, MAC[1], "P2P", 0, 1)
    send_vmac(S, fabric, MAC[1], "P2P", 0, 7)  # unresolved rank: dropped
    announce(S, fabric, MAC[4], "EXIT", 1)  # tears the flows down
    return state(fabric, ctl, events)


def sc_proactive(S, policy, coll, src, dst):
    fabric, ctl, events = build(S, diamond, collective_policy=policy)
    for i, rank in ((1, 0), (2, 1), (3, 2), (4, 3)):
        announce(S, fabric, MAC[i], "LAUNCH", rank)
    send_vmac(S, fabric, MAC[src + 1], coll, src, dst)
    for s in range(4):
        for d in range(4):
            if s != d:
                send_vmac(S, fabric, MAC[s + 1], coll, s, d)
    return state(fabric, ctl, events)


def sc_gather_noncontiguous(S):
    fabric, ctl, events = build(S, diamond)
    for i, rank in {1: 10, 2: 11, 3: 12, 4: 25}.items():
        announce(S, fabric, MAC[i], "LAUNCH", rank)
    send_vmac(S, fabric, MAC[2], "GATHER", 11, 10)
    send_vmac(S, fabric, MAC[1], "GATHER", 10, 7)  # unregistered root
    return state(fabric, ctl, events)


def sc_link_failure(S):
    fabric, ctl, events = build(S, diamond)
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
    fabric.hosts[MAC[2]].send(ip_packet(S, MAC[2], MAC[3]))
    fabric.remove_link(2, 3, 4, 2)
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
    return state(fabric, ctl, events)


def sc_switch_death(S):
    fabric, ctl, events = build(S, diamond)
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[2]))
    fabric.remove_switch(2)
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
    return state(fabric, ctl, events)


def sc_datapath_down(S):
    fabric, ctl, events = build(S, diamond)
    ctl.bus.publish(S.ev.EventDatapathDown(2))
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
    ctl.bus.publish(S.ev.EventDatapathUp(2))
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
    return state(fabric, ctl, events)


def sc_monitor(S):
    fabric, ctl, events = build(S, diamond, collective_policy="balanced")
    ctl.monitor.poll(now=100.0)
    for _ in range(3):
        fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
    ctl.monitor.poll(now=101.0)
    fabric.remove_switch(3)
    ctl.monitor.poll(now=102.0)
    out = state(fabric, ctl, events)
    out["link_util"] = sorted(ctl.topology_manager.link_util.items())
    return out


# -- scenarios: tests/test_collective_blocks.py -----------------------------


def sc_blocks(S, policy):
    """The block install at toy scale on fat-tree k=4, 8 ranks: kickoff
    (twice: idempotent), every pair delivered, a link failure re-routes
    the blocks, a process exit tears them down."""
    fabric = S.topogen.fattree(4).to_fabric()
    ctl = S.Controller(fabric, make_config(
        S, block_install_threshold=1, collective_policy=policy,
    ))
    events: list = []
    ctl.bus.tap(events.append)
    ctl.attach()
    macs = sorted(fabric.hosts)[:8]
    launch_all(S, fabric, macs)
    send_vmac(S, fabric, macs[0], "ALLTOALL", 0, 1)
    send_vmac(S, fabric, macs[0], "ALLTOALL", 0, 1)
    for s in range(8):
        for d in range(8):
            if s != d:
                send_vmac(S, fabric, macs[s], "ALLTOALL", s, d)
    install = next(iter(ctl.router.collectives))
    cable = next(
        c for c in fabric.links
        if (c[0], c[2]) in install.links or (c[2], c[0]) in install.links
    )
    fabric.remove_link(*cable)
    send_vmac(S, fabric, macs[2], "ALLTOALL", 2, 5)
    announce(S, fabric, macs[7], "EXIT", 7)
    return state(fabric, ctl, events)


# -- scenarios: tests/test_discovery.py and test_flow_expiry.py -------------


def sc_packet_discovery(S, wire):
    fabric, ctl, events = build(
        S, diamond, {"discovery": "packet", "wire": wire}, observe_links=True,
    )
    for i, rank in ((1, 0), (4, 1)):
        announce(S, fabric, MAC[i], "LAUNCH", rank)
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
    fabric.remove_link(1, 2, 2, 2)
    fabric.add_link(1, 2, 2, 2)
    fabric.hosts[MAC[2]].send(ip_packet(S, MAC[2], MAC[3]))
    return state(fabric, ctl, events)


def sc_flow_expiry(S, wire):
    fabric, ctl, events = build(
        S, diamond, {"wire": wire}, flow_idle_timeout=5, flow_hard_timeout=30,
    )
    fabric.tick(0.0)
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
    fabric.hosts[MAC[2]].send(ip_packet(S, MAC[2], MAC[3]))
    fabric.tick(4.0)
    fabric.hosts[MAC[2]].send(ip_packet(S, MAC[2], MAC[3]))
    fabric.tick(8.0)  # 1 -> 4 idles out, 2 -> 3 was refreshed
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
    fabric.tick(40.0)  # hard timeout: everything goes
    return state(fabric, ctl, events)


# -- scenarios: tests/test_recovery.py (no fault injection) -----------------


def sc_crash_redial(S, wire):
    fabric, ctl, events = build(S, diamond, {"wire": wire})
    announce(S, fabric, MAC[1], "LAUNCH", 0)
    announce(S, fabric, MAC[4], "LAUNCH", 1)
    fabric.hosts[MAC[1]].send(ip_packet(S, MAC[1], MAC[4]))
    fabric.hosts[MAC[4]].send(ip_packet(S, MAC[4], MAC[1]))
    send_vmac(S, fabric, MAC[1], "P2P", 0, 1)
    fabric.crash_switch(2)
    fabric.redial_switch(2)
    announce(S, fabric, MAC[4], "EXIT", 1)
    fabric.tick(0.0)
    return state(fabric, ctl, events)


SCENARIOS = {
    "discovery": (sc_discovery,),
    "process_lifecycle": (sc_process_lifecycle,),
    "unicast": (sc_unicast,),
    "broadcast": (sc_broadcast,),
    "mpi_p2p": (sc_mpi_p2p,),
    "alltoall_balanced": (sc_proactive, "balanced", "ALLTOALL", 0, 1),
    "alltoall_shortest": (sc_proactive, "shortest", "ALLTOALL", 0, 1),
    "alltoall_adaptive": (sc_proactive, "adaptive", "ALLTOALL", 0, 1),
    "bcast_balanced": (sc_proactive, "balanced", "BCAST", 2, 3),
    "gather_noncontiguous": (sc_gather_noncontiguous,),
    "link_failure": (sc_link_failure,),
    "switch_death": (sc_switch_death,),
    "datapath_down": (sc_datapath_down,),
    "monitor": (sc_monitor,),
    "blocks_shortest": (sc_blocks, "shortest"),
    "blocks_balanced": (sc_blocks, "balanced"),
    "blocks_adaptive": (sc_blocks, "adaptive"),
    "packet_discovery": (sc_packet_discovery, False),
    "packet_discovery_wire": (sc_packet_discovery, True),
    "flow_expiry": (sc_flow_expiry, False),
    "flow_expiry_wire": (sc_flow_expiry, True),
    "crash_redial": (sc_crash_redial, False),
    "crash_redial_wire": (sc_crash_redial, True),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    """The port's controller leaves the fabric, its stores and the bus
    exactly as the reference's does."""
    scenario, *args = SCENARIOS[name]
    ref = assert_same(scenario, *args)
    # each scenario does something: a route, a rank or a flow was made
    assert ref["fdb_pairs"] or ref["ranks"] or ref["tables"]


# -- TopologyDB: the surface the control plane reads ------------------------


def _golden_diamond(TopologyDB, Host, Link, Port, Switch, **kw):
    """``tests/topo_fixtures.diamond``, built through the mutators so the
    delta log records it."""
    db = TopologyDB(**kw)
    for dpid in (1, 2, 3, 4):
        db.add_switch(Switch.make(dpid))
    for a, pa, b, pb in ((1, 2, 2, 2), (1, 3, 3, 3), (2, 3, 4, 2), (3, 2, 4, 3)):
        db.add_link(Link(Port(a, pa), Port(b, pb)))
        db.add_link(Link(Port(b, pb), Port(a, pa)))
    for dpid in (1, 2, 3, 4):
        db.add_host(Host(f"02:00:00:00:00:0{dpid}", Port(dpid, 1)))
    return db


def _dbs():
    from sdnmpi_tpu.core import topology_db as j
    from sdnmpi_tpu_torch.core import topology_db as p

    ref = _golden_diamond(j.TopologyDB, j.Host, j.Link, j.Port, j.Switch,
                          backend="jax")
    got = _golden_diamond(p.TopologyDB, p.Host, p.Link, p.Port, p.Switch,
                          device="cpu")
    return j, ref, p, got


def test_find_all_routes_matches_jax():
    _, ref, _, got = _dbs()
    macs = sorted(ref.hosts)
    for s in macs:
        for d in macs:
            for cap in (None, 1):
                assert got.find_all_routes(s, d, max_paths=cap) == (
                    ref.find_all_routes(s, d, max_paths=cap))
            assert got.find_route(s, d, multiple=True) == (
                ref.find_route(s, d, multiple=True))
    assert got.find_all_routes(macs[0], macs[3])[0] == [
        [(1, 2), (2, 3), (4, 1)], [(1, 3), (3, 2), (4, 1)]]


def test_matrices_and_dist_device_match_jax():
    _, ref, _, got = _dbs()
    j_t, j_dist, j_next = ref._jax_oracle().matrices(ref)
    p_t, p_dist, p_next = got._oracle_engine().matrices(got)
    np.testing.assert_array_equal(p_t.dpids, np.asarray(j_t.dpids))
    np.testing.assert_array_equal(p_dist, np.asarray(j_dist))
    np.testing.assert_array_equal(p_next, np.asarray(j_next))
    np.testing.assert_array_equal(
        got._oracle_engine().dist_device.numpy(),
        np.asarray(ref._jax_oracle().dist_device),
    )


def test_delta_log_matches_jax():
    j, ref, p, got = _dbs()
    assert got.deltas_since(0) == ref.deltas_since(0)
    v = got.version
    for db, mod in ((ref, j), (got, p)):
        db.delete_link(db.links[2][4])
        db.add_link(mod.Link(mod.Port(2, 3), mod.Port(4, 2)))
        db.add_switch(mod.Switch.make(2))  # an upsert
        db.delete_host("02:00:00:00:00:03")
    assert got.deltas_since(v) == ref.deltas_since(v)
    for deltas in (got.deltas_since(v), got.deltas_since(v)[:1],
                   [(9, "switch_upsert", 2)], [(9, "host", 3)]):
        assert p.narrowed_dirty_set(deltas) == j.narrowed_dirty_set(deltas)
    assert p.narrowed_dirty_set(got.deltas_since(v)[:1]) == {2, 4}
    # a switch deletion breaks the log: the epoch is no longer covered
    for db in (ref, got):
        db.delete_switch(db.switches[3])
    assert got.deltas_since(v) is None and ref.deltas_since(v) is None
    assert got.deltas_since(got.version) == ref.deltas_since(ref.version) == []


def test_narrowed_dirty_set_podmap_rules_match_jax():
    """The intra-pod link-add narrowing against the reference's, on the
    fat-tree k=4 pod map (``tests/test_routecache.py``'s cases)."""
    from sdnmpi_tpu.core.topology_db import narrowed_dirty_set as j_rule
    from sdnmpi_tpu.topogen import fattree as j_fattree
    from sdnmpi_tpu_torch.core.topology_db import narrowed_dirty_set as p_rule
    from sdnmpi_tpu_torch.topogen import fattree as p_fattree

    ref = j_fattree(4).to_topology_db(backend="py")
    got = p_fattree(4).to_topology_db(backend="py")
    for deltas in ([(1, "link+", 15, 16, 61)], [(1, "link+", 13, 14, 61)],
                   [(1, "link+", 15, 11, 61)],
                   [(1, "link-", 5, 1), (2, "link+", 15, 16, 61)]):
        assert p_rule(deltas, got.podmap, got) == j_rule(deltas, ref.podmap, ref)
        assert p_rule(deltas, got.podmap, None) == j_rule(deltas, ref.podmap, None)
    assert got.live_border_set() == ref.live_border_set()


# -- the planes beside the hierarchical oracle ------------------------------


def sc_hier_planes(S, knob):
    """Fat-tree k=4 under the hierarchical oracle with ``knob``'s planes
    on: unicast packet-ins, a link failure and its re-route, and a block
    installed 8-rank alltoall."""
    fabric = S.topogen.fattree(4).to_fabric()
    ctl = S.Controller(fabric, make_config(S, block_install_threshold=1, **knob))
    if ctl.traffic is not None:
        ctl.traffic.clock = iter(range(100)).__next__  # a 1 Hz flush clock
    events: list = []
    ctl.bus.tap(events.append)
    ctl.attach()
    macs = sorted(fabric.hosts)[:8]
    for a, b in ((0, 5), (1, 6), (7, 2)):
        fabric.hosts[macs[a]].send(ip_packet(S, macs[a], macs[b]))
    launch_all(S, fabric, macs)
    send_vmac(S, fabric, macs[0], "ALLTOALL", 0, 1)
    ctl.monitor.poll(now=100.0)
    fabric.remove_link(*sorted(fabric.links)[0])
    fabric.hosts[macs[0]].send(ip_packet(S, macs[0], macs[5]))
    ctl.monitor.poll(now=101.0)
    out = state(fabric, ctl, events)
    out["oracle"] = type(ctl.topology_manager.topologydb._oracle).__name__
    # the hier branches of the congestion report and the pod-mode matrix
    out["congestion"] = repr(ctl.topology_manager.congestion)
    out["matrix"] = ctl.traffic.matrix() if ctl.traffic is not None else None
    return out


@pytest.mark.parametrize("knob,item", [
    ({"util_plane": True, "flight_recorder": True, "hier_oracle": True}, "A13"),
    ({"delta_reval": True, "hier_oracle": True}, "A13"),
    ({"rpc_telemetry": True, "hier_pod_target": 8}, "A13"),
    ({"hier_pod_target": 16}, "A13"),
    ({"schedule_collectives": True, "metrics_timeline": True,
      "hier_oracle": True}, "A13"),
    ({"fabric_audit": True, "hier_pod_target": 4}, "A13"),
    ({"traffic_plane": True, "hier_oracle": True}, "A13"),
    ({"flight_recorder": True, "hier_pod_target": 32}, "A13"),
    ({"metrics_timeline": True, "hier_oracle": True}, "A13"),
    ({"slo_targets": {"t": (50.0, 0.99)}, "hier_oracle": True}, "A13"),
    ({"replica_peer": "127.0.0.1:1", "hier_pod_target": 2}, "A13"),
    ({"hier_oracle": True}, "A13"),
])
def test_deferred_plane_raises(knob, item):
    """The plane sets that once waited for the hierarchical oracle
    (ROADMAP ``item``) run beside it: both controllers install the same
    flows and blocks, publish the same events and pick the same oracle
    (``HierOracle`` under ``hier_oracle``; ``hier_pod_target`` alone
    keeps the dense one, as in the reference)."""
    ref = assert_same(sc_hier_planes, knob)
    assert ref["oracle"] == ("HierOracle" if knob.get("hier_oracle") else "RouteOracle")


def test_other_unported_seams_raise():
    """The bus seams of the observability and HA planes answer as the
    reference's do: the telemetry snapshot (same sections), the replica
    status of a single controller, the traffic matrix and timeline of a
    fresh controller; a pair is built from an ownership map and a link."""
    def seams(S):
        fabric, ctl, _ = build(S, diamond)
        snap = ctl.telemetry()
        assert ctl.bus.request(S.ev.TelemetryRequest()).telemetry.keys() == snap.keys()
        return {
            "telemetry": sorted(snap),
            "replica": ctl.bus.request(S.ev.ReplicaStatusRequest()).status,
            "matrix": ctl.bus.request(S.ev.TrafficMatrixRequest()).matrix,
            "timeline": ctl.bus.request(S.ev.TimelineRequest(None)).timeline,
            "planes": [getattr(ctl, n) is not None for n in (
                "audit", "traffic", "sentinel", "flight", "timeline", "slo",
                "replica")],
        }

    assert seams(PORT) == seams(REF)
    from sdnmpi_tpu_torch.control.ownership import OwnershipMap
    from sdnmpi_tpu_torch.control.replica import LoopLink

    link, _ = LoopLink.pair()
    ctl = PORT.Controller(diamond(PORT), make_config(PORT),
                          ownership=OwnershipMap(2, 0), replica_link=link)
    assert ctl.replica is not None
    assert ctl.bus.request(PORT.ev.ReplicaStatusRequest()).status["mode"] != "off"


def test_port_defaults_and_device():
    """The port's Config differs from the reference's only where its
    docstring says, and asks for the card unless told otherwise."""
    import dataclasses as dc

    import torch

    ref = {f.name: f.default for f in dc.fields(REF.Config)}
    got = {f.name: f.default for f in dc.fields(PORT.Config)}
    differ = {k for k in ref if got.get(k, object()) != ref[k]}
    assert differ == {"oracle_backend"}
    assert set(got) - set(ref) == {"device"}
    assert got["device"] == "cuda" and got["oracle_backend"] == "torch"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PORT.Controller(diamond(PORT), PORT.Config())
    ctl = PORT.Controller(diamond(PORT), PORT.Config(device="cpu"))
    assert ctl.topology_manager.topologydb.device.type == "cpu"


# -- device-runtime telemetry -----------------------------------------------


def test_devprof_and_device_trace(tmp_path):
    import torch

    from sdnmpi_tpu_torch.utils import devprof
    from sdnmpi_tpu_torch.utils.metrics import REGISTRY
    from sdnmpi_tpu_torch.utils.tracing import device_trace

    assert devprof.install_monitoring() is False
    snap = devprof.sample_memory("cpu")
    assert snap["fallback"] and snap["in_use"] > 0
    assert REGISTRY.get("device_memory_host_fallback").value == 1.0
    with device_trace(""):
        pass
    with device_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert list((tmp_path / "trace").glob("device_trace-*.json"))
    clock = iter([0.0, 1.0, 5.0])
    cap = devprof.ProfileCapture(str(tmp_path / "cap"), seconds=3.0,
                                 clock=lambda: next(clock))
    assert cap.on_anomaly() and cap.active and not cap.on_anomaly()
    assert not cap.tick() and cap.tick()
    assert list((tmp_path / "cap").glob("anomaly-*.json"))


# -- ROADMAP C4: dist=None on the CPU -----------------------------------------


def _chain(n: int) -> np.ndarray:
    adj = np.zeros((n, n), np.float32)
    adj[np.arange(n - 1), np.arange(1, n)] = 1.0
    return adj


def test_dist_none_routes_far_pairs_as_the_reference():
    """On a directed chain cut below its diameter, ``dist=None`` on the
    CPU computes exact distances, as the reference does off the TPU, so
    the far pairs route and both programs equal the reference's."""
    import jax.numpy as jnp
    import torch

    from sdnmpi_tpu.oracle import adaptive as j_adaptive
    from sdnmpi_tpu.oracle import dag as j_dag
    from sdnmpi_tpu_torch.oracle import adaptive, dag

    n, levels = 10, 3  # diameter 9
    adj = _chain(n)
    src = np.array([0, 0, 2, 5, 1], np.int32)
    dst = np.array([9, 2, 8, 6, 7], np.int32)
    li, lj = np.nonzero(adj)
    traffic = np.zeros((n, n), np.float32)
    np.add.at(traffic, (dst, src), 1.0)
    kw = dict(levels=levels, rounds=2, max_len=n)
    buf = j_dag.route_collective(
        jnp.asarray(adj), jnp.asarray(li.astype(np.int32)),
        jnp.asarray(lj.astype(np.int32)), jnp.zeros(len(li), jnp.float32),
        jnp.asarray(traffic), jnp.asarray(src), jnp.asarray(dst), max_degree=2,
        **kw)
    j_slots, j_maxc = j_dag.unpack_result(buf, len(src), n)
    slots, maxc = dag.route_collective(
        torch.from_numpy(adj), torch.from_numpy(li.astype(np.int32)),
        torch.from_numpy(lj.astype(np.int32)), torch.zeros(len(li)),
        torch.from_numpy(traffic), torch.from_numpy(src), torch.from_numpy(dst),
        **kw)
    np.testing.assert_array_equal(slots.numpy(), np.asarray(j_slots))
    assert float(maxc) == float(j_maxc)
    nodes = dag.slots_to_nodes(adj, src, slots.numpy(), dst, complete=True)
    assert (nodes[0, : n] == np.arange(n)).all()  # 0 -> 9 routed hop by hop

    util = np.zeros((n, n), np.float32)
    weight = np.ones(len(src), np.float32)
    akw = dict(levels=levels, max_len=n, n_candidates=2)
    j_out = j_adaptive.route_adaptive(
        jnp.asarray(adj), jnp.asarray(util), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(weight), n, **akw)
    p_out = adaptive.route_adaptive(
        torch.from_numpy(adj), torch.from_numpy(util), torch.from_numpy(src),
        torch.from_numpy(dst), torch.from_numpy(weight), n, **akw)
    for g, w in zip(p_out[:3], j_out[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(p_out[3].numpy(), np.asarray(j_out[3]), rtol=1e-6)
    assert (p_out[1].numpy()[0, :n] == np.arange(n)).all()

"""The port's OpenFlow 1.0 TCP southbound against the JAX package's.

Scripted raw-byte switches (``tests/test_southbound.py::FakeSwitch``,
which answers barriers here as a real switch does) dial each package's
``OFSouthbound`` on ``127.0.0.1``, one package after the other, and
record every message the controller sends them. The byte streams each
switch receives must be equal: the handshake, the bootstrap flows,
FlowMods, barriers and packet-outs, in order. The reference runs
backend ``"jax"`` with the planes the port has not ported yet off, the
port ``device="cpu"``.
"""

import asyncio
import importlib
import socket

from tests.test_southbound import FakeSwitch
from tests.test_torch_control import MAC, PORT, REF, make_config

N_RANKS = 16


def mod(S, name):
    pkg = "sdnmpi_tpu" if S is REF else "sdnmpi_tpu_torch"
    return importlib.import_module(f"{pkg}.{name}")


class ByteSwitch(FakeSwitch):
    """A FakeSwitch that keeps every controller message as bytes and
    acknowledges barriers."""

    def __init__(self, dpid, ports):
        super().__init__(dpid, ports)
        self.raw: list[bytes] = []

    async def _on_message(self, msg_type, msg, xid):
        from sdnmpi_tpu.protocol import ofwire

        self.raw.append(bytes(msg))
        if msg_type == ofwire.OFPT_BARRIER_REQUEST:
            await self.send(ofwire.encode_barrier_reply(xid))
        await super()._on_message(msg_type, msg, xid)


async def dial(switches, port):
    """Connect the switches one at a time (so each handshake's xids are
    fixed) and let them finish the handshake."""
    for sw in switches.values():
        await sw.connect(port)
        await sw.pump(0.05)


async def drain(switches, quiet_rounds=2, limit_s=20.0):
    """Pump until no switch receives anything for ``quiet_rounds``
    sweeps in a row."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + limit_s
    prev, quiet = None, 0
    while loop.time() < deadline and quiet < quiet_rounds:
        for sw in switches.values():
            await sw.pump(0.01)
        counts = [len(sw.raw) for sw in switches.values()]
        quiet = quiet + 1 if counts == prev else 0
        prev = counts


def announce_topology(S, ctl, spec_links, hosts):
    """The 'direct' discovery mode: link and host entities on the bus."""
    ev = mod(S, "control.events")
    tdb = mod(S, "core.topology_db")
    for a, pa, b, pb in spec_links:
        ctl.bus.publish(ev.EventLinkAdd(tdb.Link(tdb.Port(a, pa), tdb.Port(b, pb))))
        ctl.bus.publish(ev.EventLinkAdd(tdb.Link(tdb.Port(b, pb), tdb.Port(a, pa))))
    for mac, dpid, port in hosts:
        ctl.bus.publish(ev.EventHostAdd(tdb.Host(mac, tdb.Port(dpid, port))))


def _launch(S, mac, rank, kind="LAUNCH"):
    of = mod(S, "protocol.openflow")
    ann = mod(S, "protocol.announcement")
    return of.Packet(
        mac, "ff:ff:ff:ff:ff:ff", ip_proto=of.IPPROTO_UDP, udp_dst=61000,
        payload=ann.Announcement(getattr(ann.AnnouncementType, kind), rank).encode(),
    )


def sc_diamond(S) -> dict:
    """The diamond of ``tests/test_control.py`` over TCP: handshake,
    rank announcements, a routed unicast pair, a flood of an unknown
    destination and a reactive collective pair."""
    of = mod(S, "protocol.openflow")
    ofwire = mod(S, "protocol.ofwire")
    vmac = mod(S, "protocol.vmac")

    async def run():
        sb = mod(S, "control.southbound").OFSouthbound(host="127.0.0.1", port=0)
        ctl = S.Controller(sb, make_config(S))
        ctl.attach()
        await sb.serve()
        switches = {d: ByteSwitch(d, [1, 2, 3]) for d in (1, 2, 3, 4)}
        await dial(switches, sb.bound_port)
        links = [(1, 2, 2, 2), (1, 3, 3, 3), (2, 3, 4, 2), (3, 2, 4, 3)]
        announce_topology(S, ctl, links, [(MAC[d], d, 1) for d in (1, 2, 3, 4)])
        xid = 10
        for rank, d in enumerate((1, 4)):
            await switches[d].send(ofwire.encode_packet_in(
                _launch(S, MAC[d], rank), in_port=1, xid=xid))
            xid += 1
        for pkt in (
            of.Packet(MAC[1], MAC[4], eth_type=of.ETH_TYPE_IP),
            of.Packet(MAC[1], "04:00:00:00:00:99", eth_type=of.ETH_TYPE_IP),
            of.Packet(MAC[1], vmac.VirtualMac(
                vmac.CollectiveType.ALLTOALL, 0, 1).encode(),
                eth_type=of.ETH_TYPE_IP),
        ):
            await switches[1].send(ofwire.encode_packet_in(pkt, in_port=1, xid=xid))
            xid += 1
            await drain(switches)
        out = {d: sw.raw for d, sw in switches.items()}
        for sw in switches.values():
            await sw.close()
        await sb.close()
        return out

    return asyncio.run(run())


def test_diamond_bytes_match_the_reference():
    ref, got = sc_diamond(REF), sc_diamond(PORT)
    assert got == ref
    assert all(len(raw) > 4 for raw in got.values())


def sc_fattree_alltoall(S) -> dict:
    """``tests/test_southbound_scale.py`` on both packages: 20 switches
    of a k=4 fat-tree, 16 ranks announced as UDP:61000 packet-in bytes,
    one alltoall kickoff through the block install (threshold below its
    240 pairs), then rank 0's exit tearing the collective down."""
    of = mod(S, "protocol.openflow")
    ofwire = mod(S, "protocol.ofwire")
    vmac = mod(S, "protocol.vmac")
    spec = S.topogen.fattree(4)

    async def run():
        sb = mod(S, "control.southbound").OFSouthbound(host="127.0.0.1", port=0)
        ctl = S.Controller(sb, make_config(S, block_install_threshold=100))
        ctl.attach()
        await sb.serve()
        ports = {d: set() for d in spec.switches}
        for mac, dpid, port in spec.hosts:
            ports[dpid].add(port)
        for a, pa, b, pb in spec.links:
            ports[a].add(pa)
            ports[b].add(pb)
        switches = {d: ByteSwitch(d, sorted(ports[d])) for d in spec.switches}
        await dial(switches, sb.bound_port)
        announce_topology(S, ctl, spec.links, spec.hosts)
        hosts = spec.hosts[:N_RANKS]
        for rank, (mac, dpid, port) in enumerate(hosts):
            await switches[dpid].send(ofwire.encode_packet_in(
                _launch(S, mac, rank), in_port=port, xid=100 + rank))
        await drain(switches)
        mac0, dpid0, port0 = hosts[0]
        await switches[dpid0].send(ofwire.encode_packet_in(
            of.Packet(mac0, vmac.VirtualMac(vmac.CollectiveType.ALLTOALL, 0, 1).encode(),
                      eth_type=of.ETH_TYPE_IP),
            in_port=port0, xid=999))
        await drain(switches)
        installed = {d: len(sw.flow_mods) for d, sw in switches.items()}
        await switches[dpid0].send(ofwire.encode_packet_in(
            _launch(S, mac0, 0, "EXIT"), in_port=port0, xid=1000))
        await drain(switches)
        out = {d: sw.raw for d, sw in switches.items()}
        n_coll = len(ctl.router.collectives)
        for sw in switches.values():
            await sw.close()
        await sb.close()
        return out, installed, n_coll

    return asyncio.run(run())


def test_fattree_block_install_bytes_match_the_reference():
    (ref, ref_mods, _), (got, got_mods, n_coll) = (
        sc_fattree_alltoall(REF), sc_fattree_alltoall(PORT))
    assert got == ref
    assert got_mods == ref_mods
    # 240 pairs of 1 to 5 hops each, plus the bootstrap flows
    n_pairs = N_RANKS * (N_RANKS - 1)
    assert n_pairs < sum(got_mods.values()) - 2 * len(got_mods) <= 5 * n_pairs + 8
    assert n_coll == 0  # the exit tore the collective down


def sc_listen(S) -> dict:
    """``--listen`` through the launcher: a switch dials the launched
    controller and receives the handshake, the bootstrap flows and the
    LLDP probes of discovery."""
    launch = mod(S, "launch")
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    argv = ["--listen", f"127.0.0.1:{port}", "--no-rpc", "--duration", "5",
            "--profile", "no-monitor"]
    if S is REF:
        argv += ["--backend", "jax", "--no-fabric-audit", "--no-traffic-plane",
                 "--no-flight-recorder", "--no-delta-reval"]
    else:
        argv += ["--device", "cpu"]
    args = launch.build_parser().parse_args(argv)

    async def run():
        task = asyncio.ensure_future(launch.amain(args))
        sw = ByteSwitch(5, [1, 2])
        try:
            for _ in range(100):
                try:
                    await sw.connect(port)
                    break
                except OSError:
                    await asyncio.sleep(0.05)
            await sw.pump(0.4)
            await sw.close()
        finally:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        return sw.raw, sorted(m.priority for m in sw.flow_mods)

    return asyncio.run(run())


def test_listen_mode_through_the_launcher_matches_the_reference():
    ref, got = sc_listen(REF), sc_listen(PORT)
    assert got == ref
    assert got[1] == [0xFFFE, 0xFFFF]

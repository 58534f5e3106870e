"""Packet-level topology discovery: LLDP link probing + host learning.

The reference gets its link map from Ryu's ``switches`` app under
``--observe-links`` (reference: run_router.sh:2): the controller floods
an LLDP frame out of every switch port; when the frame packet-ins back
from the adjacent switch, the (origin, arrival) pair is a directed link
(consumed at reference: sdnmpi/topology.py:184-202). Hosts are learned
from the source MAC of ordinary traffic arriving on non-link ports
(Ryu's host tracker behind EventHostAdd, reference: topology.py:200-202).

This app is that mechanism for the simulated fabric: with
``Fabric(discovery="packet")`` the fabric announces only what a real OF
channel would (datapath up + port sets from the handshake) and the
controller must *earn* the link/host map from actual frames — the same
``EventLinkAdd``/``EventHostAdd`` stream the direct mode publishes,
produced from bytes instead. tests/test_discovery.py asserts the two
modes converge to identical TopologyDB state.

Switch/port knowledge rides EventSwitchEnter/EventPortAdd (the OF
features/port-status channel, legitimately switch-reported — LLDP is
only about LINKS); link *deletion* likewise stays event-driven (port
down / switch leave), as in Ryu where LLDP timeout merely approximates
what port-status reports directly.
"""

from __future__ import annotations

import logging

from sdnmpi_tpu_torch.config import Config, DEFAULT_CONFIG
from sdnmpi_tpu_torch.control import events as ev
from sdnmpi_tpu_torch.control.bus import EventBus
from sdnmpi_tpu_torch.core.topology_db import Host, Link, Port
from sdnmpi_tpu_torch.protocol import openflow as of
from sdnmpi_tpu_torch.protocol.lldp import decode_lldp, encode_lldp

log = logging.getLogger("LLDPDiscovery")


class LLDPDiscovery:
    name = "LLDPDiscovery"

    def __init__(
        self,
        bus: EventBus,
        southbound,
        config: Config = DEFAULT_CONFIG,
    ) -> None:
        self.bus = bus
        self.southbound = southbound
        self.config = config
        #: dpid -> known port numbers (from the OF handshake events)
        self.ports: dict[int, set[int]] = {}
        #: directed links already announced: (src_dpid, src_port, dst_dpid, dst_port)
        self.links: set[tuple[int, int, int, int]] = set()
        #: (dpid, port_no) known to face another switch — never host ports
        self.link_ports: set[tuple[int, int]] = set()
        #: announced hosts: mac -> (dpid, port_no); location tracked so a
        #: re-attached host is re-announced (TopologyDB.add_host upserts)
        self.hosts: dict[str, tuple[int, int]] = {}

        bus.subscribe(ev.EventSwitchEnter, self._ports_changed)
        bus.subscribe(ev.EventPortAdd, self._ports_changed)
        bus.subscribe(ev.EventSwitchLeave, self._switch_leave)
        bus.subscribe(ev.EventLinkDelete, self._link_delete)
        bus.subscribe(ev.EventPacketIn, self._packet_in)

    # -- probing -----------------------------------------------------------

    def probe(self, dpid: int | None = None) -> None:
        """Flood LLDP out of every known port (of one switch, or all).
        Each probe that crosses a live inter-switch link packet-ins back
        from the far side and becomes an EventLinkAdd."""
        targets = [dpid] if dpid is not None else sorted(self.ports)
        for d in targets:
            for port_no in sorted(self.ports.get(d, ())):
                self._send_probe(d, port_no)

    def _send_probe(self, dpid: int, port_no: int) -> None:
        self.southbound.packet_out(
            dpid,
            of.PacketOut(
                data=encode_lldp(dpid, port_no),
                actions=(of.ActionOutput(port_no),),
            ),
        )

    # -- port bookkeeping --------------------------------------------------

    def _ports_changed(self, event) -> None:
        sw = event.switch
        dpid = sw.dp.id  # Ryu-shaped entity (core/topology_db.py:72-77)
        self.ports[dpid] = {p.port_no for p in sw.ports}
        # probe ALL of the switch's ports, not just unseen port numbers:
        # a link re-cabled onto a previously-known port must be
        # re-discovered too (re-learning an existing link is a deduped
        # no-op, so the extra probes are harmless)
        self.probe(dpid)

    def _rebuild_link_ports(self) -> None:
        self.link_ports = {(l[0], l[1]) for l in self.links} | {
            (l[2], l[3]) for l in self.links
        }

    def _switch_leave(self, event) -> None:
        dpid = event.switch.dp.id
        self.ports.pop(dpid, None)
        self.links = {l for l in self.links if dpid not in (l[0], l[2])}
        self._rebuild_link_ports()
        # forget hosts on the dead switch so they re-announce on their
        # next packet from wherever they re-attach
        self.hosts = {m: loc for m, loc in self.hosts.items() if loc[0] != dpid}

    def _link_delete(self, event) -> None:
        link = event.link
        key = (link.src.dpid, link.src.port_no, link.dst.dpid, link.dst.port_no)
        self.links.discard(key)
        # freed ports may now face hosts; stop classifying them as transit
        self._rebuild_link_ports()

    # -- packet-in ---------------------------------------------------------

    def _packet_in(self, event: ev.EventPacketIn) -> None:
        pkt = event.pkt
        if pkt.eth_type == of.ETH_TYPE_LLDP:
            try:
                src_dpid, src_port = decode_lldp(pkt)
            except ValueError:
                log.debug("ignoring foreign LLDP frame")
                return
            self._learn_link(src_dpid, src_port, event.dpid, event.in_port)
            return
        self._learn_host(pkt.eth_src, event.dpid, event.in_port)

    def _learn_link(
        self, src_dpid: int, src_port: int, dst_dpid: int, dst_port: int
    ) -> None:
        key = (src_dpid, src_port, dst_dpid, dst_port)
        self.link_ports.add((src_dpid, src_port))
        self.link_ports.add((dst_dpid, dst_port))
        if key in self.links:
            return
        self.links.add(key)
        self.bus.publish(
            ev.EventLinkAdd(
                Link(Port(src_dpid, src_port), Port(dst_dpid, dst_port))
            )
        )

    def _learn_host(self, mac: str, dpid: int, in_port: int) -> None:
        if self.hosts.get(mac) == (dpid, in_port):
            return  # already announced at this location
        first_octet = int(mac[:2], 16)
        if first_octet & 0x01:  # broadcast/multicast source: never a host
            return
        if (dpid, in_port) in self.link_ports:
            return  # traffic transiting an inter-switch port
        # first sighting, or the host moved: (re-)announce — the
        # TopologyDB upserts host locations by MAC
        self.hosts[mac] = (dpid, in_port)
        self.bus.publish(ev.EventHostAdd(Host(mac, Port(dpid, in_port))))

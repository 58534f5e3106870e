"""Simulated switch fabric — the southbound the reference never had tests for.

The reference drives real OpenFlow 1.0 switches and was integration-tested
only by hand against Mininet (SURVEY §4); its unit tests bypass the network
entirely. This module provides the missing layer: an in-process fabric of
switches with priority-ordered flow tables, links, hosts, and per-port
counters, speaking the message shapes in protocol/openflow.py. The apps
drive it exactly like the reference drives datapaths (FlowMod / PacketOut /
PortStats / packet-in), so the whole control plane is testable end to end —
announcement in, flows installed, packets forwarded, counters ticking.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

from sdnmpi_tpu_torch.control.events import (
    EventBarrierAck,
    EventDatapathDown,
    EventDatapathUp,
    EventHostAdd,
    EventLinkAdd,
    EventLinkDelete,
    EventFlowRemoved,
    EventPacketIn,
    EventPortAdd,
    EventSwitchEnter,
    EventSwitchLeave,
    EventTopologyChanged,
)
from sdnmpi_tpu_torch.control.recovery import InstallVerdict
from sdnmpi_tpu_torch.core.topology_db import Host, Link, Port, Switch
from sdnmpi_tpu_torch.protocol import openflow as of
from sdnmpi_tpu_torch.utils.metrics import REGISTRY

log = logging.getLogger(__name__)

# wire-mode twin of the real southbound's batched-encode volume counter
# (registered idempotently — whichever module imports first wins the
# help string, the instrument is shared)
_m_encode_bytes = REGISTRY.counter(
    "southbound_encode_bytes_total",
    "bytes produced by batched FlowMod window encodes",
)

_MAX_HOPS = 64  # forwarding-loop guard for the simulation


@dataclasses.dataclass
class SimPort:
    port_no: int
    #: ("switch", dpid, port_no) | ("host", mac) | None
    peer: Optional[tuple] = None
    rx_packets: int = 0
    rx_bytes: int = 0
    tx_packets: int = 0
    tx_bytes: int = 0


@dataclasses.dataclass
class _FlowEntry:
    priority: int
    match: of.Match
    actions: tuple[of.Action, ...]
    seq: int  # insertion order tie-break
    # expiry state (0 timeouts = permanent, the reference's only mode)
    idle_timeout: int = 0
    hard_timeout: int = 0
    installed_at: float = 0.0
    last_hit: float = 0.0
    packet_count: int = 0
    byte_count: int = 0
    cookie: int = 0
    #: True for the per-lookup entries synthesized from the block table
    #: (they carry no expiry state and are not in flow_table)
    synthetic: bool = False
    #: fault-injection state (control/faults.py "freeze" mutation): the
    #: entry still matches and forwards but its counters stopped — the
    #: dead-counter-ASIC fault the audit plane's counter-dead diff
    #: exists to catch
    frozen: bool = False


class _BlockSetEntry:
    """One switch's share of a FlowBlockSet: the (sub-flow, hop) rows
    whose ``hop_dpid`` is this switch.

    Row arrays are views of the install-time partition (no copies). The
    (src, dst) -> (member, hop row) map is built lazily on first
    lookup, so only switches that actually field a data-plane packet
    pay for indexing; a later row overwrites an earlier one for the
    same member, which shortcuts revisit loops (see FlowBlockSet).
    """

    __slots__ = ("priority", "seq", "block", "sub_rows", "hop_rows", "_index")

    def __init__(self, priority: int, seq: int, block, sub_rows, hop_rows):
        self.priority = priority
        self.seq = seq
        self.block = block
        self.sub_rows = sub_rows  # [R] int64 sub-flow ids at this switch
        self.hop_rows = hop_rows  # [R] int64 hop index of each row
        self._index = None

    def member(self, src_key: int, dst_key: int):
        if self._index is None:
            import numpy as np

            b = self.block
            bounds = np.asarray(b.bounds)
            starts = bounds[self.sub_rows]
            reps = bounds[self.sub_rows + 1] - starts
            total = int(reps.sum())
            # member ids: concatenated aranges of each row's slice
            # (vectorized — a core switch's entry can cover millions of
            # member flows, so no Python-level per-member loop)
            m_ids = np.repeat(starts + reps - reps.cumsum(), reps) + np.arange(
                total
            )
            last = self.hop_rows == np.asarray(b.hop_len)[self.sub_rows] - 1
            ports = np.where(
                last, -1, np.asarray(b.hop_port)[self.sub_rows, self.hop_rows]
            )
            m_ports = np.repeat(ports, reps)
            src = np.asarray(b.src)[m_ids].tolist()
            dst = np.asarray(b.dst)[m_ids].tolist()
            self._index = dict(
                zip(zip(src, dst), zip(m_ids.tolist(), m_ports.tolist()))
            )
        return self._index.get((src_key, dst_key))

    def actions_for(self, hit) -> tuple[of.Action, ...]:
        from sdnmpi_tpu_torch.utils.mac import int_to_mac

        member, port = hit
        b = self.block
        if port >= 0:  # transit hop
            return (of.ActionOutput(port),)
        out: tuple[of.Action, ...] = ()
        if b.rewrite is not None:
            out = (of.ActionSetDlDst(int_to_mac(int(b.rewrite[member]))),)
        return out + (of.ActionOutput(int(b.final_port[member])),)


class SimSwitch:
    def __init__(self, fabric: "Fabric", dpid: int) -> None:
        self.fabric = fabric
        self.dpid = dpid
        self.ports: dict[int, SimPort] = {}
        self.flow_table: list[_FlowEntry] = []
        #: match -> entries with that exact match (Match is frozen, so
        #: hashable): O(1) ADD-replace and DELETE lookups instead of a
        #: full-table dataclass-eq scan per FlowMod — reconciliation
        #: re-drives whole desired sets, so installs dominate the sim
        self._by_match: dict[of.Match, list[_FlowEntry]] = {}
        self.block_table: list[_BlockSetEntry] = []
        self.local_delivered: list[of.Packet] = []  # OFPP_LOCAL sink
        #: packets parked switch-side while the controller decides
        #: (real OF 1.0 switches buffer the frame and send the controller
        #: a buffer_id; reference packet-outs reuse it, router.py:111-118)
        self.buffers: dict[int, of.Packet] = {}
        self._next_buffer = 0
        self._seq = 0

    MAX_BUFFERS = 1024  # FIFO cap, like a real switch's finite buffer pool

    def buffer_packet(self, pkt: of.Packet) -> int:
        self._next_buffer += 1
        self.buffers[self._next_buffer] = pkt
        while len(self.buffers) > self.MAX_BUFFERS:
            self.buffers.pop(next(iter(self.buffers)))
        return self._next_buffer

    def port(self, port_no: int) -> SimPort:
        return self.ports.setdefault(port_no, SimPort(port_no))

    # -- flow table -------------------------------------------------------

    def flow_mod(self, mod: of.FlowMod) -> None:
        if mod.command == of.OFPFC_ADD:
            # OF 1.0 §4.6: an ADD whose match+priority equal an existing
            # entry REPLACES it (counters reset). This is what makes
            # reconciliation idempotent: the recovery plane can re-drive
            # a desired set over a half-installed switch without
            # accumulating duplicate entries.
            bucket = self._by_match.setdefault(mod.match, [])
            old = next(
                (e for e in bucket if e.priority == mod.priority), None
            )
            if old is not None:
                bucket.remove(old)
                self.flow_table.remove(old)
            self._seq += 1
            now = self.fabric.now
            entry = _FlowEntry(
                mod.priority, mod.match, mod.actions, self._seq,
                idle_timeout=mod.idle_timeout,
                hard_timeout=mod.hard_timeout,
                installed_at=now, last_hit=now,
                cookie=mod.cookie,
            )
            bucket.append(entry)
            self.flow_table.append(entry)
            # highest priority first; earlier install wins ties
            self.flow_table.sort(key=lambda e: (-e.priority, e.seq))
        elif mod.command == of.OFPFC_DELETE:
            if mod.match == of.Match():
                # all-wildcard non-strict DELETE: the OF 1.0 "wipe the
                # table" idiom (every field wildcarded matches every
                # entry) — the recovery plane's resync escalation
                self.flow_table = []
                self._by_match.clear()
            else:
                doomed = self._by_match.pop(mod.match, None)
                if doomed:
                    doom_ids = {id(e) for e in doomed}
                    self.flow_table = [
                        e for e in self.flow_table if id(e) not in doom_ids
                    ]
        else:
            raise ValueError(f"unsupported flow_mod command {mod.command}")

    def drop_entries(self, doomed: set) -> None:
        """Remove entries (by identity) from the table AND the match
        index — the expiry sweep's bulk-removal seam (Fabric.tick)."""
        self.flow_table = [e for e in self.flow_table if id(e) not in doomed]
        for match in [
            m for m, b in self._by_match.items()
            if any(id(e) in doomed for e in b)
        ]:
            bucket = [e for e in self._by_match[match] if id(e) not in doomed]
            if bucket:
                self._by_match[match] = bucket
            else:
                del self._by_match[match]

    def add_block_entry(self, entry: _BlockSetEntry) -> None:
        self.block_table.append(entry)

    def remove_blocks(self, cookie: int) -> None:
        self.block_table = [
            e for e in self.block_table if e.block.cookie != cookie
        ]

    def lookup(self, pkt: of.Packet, in_port: int):
        """Highest-priority match across the scalar flow table and the
        block table (earlier install wins ties, like the scalar sort)."""
        best = None
        for entry in self.flow_table:
            if entry.match.matches(pkt, in_port):
                best = entry
                break  # table is priority-sorted
        if self.block_table:
            from sdnmpi_tpu_torch.utils.mac import mac_to_int

            try:
                src_key = mac_to_int(pkt.eth_src)
                dst_key = mac_to_int(pkt.eth_dst)
            except ValueError:
                return best
            for b in self.block_table:
                if best is not None and (-best.priority, best.seq) <= (
                    -b.priority,
                    b.seq,
                ):
                    continue
                m = b.member(src_key, dst_key)
                if m is not None:
                    best = _FlowEntry(
                        b.priority, of.Match(), b.actions_for(m), b.seq,
                        synthetic=True,
                    )
        return best

    # -- data path --------------------------------------------------------

    def receive(self, pkt: of.Packet, in_port: int, hops: int) -> None:
        port = self.port(in_port)
        port.rx_packets += 1
        port.rx_bytes += _pkt_len(pkt)

        entry = self.lookup(pkt, in_port)
        if entry is not None and not entry.synthetic and not entry.frozen:
            # scalar-table hit: refresh the idle clock + counters (block
            # entries are synthesized per lookup and don't expire; a
            # fault-frozen entry forwards without counting)
            entry.last_hit = self.fabric.now
            entry.packet_count += 1
            entry.byte_count += _pkt_len(pkt)
        if entry is None:
            # table miss -> controller (the reference runs ryu-manager with
            # --noexplicit-drop so unmatched packets reach the apps,
            # run_router.sh:2); the frame is parked in the switch buffer
            # and its id rides the packet-in, as OF 1.0 switches do
            self.fabric.packet_in(
                self.dpid, in_port, pkt, self.buffer_packet(pkt)
            )
            return
        self.apply_actions(entry.actions, pkt, in_port, hops)

    def apply_actions(
        self,
        actions: tuple[of.Action, ...],
        pkt: of.Packet,
        in_port: int,
        hops: int,
    ) -> None:
        for action in actions:
            if isinstance(action, of.ActionSetDlDst):
                pkt = pkt.with_dst(action.mac)
            elif isinstance(action, of.ActionOutput):
                self._output(action.port, pkt, in_port, hops)
            else:
                raise ValueError(f"unsupported action {action!r}")
        # empty action list == drop (used by the IPv6-multicast drop rule,
        # reference: sdnmpi/topology.py:88-92)

    def _output(self, port_no: int, pkt: of.Packet, in_port: int, hops: int) -> None:
        if port_no == of.OFPP_CONTROLLER:
            self.fabric.packet_in(self.dpid, in_port, pkt, self.buffer_packet(pkt))
            return
        if port_no == of.OFPP_LOCAL:
            self.local_delivered.append(pkt)
            return
        if port_no == of.OFPP_IN_PORT:
            port_no = in_port
        port = self.ports.get(port_no)
        if port is None or port.peer is None:
            log.debug("dpid %s: output to dead port %s dropped", self.dpid, port_no)
            return
        port.tx_packets += 1
        port.tx_bytes += _pkt_len(pkt)
        self.fabric.transmit(port.peer, pkt, hops)

    def port_stats(self) -> list[of.PortStatsEntry]:
        return [
            of.PortStatsEntry(
                p.port_no, p.rx_packets, p.rx_bytes, p.tx_packets, p.tx_bytes
            )
            for p in sorted(self.ports.values(), key=lambda p: p.port_no)
        ]

    def flow_stats(self) -> list[of.FlowStatsEntry]:
        """The scalar flow table as OFPST_FLOW records — the audit
        plane's ground truth. Counters are the data-plane
        tallies the sim already keeps; block-table entries are NOT
        reported (they are this framework's array extension with no
        table rows a real OFPST_FLOW dump would carry — the collective
        table owns their lifecycle)."""
        now = self.fabric.now
        return [
            of.FlowStatsEntry(
                match=e.match, actions=e.actions, priority=e.priority,
                duration_sec=int(now - e.installed_at),
                idle_timeout=e.idle_timeout, hard_timeout=e.hard_timeout,
                cookie=e.cookie, packet_count=e.packet_count,
                byte_count=e.byte_count,
            )
            for e in self.flow_table
        ]

    def to_entity(self) -> Switch:
        return Switch.make(
            self.dpid, [Port(self.dpid, p.port_no) for p in self.ports.values()]
        )


class SimHost:
    def __init__(self, fabric: "Fabric", mac: str, dpid: int, port_no: int) -> None:
        self.fabric = fabric
        self.mac = mac
        self.dpid = dpid
        self.port_no = port_no
        self.received: list[of.Packet] = []

    def send(self, pkt: of.Packet) -> None:
        self.fabric.inject(self.dpid, pkt, self.port_no)

    def to_entity(self) -> Host:
        return Host(self.mac, Port(self.dpid, self.port_no))


class Fabric:
    """Container for the simulated network; owns discovery announcements.

    With ``wire=True`` every OpenFlow-shaped southbound exchange
    (FlowMod, PacketOut, PortStats, packet-in) round-trips through the
    byte-level OpenFlow 1.0 codec (protocol/ofwire.py) — the
    controller's messages are serialized to the real wire format and
    re-parsed before the switch acts on them, so the sim proves the
    same bytes a physical OF 1.0 switch would receive (reference emits
    these via Ryu, sdnmpi/router.py:49-62, monitor.py:54-60,
    process.py:61-79). ``flow_block_set`` is the one exception: the
    array-native collective install is this framework's extension with
    no OF 1.0 equivalent (see protocol/ofwire.py docstring)."""

    def __init__(self, wire: bool = False, discovery: str = "direct") -> None:
        if discovery not in ("direct", "packet"):
            raise ValueError(f"unknown discovery mode {discovery!r}")
        self.switches: dict[int, SimSwitch] = {}
        self.hosts: dict[str, SimHost] = {}
        self.links: list[tuple[int, int, int, int]] = []  # (a, pa, b, pb)
        self.bus = None  # set by connect()
        self.wire = wire
        #: called whenever an ingress burst fully drains (every host
        #: injection and its packet-in cascade has returned) and after
        #: each tick — the hook the Router's route coalescer flushes
        #: from, standing in for a real controller's event-loop idle
        #: callback. None = no coalescing.
        self.on_idle = None
        self._ingress_depth = 0
        #: "direct" publishes EventLinkAdd/EventHostAdd itself;
        #: "packet" announces only what a real OF channel would (datapath
        #: up + port sets) and leaves links/hosts for the controller's
        #: LLDP discovery app to learn from actual frames (the
        #: reference's --observe-links posture). Deletions stay
        #: event-driven either way: a real switch reports port-down /
        #: connection loss on the OF channel directly.
        self.discovery = discovery
        self._xid = 0
        #: simulation clock: advanced by tick(); stamps flow install /
        #: last-hit times for idle/hard expiry
        self.now: float = 0.0
        #: fault-injection schedule (control/faults.FaultPlan) consulted
        #: on every southbound send / stats pull; None = perfect fabric
        self.faults = None
        #: terminate each install span with a simulated barrier ack
        #: (Config.install_barriers; the Controller overrides this) —
        #: the sim's stand-in for OFPT_BARRIER_REQUEST/REPLY, through
        #: the byte codec when wire=True
        self.send_barriers: bool = True
        #: dpid -> cabled (host_mac, port_no) of a crashed switch,
        #: awaiting redial_switch (its links park in _dark_links)
        self._crashed: dict[int, list[tuple[str, int]]] = {}
        #: links whose restoration awaits BOTH endpoints redialing
        self._dark_links: set[tuple[int, int, int, int]] = set()
        #: dpid -> FIFO of deferred apply-thunks (a stalled TCP stream:
        #: bytes queued but not yet processed by the switch; everything
        #: behind the stall queues too, preserving per-connection order)
        self._stall_q: dict[int, list] = {}

    def _next_xid(self) -> int:
        self._xid += 1
        return self._xid

    # -- ingress bursts ----------------------------------------------------

    def inject(self, dpid: int, pkt: of.Packet, port_no: int) -> None:
        """Deliver a data-plane frame arriving at a switch port and,
        once the whole synchronous cascade (packet-ins, controller
        replies, forwarded copies) has drained, signal ``on_idle``.
        Nested deliveries (a controller packet-out re-entering the data
        plane mid-burst) do not re-signal: one burst, one idle edge."""
        self._ingress_depth += 1
        try:
            self.switches[dpid].receive(pkt, port_no, hops=0)
        finally:
            self._ingress_depth -= 1
            if self._ingress_depth == 0:
                self._notify_idle()

    def _notify_idle(self) -> None:
        if self.on_idle is not None:
            self.on_idle()

    # -- construction -----------------------------------------------------

    def add_switch(self, dpid: int) -> SimSwitch:
        sw = SimSwitch(self, dpid)
        self.switches[dpid] = sw
        if self.bus is not None:
            self.bus.publish(EventDatapathUp(dpid))
            self.bus.publish(EventSwitchEnter(sw.to_entity()))
        return sw

    def _port_added(self, dpid: int) -> None:
        """Announce a switch whose port set grew, so the controller's
        topology view tracks live ports (Ryu's port-add events play this
        role; TopologyDB.add_switch upserts by dpid). A dedicated event —
        not a replayed EventSwitchEnter — so the RPC mirror does not emit
        a redundant ``add_switch`` per cabling change."""
        if self.bus is not None:
            self.bus.publish(EventPortAdd(self.switches[dpid].to_entity()))

    def add_link(self, a: int, port_a: int, b: int, port_b: int) -> None:
        """Bidirectional link a:port_a <-> b:port_b (LLDP discovery reports
        both directed halves, as the reference's TopologyDB stores them)."""
        self.switches[a].port(port_a).peer = ("switch", b, port_b)
        self.switches[b].port(port_b).peer = ("switch", a, port_a)
        self.links.append((a, port_a, b, port_b))
        self._port_added(a)
        self._port_added(b)
        if self.bus is not None and self.discovery == "direct":
            for link in self._link_entities(a, port_a, b, port_b):
                self.bus.publish(EventLinkAdd(link))

    def add_host(self, mac: str, dpid: int, port_no: int) -> SimHost:
        host = SimHost(self, mac, dpid, port_no)
        self.hosts[mac] = host
        self.switches[dpid].port(port_no).peer = ("host", mac)
        self._port_added(dpid)
        if self.bus is not None and self.discovery == "direct":
            self.bus.publish(EventHostAdd(host.to_entity()))
        return host

    def add_silent_host(self, mac: str, dpid: int, port_no: int) -> SimHost:
        """A host cabled to a switch port that discovery has NOT seen
        (it has never sent a packet). The port exists on the switch —
        which is exactly why broadcasts must flood all non-inter-switch
        ports (reference: sdnmpi/topology.py:157-177), not just ports
        with discovered hosts: this host must still be reachable by the
        broadcast that would bootstrap it."""
        host = SimHost(self, mac, dpid, port_no)
        self.hosts[mac] = host
        self.switches[dpid].port(port_no).peer = ("host", mac)
        self._port_added(dpid)
        return host

    @staticmethod
    def _link_entities(a: int, pa: int, b: int, pb: int) -> tuple[Link, Link]:
        return (
            Link(Port(a, pa), Port(b, pb)),
            Link(Port(b, pb), Port(a, pa)),
        )

    # -- failure injection ------------------------------------------------

    def remove_link(self, a: int, port_a: int, b: int, port_b: int) -> None:
        self.links.remove((a, port_a, b, port_b))
        self.switches[a].port(port_a).peer = None
        self.switches[b].port(port_b).peer = None
        if self.bus is not None:
            for link in self._link_entities(a, port_a, b, port_b):
                self.bus.publish(EventLinkDelete(link))
            # one coalesced signal after both directed halves, so flow
            # revalidation runs once per topological change
            self.bus.publish(EventTopologyChanged())

    def crash_switch(self, dpid: int) -> None:
        """Kill a switch ungracefully: its OF session and links die and
        its flow state is LOST — :meth:`redial_switch` brings it back
        with an EMPTY table, exactly the scenario the recovery plane's
        desired-state reconciliation exists for. Unflushed stalled
        bytes die with the session; links are parked dark until both
        endpoints are back."""
        self._stall_q.pop(dpid, None)
        self._crashed[dpid] = [
            (mac, h.port_no) for mac, h in self.hosts.items()
            if h.dpid == dpid
        ]
        self._dark_links.update(
            l for l in self.links if dpid in (l[0], l[2])
        )
        self.remove_switch(dpid)

    def redial_switch(self, dpid: int) -> None:
        """A crashed switch reboots and redials: datapath-up + switch-
        enter fire for a switch with an EMPTY flow table (the Router
        still believed its flows were installed),
        its hosts re-peer, and every dark link with both endpoints live
        is restored."""
        hosts = self._crashed.pop(dpid)
        sw = self.add_switch(dpid)
        for mac, port_no in hosts:
            sw.port(port_no).peer = ("host", mac)
            self._port_added(dpid)
            if self.bus is not None and self.discovery == "direct":
                self.bus.publish(EventHostAdd(self.hosts[mac].to_entity()))
        for link in sorted(self._dark_links):
            a, pa, b, pb = link
            if a in self.switches and b in self.switches:
                self._dark_links.discard(link)
                self.add_link(a, pa, b, pb)
        if self.bus is not None:
            # one coalesced signal after the whole redial (links + hosts)
            # so flow revalidation runs once over the healed graph
            self.bus.publish(EventTopologyChanged())

    def release_stalls(self, dpid: int | None = None) -> None:
        """Flush stalled send streams: the queued bytes reach their
        switch now, in FIFO order (barrier acks included). ``None``
        releases every stalled stream (quiesce)."""
        dpids = [dpid] if dpid is not None else sorted(self._stall_q)
        for d in dpids:
            for thunk in self._stall_q.pop(d, []):
                thunk()

    def _stalled(self, dpid: int, fault: str | None) -> bool:
        """True when ``dpid``'s stream is (or just became) stalled —
        subsequent sends must queue behind it to preserve the
        per-connection FIFO a real TCP stream guarantees."""
        if dpid in self._stall_q:
            return True  # already stalled: everything queues behind
        if fault == "stall":
            self._stall_q[dpid] = []
            return True
        return False

    def remove_switch(self, dpid: int) -> None:
        sw = self.switches.pop(dpid)
        # datapath-down first so flow cleanup never targets the dead switch
        if self.bus is not None:
            self.bus.publish(EventDatapathDown(dpid))
        for a, pa, b, pb in [l for l in self.links if dpid in (l[0], l[2])]:
            self.links.remove((a, pa, b, pb))
            other, other_port = (b, pb) if a == dpid else (a, pa)
            if other in self.switches:
                self.switches[other].port(other_port).peer = None
            if self.bus is not None:
                for link in self._link_entities(a, pa, b, pb):
                    self.bus.publish(EventLinkDelete(link))
        if self.bus is not None:
            self.bus.publish(EventSwitchLeave(sw.to_entity()))
            self.bus.publish(EventTopologyChanged())

    # -- time / flow expiry ------------------------------------------------

    def tick(self, now: float) -> None:
        """Advance the simulation clock and expire timed-out flows.

        Real OF 1.0 switches age flows themselves and, because every
        install sets OFPFF_SEND_FLOW_REM (as the reference does,
        sdnmpi/router.py:61), report each expiry with ofp_flow_removed.
        The reference never handles that reply (SURVEY §2 defect); here
        the expiry is published as EventFlowRemoved — through the byte
        codec when wire=True — and the Router keeps the FDB coherent.
        """
        self.now = now
        for dpid, sw in sorted(self.switches.items()):
            expired: list[tuple[_FlowEntry, int]] = []
            for e in sw.flow_table:
                if e.hard_timeout > 0 and now - e.installed_at >= e.hard_timeout:
                    expired.append((e, 1))  # OFPRR_HARD_TIMEOUT
                elif e.idle_timeout > 0 and now - e.last_hit >= e.idle_timeout:
                    expired.append((e, 0))  # OFPRR_IDLE_TIMEOUT
            if not expired:
                continue
            doomed = {id(e) for e, _ in expired}
            sw.drop_entries(doomed)
            for e, reason in expired:
                self._flow_removed(dpid, e, reason)
        # time passed: any coalesced route lookups past their window
        # must not wait for the next data-plane burst
        self._notify_idle()

    def _flow_removed(self, dpid: int, e: _FlowEntry, reason: int) -> None:
        if self.bus is None:
            return
        match, priority = e.match, e.priority
        duration = self.now - e.installed_at
        packets, bytes_ = e.packet_count, e.byte_count
        if self.wire:
            from sdnmpi_tpu_torch.protocol import ofwire

            rec = ofwire.decode_flow_removed(
                ofwire.encode_flow_removed(
                    match, priority, reason,
                    duration_sec=int(duration), idle_timeout=e.idle_timeout,
                    packet_count=packets, byte_count=bytes_,
                    xid=self._next_xid(),
                )
            )
            match, priority = rec["match"], rec["priority"]
            reason, duration = rec["reason"], rec["duration_sec"]
            packets, bytes_ = rec["packet_count"], rec["byte_count"]
        self.bus.publish(
            EventFlowRemoved(
                dpid, match, priority, reason,
                duration_sec=duration, packet_count=packets, byte_count=bytes_,
            )
        )

    # -- controller attachment --------------------------------------------

    def connect(self, bus) -> None:
        """Attach the control plane and replay discovery for the current
        network, the way Ryu's LLDP discovery populates a fresh controller
        (--observe-links, reference: run_router.sh:2)."""
        self.bus = bus
        for dpid, sw in sorted(self.switches.items()):
            bus.publish(EventDatapathUp(dpid))
            bus.publish(EventSwitchEnter(sw.to_entity()))
        if self.discovery != "direct":
            # links/hosts must be learned from frames (LLDP probes fired
            # by the discovery app's EventSwitchEnter handler + traffic)
            return
        for a, pa, b, pb in self.links:
            for link in self._link_entities(a, pa, b, pb):
                bus.publish(EventLinkAdd(link))
        for host in self.hosts.values():
            bus.publish(EventHostAdd(host.to_entity()))

    # -- southbound API used by the apps ----------------------------------

    def flow_mod(self, dpid: int, mod: of.FlowMod) -> bool:
        """Returns the queued/dropped verdict, mirroring
        OFSouthbound._send: False when the datapath is unknown or the
        fault plan dropped the bytes."""
        sw = self.switches.get(dpid)
        if sw is None:  # datapath died between event and flow_mod
            log.debug("flow_mod to unknown dpid %s dropped", dpid)
            return False
        fault = self.faults.send_fault(dpid) if self.faults else None
        if fault == "drop" or fault == "truncate":
            # a truncated scalar mod is simply lost (nothing partial to
            # apply at one-message granularity)
            return False
        if self.wire:
            from sdnmpi_tpu_torch.protocol import ofwire

            mod = ofwire.decode_flow_mod(
                ofwire.encode_flow_mod(mod, xid=self._next_xid())
            )
        if self._stalled(dpid, fault):
            self._stall_q[dpid].append(lambda: sw.flow_mod(mod))
            return True  # queued (a stalled stream is not a drop)
        sw.flow_mod(mod)
        return True

    def flow_mods_batch(self, dpid: int, batch: of.FlowModBatch):
        """Per-switch FlowMod burst (see flow_mods_window)."""
        import numpy as np

        return self.flow_mods_window(
            np.full(len(batch), dpid, np.int64), batch
        )

    def _ack_barrier(self, dpid: int):
        """Simulate the barrier request/reply terminating one switch's
        span: returns ``(xid, publish_thunk | None)``. The thunk fires
        the EventBarrierAck (immediately for a live stream, deferred
        for a stalled one); None means the fault plan lost the reply —
        the request was still sent, so the caller records the pending
        barrier that will time out into an anti-entropy resync."""
        xid = self._next_xid()
        if self.wire:
            from sdnmpi_tpu_torch.protocol import ofwire

            # round-trip request and reply through the byte codec, as
            # every other wire-mode exchange does
            xid = ofwire.decode_barrier_reply(
                ofwire.encode_barrier_reply(
                    ofwire.peek_header(
                        ofwire.encode_barrier_request(xid)
                    )[2]
                )
            )
        if self.faults is not None and self.faults.ack_fault(dpid):
            return xid, None  # install applied; the receipt was lost
        bus = self.bus
        return xid, (lambda: bus.publish(EventBarrierAck(dpid, xid))
                     if bus is not None else None)

    def flow_mods_window(self, dpids, batch: of.FlowModBatch) -> InstallVerdict:
        """A whole window's FlowMods across switches (``dpids`` is the
        [N] per-row switch id — the pipelined install plane's unit of
        transfer). With ``wire=True`` the window round-trips through
        ONE batched encode and the scalar per-message decoder over each
        row's byte span — proving the exact bytes a real switch would
        receive from OFSouthbound.flow_mods_window; otherwise the
        scalar twins apply directly. Unknown dpids are dropped like
        flow_mod's dead-datapath case.

        Returns the same :class:`InstallVerdict` contract as
        ``OFSouthbound.flow_mods_window`` — per-switch queued/dropped
        spans plus simulated barrier acks — with the fault plan
        injecting dropped/stalled/truncated spans and lost acks."""
        import numpy as np

        from sdnmpi_tpu_torch.utils.arrays import group_spans

        dpids = np.asarray(dpids)
        verdict = InstallVerdict()
        if len(batch) == 0:
            return verdict
        blob = offsets = None
        if self.wire:
            from sdnmpi_tpu_torch.protocol import ofwire

            blob, offsets = ofwire.encode_flow_mods_spans(
                batch, xid_base=self._xid + 1
            )
            self._xid += len(batch)
            # same instrument the real southbound records, so wire-mode
            # sims exercise the telemetry plane end to end
            _m_encode_bytes.inc(len(blob))
        mods = None if self.wire else list(batch.to_flow_mods())
        for lo, hi in group_spans(dpids):
            dpid = int(dpids[lo])
            sw = self.switches.get(dpid)
            if sw is None:
                log.debug("flow_mods_window span for unknown dpid dropped")
                verdict.dropped.append(dpid)
                continue
            fault = self.faults.send_fault(dpid) if self.faults else None
            if fault == "drop":
                verdict.dropped.append(dpid)
                continue
            end = hi
            if fault == "truncate":
                # the span's last TCP segment died mid-frame: the first
                # half of the messages applied, the tail is lost — the
                # partial-install case only the barrier/retry machinery
                # can detect and repair
                end = lo + max(0, (hi - lo) // 2)
            if self.wire:
                from sdnmpi_tpu_torch.protocol import ofwire

                span_mods = [
                    ofwire.decode_flow_mod(
                        blob[int(offsets[i]) : int(offsets[i + 1])]
                    )
                    for i in range(lo, end)
                ]
            else:
                span_mods = mods[lo:end]
            if self._stalled(dpid, fault):
                q = self._stall_q[dpid]
                q.extend(
                    (lambda s=sw, m=m: s.flow_mod(m)) for m in span_mods
                )
                if fault == "truncate":
                    verdict.dropped.append(dpid)
                    continue
                if self.send_barriers:
                    xid, thunk = self._ack_barrier(dpid)
                    verdict.barriers.append((dpid, xid))
                    if thunk is not None:
                        q.append(thunk)  # the ack drains behind the span
                verdict.sent.append(dpid)
                continue
            for m in span_mods:
                sw.flow_mod(m)
            if fault == "truncate":
                verdict.dropped.append(dpid)
                continue
            if self.send_barriers:
                xid, thunk = self._ack_barrier(dpid)
                verdict.barriers.append((dpid, xid))
                if thunk is not None:
                    thunk()
            verdict.sent.append(dpid)
        return verdict

    def flow_block_set(self, block: of.FlowBlockSet) -> None:
        """Install a whole collective's flows: partition the (sub-flow,
        hop) rows by switch with array ops, then hand each switch ONE
        entry referencing its row slice — O(#switches) Python for
        S x L x M worth of flow entries. Unknown dpids are skipped like
        flow_mod's dead-datapath case."""
        import numpy as np

        hop_len = np.asarray(block.hop_len)
        s_count, l_max = np.asarray(block.hop_dpid).shape
        valid = np.arange(l_max)[None, :] < hop_len[:, None]
        sub_rows, hop_rows = np.nonzero(valid)
        dpids = np.asarray(block.hop_dpid)[sub_rows, hop_rows]
        if len(dpids) == 0:
            return
        order = np.argsort(dpids, kind="stable")
        dpids = dpids[order]
        sub_rows = sub_rows[order]
        hop_rows = hop_rows[order]
        cuts = np.flatnonzero(np.diff(dpids)) + 1
        starts = np.concatenate([[0], cuts])
        ends = np.concatenate([cuts, [len(dpids)]])
        for lo, hi in zip(starts, ends):
            sw = self.switches.get(int(dpids[lo]))
            if sw is None:
                log.debug("block rows for unknown dpid skipped")
                continue
            sw._seq += 1
            sw.add_block_entry(
                _BlockSetEntry(
                    block.priority, sw._seq, block,
                    sub_rows[lo:hi], hop_rows[lo:hi],
                )
            )

    def flow_blocks_delete(self, cookie: int) -> None:
        """Tear down every block entry of a collective install."""
        for sw in self.switches.values():
            sw.remove_blocks(cookie)

    def packet_out(self, dpid: int, out: of.PacketOut) -> None:
        sw = self.switches.get(dpid)
        if sw is None:  # datapath died between packet-in and reply
            log.debug("packet_out to unknown dpid %s dropped", dpid)
            return
        if self.wire:
            from sdnmpi_tpu_torch.protocol import ofwire

            out = ofwire.decode_packet_out(
                ofwire.encode_packet_out(out, xid=self._next_xid())
            )
        pkt = out.data
        if out.buffer_id != of.OFP_NO_BUFFER:
            # use the switch-side buffered frame (reference:
            # sdnmpi/router.py:111-118); data, if any, is ignored
            pkt = sw.buffers.pop(out.buffer_id, None)
            if pkt is None:
                log.debug(
                    "packet_out for unknown buffer %s on dpid %s dropped",
                    out.buffer_id, dpid,
                )
                return
        sw.apply_actions(out.actions, pkt, out.in_port, hops=0)

    def port_stats(self, dpid: int) -> list[of.PortStatsEntry]:
        if self.faults is not None and self.faults.stats_fault(dpid):
            # delayed StatsReply: this pull returns nothing, exactly
            # like OFSouthbound.port_stats before the reply lands
            return []
        entries = self.switches[dpid].port_stats()
        if self.wire:
            from sdnmpi_tpu_torch.protocol import ofwire

            entries = ofwire.decode_port_stats_reply(
                ofwire.encode_port_stats_reply(entries, xid=self._next_xid())
            )
        return entries

    def flow_stats(self, dpid: int):
        """Pull one switch's flow table (OFPST_FLOW). Returns
        None — NOT an empty list — when no reply is available (unknown
        datapath, or the fault plan delayed the StatsReply): the audit
        plane must never read "no answer" as "empty table", or a
        delayed reply would condemn every desired row as missing. With
        ``wire=True`` the reply round-trips the MULTIPART byte codec
        (encode splits on record boundaries, decode reassembles), so
        the sim proves the same part stream a real switch would send."""
        sw = self.switches.get(dpid)
        if sw is None:
            return None
        if self.faults is not None and self.faults.stats_fault(dpid):
            return None  # delayed StatsReply: nothing to serve this pull
        entries = sw.flow_stats()
        if self.wire:
            from sdnmpi_tpu_torch.protocol import ofwire

            entries = ofwire.decode_flow_stats_reply(
                ofwire.encode_flow_stats_reply(
                    entries, xid=self._next_xid()
                )
            )
        return entries

    def connected_dpids(self) -> list[int]:
        return sorted(self.switches)

    # -- internal transit -------------------------------------------------

    def packet_in(
        self,
        dpid: int,
        in_port: int,
        pkt: of.Packet,
        buffer_id: int = of.OFP_NO_BUFFER,
    ) -> None:
        if self.bus is not None:
            if self.wire:
                from sdnmpi_tpu_torch.protocol import ofwire

                pkt, in_port, buffer_id, _reason = ofwire.decode_packet_in(
                    ofwire.encode_packet_in(
                        pkt, in_port, buffer_id, xid=self._next_xid()
                    )
                )
            self.bus.publish(EventPacketIn(dpid, in_port, pkt, buffer_id))

    def transmit(self, peer: tuple, pkt: of.Packet, hops: int) -> None:
        if hops >= _MAX_HOPS:
            log.warning("dropping packet after %d hops (loop?)", hops)
            return
        if peer[0] == "host":
            host = self.hosts.get(peer[1])
            if host is not None:
                host.received.append(pkt)
        else:
            _, dpid, port_no = peer
            sw = self.switches.get(dpid)
            if sw is not None:
                sw.receive(pkt, port_no, hops + 1)


def _pkt_len(pkt: of.Packet) -> int:
    return 14 + len(pkt.payload)  # ethernet header + payload

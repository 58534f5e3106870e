"""Minimal OpenFlow-1.0-shaped control messages for the simulated fabric.

The reference drives real switches over Ryu's OpenFlow 1.0 bindings
(reference: sdnmpi/router.py:49-62, sdnmpi/topology.py:69-108,
sdnmpi/process.py:61-79). This framework's southbound is a simulated switch
fabric (control/fabric.py), so only the message *shapes* the apps exchange
are needed: matches, actions, FlowMod, PacketOut, PortStats. The field names
mirror OpenFlow 1.0 so the control-plane code reads like the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Reserved port numbers (OpenFlow 1.0 ofp_port)
OFPP_MAX = 0xFF00
OFPP_IN_PORT = 0xFFF8
OFPP_TABLE = 0xFFF9
OFPP_NORMAL = 0xFFFA
OFPP_FLOOD = 0xFFFB
OFPP_ALL = 0xFFFC
OFPP_CONTROLLER = 0xFFFD
OFPP_LOCAL = 0xFFFE
OFPP_NONE = 0xFFFF

OFP_NO_BUFFER = 0xFFFFFFFF

# Flow mod commands
OFPFC_ADD = 0
OFPFC_DELETE = 3

ETH_TYPE_IP = 0x0800
ETH_TYPE_LLDP = 0x88CC
IPPROTO_UDP = 17


@dataclasses.dataclass(frozen=True)
class Match:
    """Subset of ofp_match used by the apps; ``None`` fields are wildcards."""

    in_port: Optional[int] = None
    dl_src: Optional[str] = None
    dl_dst: Optional[str] = None
    dl_type: Optional[int] = None
    nw_proto: Optional[int] = None
    tp_dst: Optional[int] = None

    def matches(self, pkt: "Packet", in_port: int) -> bool:
        if self.in_port is not None and in_port != self.in_port:
            return False
        if self.dl_src is not None and pkt.eth_src != self.dl_src:
            return False
        if self.dl_dst is not None and pkt.eth_dst != self.dl_dst:
            return False
        if self.dl_type is not None and pkt.eth_type != self.dl_type:
            return False
        if self.nw_proto is not None and pkt.ip_proto != self.nw_proto:
            return False
        if self.tp_dst is not None and pkt.udp_dst != self.tp_dst:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class ActionOutput:
    port: int


@dataclasses.dataclass(frozen=True)
class ActionSetDlDst:
    """Rewrite destination MAC — used on the last hop of an MPI route to
    translate the virtual MAC back to the real host MAC
    (reference: sdnmpi/router.py:98-102)."""

    mac: str


Action = ActionOutput | ActionSetDlDst


@dataclasses.dataclass(frozen=True)
class FlowMod:
    match: Match
    actions: tuple[Action, ...]
    priority: int
    command: int = OFPFC_ADD
    idle_timeout: int = 0
    hard_timeout: int = 0
    cookie: int = 0


@dataclasses.dataclass(frozen=True)
class FlowModBatch:
    """A burst of exact-L2-match FlowMods for ONE switch, in
    struct-of-arrays form — the install plane's unit of transfer.

    Semantically this is N scalar :class:`FlowMod` messages
    (``match=(dl_src, dl_dst)``, one output action, optional dl_dst
    rewrite first — the Router's only install shapes), but member state
    lives in numpy arrays so a whole coalesced window materializes with
    array ops and serializes through the batched wire encoder
    (protocol/ofwire.encode_flow_mods_batch) instead of N dataclass
    constructions and N ``struct.pack`` calls. MACs travel as int48
    keys (``utils.mac.mac_to_int`` form), never strings.

    ``rewrite[i] >= 0`` appends a virtual -> real dl_dst rewrite before
    the output on row i (last-hop MPI semantics, reference:
    sdnmpi/router.py:98-102). With ``command=OFPFC_DELETE`` rows carry
    no actions (out_port/rewrite are ignored). Priority, timeouts,
    command, and cookie are shared by the burst — one switch, one
    install pass, one policy.
    """

    src: "object"  # [N] int64 source MAC keys
    dst: "object"  # [N] int64 destination (possibly virtual) MAC keys
    out_port: "object"  # [N] int32 output ports
    rewrite: Optional["object"] = None  # [N] int64 true-dst keys, -1 = none
    priority: int = 0x8000
    idle_timeout: int = 0
    hard_timeout: int = 0
    command: int = OFPFC_ADD
    cookie: int = 0

    def __len__(self) -> int:
        return len(self.src)

    def to_flow_mods(self):
        """Yield the scalar FlowMod twin of each row — the semantic
        reference the batched encoder is differentially tested against,
        and the fallback for southbounds without a batch entry point."""
        import numpy as np

        from sdnmpi_tpu_torch.utils.mac import int_to_mac

        src = np.asarray(self.src)
        dst = np.asarray(self.dst)
        ports = np.asarray(self.out_port)
        rew = None if self.rewrite is None else np.asarray(self.rewrite)
        for i in range(len(src)):
            actions: tuple[Action, ...] = ()
            if self.command != OFPFC_DELETE:
                out = ActionOutput(int(ports[i]))
                if rew is not None and int(rew[i]) >= 0:
                    actions = (ActionSetDlDst(int_to_mac(int(rew[i]))), out)
                else:
                    actions = (out,)
            yield FlowMod(
                match=Match(
                    dl_src=int_to_mac(int(src[i])),
                    dl_dst=int_to_mac(int(dst[i])),
                ),
                actions=actions,
                priority=self.priority,
                command=self.command,
                idle_timeout=self.idle_timeout,
                hard_timeout=self.hard_timeout,
                cookie=self.cookie,
            )


@dataclasses.dataclass(frozen=True)
class FlowBlockSet:
    """Batch flow install for an entire collective — S ECMP sub-flow
    paths and their M member flows in ONE message of shared arrays.

    Semantically this is the reference's per-hop FlowMod loop
    (reference: sdnmpi/router.py:83-104) run for every member of every
    sub-flow: member m of sub-flow s gets, at each path switch
    ``hop_dpid[s, h]``, an exact-match flow ``(dl_src=src[m],
    dl_dst=dst[m]) -> output(hop_port[s, h])``; at the final hop
    (``h == hop_len[s] - 1``) the member instead outputs to its own
    ``final_port[m]`` (the destination host's attachment port), first
    rewriting dl_dst to ``rewrite[m]`` (virtual -> real MAC, reference:
    sdnmpi/router.py:98-102). MACs travel as int48 keys
    (``utils.mac.mac_to_int`` form), never strings.

    Sub-flow s's members are rows ``bounds[s]:bounds[s+1]`` of the
    member arrays (the native counting-sort layout), so the message is
    O(S x L + M) memory for S*L x M worth of switch flow entries.
    ``cookie`` identifies the install for bulk teardown.

    Known shape limit, shared with any per-switch exact-match scheme
    (including the reference's): a path that visits the same switch
    twice cannot install two different next hops for one (src, dst)
    match — implementations keep the later hop, shortcutting the
    revisit loop.
    """

    hop_dpid: "object"  # [S, L] int64 (-1 padded)
    hop_port: "object"  # [S, L] int32 transit out-ports
    hop_len: "object"  # [S] int32
    bounds: "object"  # [S + 1] int64 member-slice offsets
    src: "object"  # [M] int64 member source MAC keys
    dst: "object"  # [M] int64 member destination (virtual) MAC keys
    final_port: "object"  # [M] int32 per-member final out-port
    rewrite: Optional["object"] = None  # [M] int64 true-dst MAC keys
    priority: int = 0x8000
    cookie: int = 0


@dataclasses.dataclass(frozen=True)
class PacketOut:
    data: "Packet"
    actions: tuple[Action, ...]
    in_port: int = OFPP_NONE
    buffer_id: int = OFP_NO_BUFFER


@dataclasses.dataclass(frozen=True)
class Packet:
    """A parsed-enough Ethernet frame for the control plane.

    The reference parses real frames with ryu.lib.packet
    (reference: sdnmpi/router.py:130-133, process.py:84-89); the simulated
    fabric passes structured frames instead, carrying only the header fields
    the apps inspect plus an opaque payload.
    """

    eth_src: str
    eth_dst: str
    eth_type: int = ETH_TYPE_IP
    ip_proto: Optional[int] = None
    udp_dst: Optional[int] = None
    payload: bytes = b""

    def with_dst(self, mac: str) -> "Packet":
        return dataclasses.replace(self, eth_dst=mac)


@dataclasses.dataclass(frozen=True)
class PortStatsEntry:
    """One port's cumulative counters (ofp_port_stats subset the Monitor
    reads, reference: sdnmpi/monitor.py:67-94)."""

    port_no: int
    rx_packets: int
    rx_bytes: int
    tx_packets: int
    tx_bytes: int


@dataclasses.dataclass(frozen=True)
class FlowStatsEntry:
    """One installed flow's identity + cumulative counters — the
    ofp_flow_stats record of an OFPST_FLOW reply. This is the fabric's
    GROUND TRUTH row: what the switch actually holds, not what the
    controller believes it installed. The audit plane (control/audit.py)
    diffs lists of these against the DesiredFlowStore; the reference
    never requested flow stats at all (its Monitor polls ports only,
    sdnmpi/monitor.py:54-60), so installed-vs-desired agreement was
    unverifiable there."""

    match: Match
    actions: tuple[Action, ...]
    priority: int
    duration_sec: int = 0
    idle_timeout: int = 0
    hard_timeout: int = 0
    cookie: int = 0
    packet_count: int = 0
    byte_count: int = 0

"""OpenFlow 1.0 byte-level wire codec.

The reference emits real OF 1.0 bytes to real switches through Ryu's
serializers (`OFPFlowMod`/`OFPPacketOut` at reference:
sdnmpi/router.py:49-62,106-123, `OFPPortStatsRequest` at
sdnmpi/monitor.py:54-60, the UDP:61000 flow install at
sdnmpi/process.py:61-79). This module is that capability without Ryu: a
dependency-free serialize/parse for exactly the message subset the apps
use —

    OFPT_HELLO / OFPT_ECHO_REQUEST / OFPT_ECHO_REPLY   (channel liveness)
    OFPT_PACKET_IN                                      (switch -> ctrl)
    OFPT_PACKET_OUT                                     (ctrl -> switch)
    OFPT_FLOW_MOD                                       (ctrl -> switch)
    OFPT_FLOW_REMOVED                                   (switch -> ctrl)
    OFPT_STATS_REQUEST / OFPT_STATS_REPLY (OFPST_PORT)  (monitor loop)
    OFPT_STATS_REQUEST / OFPT_STATS_REPLY (OFPST_FLOW)  (fabric audit)

plus the Ethernet/IPv4/UDP framing for packet data (the reference parses
real frames with ryu.lib.packet, reference: sdnmpi/router.py:130-133,
process.py:84-89). Encoders take the dataclass message shapes of
protocol/openflow.py; decoders return the same shapes, so the simulated
fabric can round-trip every southbound exchange through real wire bytes
(``Fabric(wire=True)``, control/fabric.py) and a real OF 1.0 switch
could be driven by the identical encoder output.

Wire layouts follow the OpenFlow 1.0.0 specification structs
(ofp_header, ofp_match, ofp_flow_mod, ofp_action_output,
ofp_action_dl_addr, ofp_packet_out, ofp_packet_in, ofp_stats_request/
reply, ofp_port_stats, ofp_flow_removed); all integers big-endian.

Deliberately NOT covered: ``FlowBlockSet`` (protocol/openflow.py), the
array-native whole-collective install. It is this framework's extension
beyond OpenFlow 1.0 — semantically equivalent to S x L x M per-member
FlowMods (each individually encodable here) but transported as shared
arrays precisely so a collective is O(S x L + M), not O(S x L x M),
messages. ``Fabric(wire=True)`` therefore byte-validates the reactive
per-packet path only; the block path is exercised semantically by
tests/test_collective_blocks.py.
"""

from __future__ import annotations

import struct

from sdnmpi_tpu_torch.protocol import openflow as of

OFP_VERSION = 0x01

# message types (ofp_type)
OFPT_HELLO = 0
OFPT_ERROR = 1
OFPT_ECHO_REQUEST = 2
OFPT_ECHO_REPLY = 3
OFPT_FEATURES_REQUEST = 5
OFPT_FEATURES_REPLY = 6
OFPT_PACKET_IN = 10
OFPT_FLOW_REMOVED = 11
OFPT_PACKET_OUT = 13
OFPT_FLOW_MOD = 14
OFPT_STATS_REQUEST = 16
OFPT_STATS_REPLY = 17
OFPT_BARRIER_REQUEST = 18
OFPT_BARRIER_REPLY = 19

# ofp_flow_mod_flags
OFPFF_SEND_FLOW_REM = 1 << 0

# ofp_packet_in reason
OFPR_NO_MATCH = 0
OFPR_ACTION = 1

# ofp_flow_removed reason
OFPRR_IDLE_TIMEOUT = 0
OFPRR_HARD_TIMEOUT = 1
OFPRR_DELETE = 2

# ofp_stats_types
OFPST_FLOW = 1
OFPST_PORT = 4

# ofp_stats_reply flags: more replies of this multipart follow
OFPSF_REPLY_MORE = 1 << 0

# ofp_flow_wildcards
OFPFW_IN_PORT = 1 << 0
OFPFW_DL_VLAN = 1 << 1
OFPFW_DL_SRC = 1 << 2
OFPFW_DL_DST = 1 << 3
OFPFW_DL_TYPE = 1 << 4
OFPFW_NW_PROTO = 1 << 5
OFPFW_TP_SRC = 1 << 6
OFPFW_TP_DST = 1 << 7
OFPFW_NW_SRC_ALL = 32 << 8
OFPFW_NW_DST_ALL = 32 << 14
OFPFW_DL_VLAN_PCP = 1 << 20
OFPFW_NW_TOS = 1 << 21
OFPFW_ALL = (1 << 22) - 1

# action types
OFPAT_OUTPUT = 0
OFPAT_SET_DL_SRC = 4
OFPAT_SET_DL_DST = 5

_HEADER = struct.Struct("!BBHI")  # version, type, length, xid
_MATCH = struct.Struct("!IH6s6sHBxHBB2xIIHH")  # ofp_match, 40 bytes
_MATCH_LEN = 40
assert _MATCH.size == _MATCH_LEN


def _mac_bytes(mac: str) -> bytes:
    return bytes.fromhex(mac.replace(":", ""))


def _mac_str(b: bytes) -> str:
    return ":".join(f"{x:02x}" for x in b)


# -- header ----------------------------------------------------------------


def _pack(msg_type: int, body: bytes, xid: int) -> bytes:
    return _HEADER.pack(OFP_VERSION, msg_type, _HEADER.size + len(body), xid) + body


def peek_header(buf: bytes) -> tuple[int, int, int]:
    """(msg_type, total_length, xid) of the message at ``buf[0:]`` —
    enough to frame a TCP byte stream into messages."""
    version, msg_type, length, xid = _HEADER.unpack_from(buf)
    if version != OFP_VERSION:
        raise ValueError(f"unsupported OpenFlow version 0x{version:02x}")
    return msg_type, length, xid


# -- ethernet / IPv4 / UDP framing ----------------------------------------


def _ip_checksum(header: bytes) -> int:
    s = sum(struct.unpack(f"!{len(header) // 2}H", header))
    s = (s & 0xFFFF) + (s >> 16)
    s = (s & 0xFFFF) + (s >> 16)
    return ~s & 0xFFFF


def encode_frame(pkt: of.Packet) -> bytes:
    """Serialize a structured Packet to real Ethernet bytes.

    Non-IP ethertypes carry ``payload`` raw after the 14-byte header.
    UDP frames (the announcement sideband) get a minimal IPv4 + UDP
    header so the dport the apps match on (reference:
    sdnmpi/process.py:70,103) is real wire data.
    """
    eth = _mac_bytes(pkt.eth_dst) + _mac_bytes(pkt.eth_src) + struct.pack(
        "!H", pkt.eth_type
    )
    if pkt.eth_type != of.ETH_TYPE_IP:
        return eth + pkt.payload
    # canonicalize the sim's shorthand shapes onto the wire:
    # - udp_dst set implies UDP even when ip_proto was left None
    #   (the apps key on udp_dst alone, e.g. the announcement dispatch,
    #   reference: sdnmpi/process.py:103) — the decoded packet comes
    #   back with ip_proto=17 materialized;
    # - ip_proto None with no udp_dst maps to wire protocol 0 and back
    #   to None, an identity round-trip for plain L2-matched IP packets.
    proto = pkt.ip_proto
    if proto is None:
        proto = of.IPPROTO_UDP if pkt.udp_dst is not None else 0
    if proto == of.IPPROTO_UDP:
        # dport 0 is invalid in real UDP; it encodes udp_dst=None
        l4 = struct.pack(
            "!HHHH", 0, pkt.udp_dst or 0, 8 + len(pkt.payload), 0
        )
        l4 += pkt.payload
    else:
        l4 = pkt.payload
    total = 20 + len(l4)
    ip = struct.pack(
        "!BBHHHBBH4s4s", 0x45, 0, total, 0, 0, 64, proto, 0,
        b"\x00" * 4, b"\x00" * 4,
    )
    ip = ip[:10] + struct.pack("!H", _ip_checksum(ip)) + ip[12:]
    return eth + ip + l4


def decode_frame(data: bytes) -> of.Packet:
    """Parse Ethernet bytes back to the structured Packet the apps use."""
    if len(data) < 14:
        raise ValueError("short ethernet frame")
    eth_dst = _mac_str(data[0:6])
    eth_src = _mac_str(data[6:12])
    (eth_type,) = struct.unpack_from("!H", data, 12)
    rest = data[14:]
    if eth_type != of.ETH_TYPE_IP:
        return of.Packet(eth_src, eth_dst, eth_type, payload=rest)
    ihl = (rest[0] & 0x0F) * 4
    proto = rest[9]
    l4 = rest[ihl:]
    if proto == of.IPPROTO_UDP and len(l4) >= 8:
        _, dport, _, _ = struct.unpack_from("!HHHH", l4)
        return of.Packet(
            eth_src, eth_dst, eth_type, ip_proto=proto,
            udp_dst=dport or None,  # dport 0 encodes udp_dst=None
            payload=l4[8:],
        )
    return of.Packet(
        eth_src, eth_dst, eth_type,
        ip_proto=None if proto == 0 else proto,  # see encode_frame
        payload=l4,
    )


# -- ofp_match -------------------------------------------------------------


def encode_match(m: of.Match) -> bytes:
    wildcards = (
        OFPFW_DL_VLAN | OFPFW_TP_SRC | OFPFW_DL_VLAN_PCP | OFPFW_NW_TOS
        | OFPFW_NW_SRC_ALL | OFPFW_NW_DST_ALL
    )
    if m.in_port is None:
        wildcards |= OFPFW_IN_PORT
    if m.dl_src is None:
        wildcards |= OFPFW_DL_SRC
    if m.dl_dst is None:
        wildcards |= OFPFW_DL_DST
    if m.dl_type is None:
        wildcards |= OFPFW_DL_TYPE
    if m.nw_proto is None:
        wildcards |= OFPFW_NW_PROTO
    if m.tp_dst is None:
        wildcards |= OFPFW_TP_DST
    return _MATCH.pack(
        wildcards,
        m.in_port or 0,
        _mac_bytes(m.dl_src) if m.dl_src else b"\x00" * 6,
        _mac_bytes(m.dl_dst) if m.dl_dst else b"\x00" * 6,
        0,  # dl_vlan
        0,  # dl_vlan_pcp
        m.dl_type or 0,
        0,  # nw_tos
        m.nw_proto or 0,
        0,  # nw_src
        0,  # nw_dst
        0,  # tp_src
        m.tp_dst or 0,
    )


def decode_match(buf: bytes) -> of.Match:
    (w, in_port, dl_src, dl_dst, _vlan, _pcp, dl_type, _tos, nw_proto,
     _nw_src, _nw_dst, _tp_src, tp_dst) = _MATCH.unpack_from(buf)
    return of.Match(
        in_port=None if w & OFPFW_IN_PORT else in_port,
        dl_src=None if w & OFPFW_DL_SRC else _mac_str(dl_src),
        dl_dst=None if w & OFPFW_DL_DST else _mac_str(dl_dst),
        dl_type=None if w & OFPFW_DL_TYPE else dl_type,
        nw_proto=None if w & OFPFW_NW_PROTO else nw_proto,
        tp_dst=None if w & OFPFW_TP_DST else tp_dst,
    )


# -- actions ---------------------------------------------------------------


def encode_actions(actions: tuple[of.Action, ...]) -> bytes:
    out = b""
    for a in actions:
        if isinstance(a, of.ActionOutput):
            # max_len: bytes sent to the controller on output-to-controller
            out += struct.pack("!HHHH", OFPAT_OUTPUT, 8, a.port, 0xFFFF)
        elif isinstance(a, of.ActionSetDlDst):
            out += struct.pack(
                "!HH6s6x", OFPAT_SET_DL_DST, 16, _mac_bytes(a.mac)
            )
        else:
            raise ValueError(f"unsupported action {a!r}")
    return out


def decode_actions(buf: bytes) -> tuple[of.Action, ...]:
    actions: list[of.Action] = []
    off = 0
    while off < len(buf):
        a_type, a_len = struct.unpack_from("!HH", buf, off)
        if a_len < 8 or off + a_len > len(buf):
            raise ValueError("malformed action")
        if a_type == OFPAT_OUTPUT:
            port, _max_len = struct.unpack_from("!HH", buf, off + 4)
            actions.append(of.ActionOutput(port))
        elif a_type == OFPAT_SET_DL_DST:
            (mac,) = struct.unpack_from("!6s", buf, off + 4)
            actions.append(of.ActionSetDlDst(_mac_str(mac)))
        else:
            raise ValueError(f"unsupported action type {a_type}")
        off += a_len
    return tuple(actions)


# -- messages --------------------------------------------------------------


def encode_hello(xid: int = 0) -> bytes:
    return _pack(OFPT_HELLO, b"", xid)


def encode_echo_request(data: bytes = b"", xid: int = 0) -> bytes:
    return _pack(OFPT_ECHO_REQUEST, data, xid)


def encode_echo_reply(data: bytes = b"", xid: int = 0) -> bytes:
    return _pack(OFPT_ECHO_REPLY, data, xid)


def encode_flow_mod(
    mod: of.FlowMod,
    xid: int = 0,
    buffer_id: int = of.OFP_NO_BUFFER,
    out_port: int = of.OFPP_NONE,
    flags: int = OFPFF_SEND_FLOW_REM,
) -> bytes:
    """ofp_flow_mod — the reference's _add_flow body with
    OFPFF_SEND_FLOW_REM set (reference: sdnmpi/router.py:49-62)."""
    body = encode_match(mod.match) + struct.pack(
        "!QHHHHIHH",
        mod.cookie,
        mod.command,
        mod.idle_timeout,
        mod.hard_timeout,
        mod.priority,
        buffer_id,
        out_port,
        flags,
    ) + encode_actions(mod.actions)
    return _pack(OFPT_FLOW_MOD, body, xid)


#: wildcard word of the Router's exact-L2 install match — everything
#: open except dl_src/dl_dst, the same constant encode_match derives for
#: Match(dl_src=..., dl_dst=...)
_L2_WILDCARDS = (
    OFPFW_DL_VLAN | OFPFW_TP_SRC | OFPFW_DL_VLAN_PCP | OFPFW_NW_TOS
    | OFPFW_NW_SRC_ALL | OFPFW_NW_DST_ALL
    | OFPFW_IN_PORT | OFPFW_DL_TYPE | OFPFW_NW_PROTO | OFPFW_TP_DST
)


def _mac_cols(keys) -> "object":
    """[N] int64 MAC keys -> [N, 6] uint8 big-endian byte columns."""
    import numpy as np

    return (
        np.ascontiguousarray(keys, np.int64)
        .astype(">u8").view(np.uint8).reshape(-1, 8)[:, 2:]
    )


def _be16_cols(vals) -> "object":
    import numpy as np

    return np.asarray(vals).astype(">u2").view(np.uint8).reshape(-1, 2)


def _be32_cols(vals) -> "object":
    import numpy as np

    return np.asarray(vals).astype(">u4").view(np.uint8).reshape(-1, 4)


def _be64_cols(vals) -> "object":
    import numpy as np

    return np.asarray(vals).astype(">u8").view(np.uint8).reshape(-1, 8)


def encode_flow_mods_batch(batch: "of.FlowModBatch", xid_base: int = 0) -> bytes:
    """Serialize a whole FlowMod burst in one numpy pass.

    Byte-identical to concatenating ``encode_flow_mod`` over
    ``batch.to_flow_mods()`` with sequential xids starting at
    ``xid_base`` (asserted by tests/test_ofwire.py) — but the messages
    are assembled as uint8 record matrices (one fixed-size group per
    action layout) and scattered into the flat buffer, so a
    thousand-flow install costs a handful of array ops instead of N
    dataclass walks and ~5N ``struct.pack`` calls. This is the wire leg
    of the pipelined install plane (control/router.py).
    """
    return encode_flow_mods_spans(batch, xid_base)[0]


def encode_flow_mods_spans(
    batch: "of.FlowModBatch", xid_base: int = 0
):
    """``encode_flow_mods_batch`` plus the message offset table.

    Returns ``(blob, offsets)`` where ``offsets`` is [N + 1] int64 and
    message i is ``blob[offsets[i]:offsets[i + 1]]`` — so a caller that
    encoded a whole *window* (rows grouped by switch) can hand each
    switch its contiguous byte span without re-encoding per group: one
    numpy pass for the window, zero-copy slices per switch
    (OFSouthbound.flow_mods_window). The per-call fixed cost of the
    record assembly is paid once per window instead of once per switch,
    which is the difference between ~60 us x hundreds of tiny groups
    and one ~2 ms pass at coalescer scale.
    """
    import numpy as np

    n = len(batch)
    if n == 0:
        return b"", np.zeros(1, np.int64)
    src = np.ascontiguousarray(batch.src, np.int64)
    dst = np.ascontiguousarray(batch.dst, np.int64)
    delete = batch.command == of.OFPFC_DELETE
    if delete:
        has_rw = np.zeros(n, bool)
    elif batch.rewrite is None:
        has_rw = np.zeros(n, bool)
    else:
        has_rw = np.ascontiguousarray(batch.rewrite, np.int64) >= 0
    base_len = _HEADER.size + _MATCH_LEN + 24 + (0 if delete else 8)
    msg_len = np.where(has_rw, base_len + 16, base_len).astype(np.int64)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(msg_len, out=offsets[1:])
    buf = np.zeros(int(offsets[-1]), np.uint8)
    xids = np.arange(xid_base, xid_base + n, dtype=np.int64) & 0xFFFFFFFF

    for rewrite_group in (False, True):
        rows = np.nonzero(has_rw == rewrite_group)[0]
        if not len(rows):
            continue
        length = base_len + (16 if rewrite_group else 0)
        rec = np.zeros((len(rows), length), np.uint8)
        # -- ofp_header ------------------------------------------------
        rec[:, 0] = OFP_VERSION
        rec[:, 1] = OFPT_FLOW_MOD
        rec[:, 2:4] = _be16_cols(np.full(len(rows), length))
        rec[:, 4:8] = _be32_cols(xids[rows])
        # -- ofp_match (exact L2; every other field zero/wildcarded) ---
        rec[:, 8:12] = _be32_cols(np.full(len(rows), _L2_WILDCARDS))
        rec[:, 14:20] = _mac_cols(src[rows])
        rec[:, 20:26] = _mac_cols(dst[rows])
        # -- ofp_flow_mod body -----------------------------------------
        body = _HEADER.size + _MATCH_LEN
        rec[:, body : body + 8] = np.frombuffer(
            struct.pack("!Q", batch.cookie), np.uint8
        )
        rec[:, body + 8 : body + 24] = np.frombuffer(
            struct.pack(
                "!HHHHIHH",
                batch.command,
                batch.idle_timeout,
                batch.hard_timeout,
                batch.priority,
                of.OFP_NO_BUFFER,
                of.OFPP_NONE,
                OFPFF_SEND_FLOW_REM,
            ),
            np.uint8,
        )
        if not delete:
            # -- actions ------------------------------------------------
            act = body + 24
            if rewrite_group:
                rec[:, act : act + 4] = np.frombuffer(
                    struct.pack("!HH", OFPAT_SET_DL_DST, 16), np.uint8
                )
                rec[:, act + 4 : act + 10] = _mac_cols(
                    np.ascontiguousarray(batch.rewrite, np.int64)[rows]
                )
                act += 16
            rec[:, act : act + 4] = np.frombuffer(
                struct.pack("!HH", OFPAT_OUTPUT, 8), np.uint8
            )
            rec[:, act + 4 : act + 6] = _be16_cols(
                np.ascontiguousarray(batch.out_port)[rows].astype(np.uint16)
            )
            rec[:, act + 6 : act + 8] = 0xFF  # max_len, as encode_actions
        pos = offsets[rows][:, None] + np.arange(length)[None, :]
        buf[pos.ravel()] = rec.ravel()
    return buf.tobytes(), offsets


def decode_flow_mod(buf: bytes) -> of.FlowMod:
    msg_type, length, _xid = peek_header(buf)
    if msg_type != OFPT_FLOW_MOD:
        raise ValueError(f"not a flow_mod (type {msg_type})")
    body = buf[_HEADER.size:length]
    match = decode_match(body)
    (cookie, command, idle_t, hard_t, priority, _buf_id, _out_port,
     _flags) = struct.unpack_from("!QHHHHIHH", body, _MATCH_LEN)
    actions = decode_actions(body[_MATCH_LEN + 24:])
    return of.FlowMod(
        match=match, actions=actions, priority=priority, command=command,
        idle_timeout=idle_t, hard_timeout=hard_t, cookie=cookie,
    )


def encode_packet_out(out: of.PacketOut, xid: int = 0) -> bytes:
    """ofp_packet_out (reference: sdnmpi/router.py:106-123 — reuses the
    switch buffer when ``buffer_id`` is set, sends data bytes otherwise)."""
    actions = encode_actions(out.actions)
    data = b"" if out.buffer_id != of.OFP_NO_BUFFER else encode_frame(out.data)
    body = struct.pack(
        "!IHH", out.buffer_id, out.in_port, len(actions)
    ) + actions + data
    return _pack(OFPT_PACKET_OUT, body, xid)


def decode_packet_out(buf: bytes) -> of.PacketOut:
    msg_type, length, _xid = peek_header(buf)
    if msg_type != OFPT_PACKET_OUT:
        raise ValueError(f"not a packet_out (type {msg_type})")
    body = buf[_HEADER.size:length]
    buffer_id, in_port, actions_len = struct.unpack_from("!IHH", body)
    actions = decode_actions(body[8:8 + actions_len])
    data = body[8 + actions_len:]
    pkt = (
        decode_frame(data)
        if data
        else of.Packet("00:00:00:00:00:00", "00:00:00:00:00:00")
    )
    return of.PacketOut(
        data=pkt, actions=actions, in_port=in_port, buffer_id=buffer_id
    )


def encode_packet_in(
    pkt: of.Packet,
    in_port: int,
    buffer_id: int = of.OFP_NO_BUFFER,
    reason: int = OFPR_NO_MATCH,
    xid: int = 0,
) -> bytes:
    """ofp_packet_in — the table-miss upcall every app handler consumes
    (reference: sdnmpi/router.py:125-133, topology.py:110-131)."""
    frame = encode_frame(pkt)
    body = struct.pack(
        "!IHHBx", buffer_id, len(frame), in_port, reason
    ) + frame
    return _pack(OFPT_PACKET_IN, body, xid)


def decode_packet_in(buf: bytes) -> tuple[of.Packet, int, int, int]:
    """Returns (packet, in_port, buffer_id, reason)."""
    msg_type, length, _xid = peek_header(buf)
    if msg_type != OFPT_PACKET_IN:
        raise ValueError(f"not a packet_in (type {msg_type})")
    body = buf[_HEADER.size:length]
    buffer_id, _total_len, in_port, reason = struct.unpack_from("!IHHBx", body)
    return decode_frame(body[10:]), in_port, buffer_id, reason


def encode_flow_removed(
    match: of.Match,
    priority: int,
    reason: int,
    cookie: int = 0,
    duration_sec: int = 0,
    idle_timeout: int = 0,
    packet_count: int = 0,
    byte_count: int = 0,
    xid: int = 0,
) -> bytes:
    """ofp_flow_removed — the reply to OFPFF_SEND_FLOW_REM that the
    reference requests but never handles (reference: sdnmpi/router.py:61,
    SURVEY §2 defect); this framework's Router consumes it."""
    body = encode_match(match) + struct.pack(
        "!QHBxIIH2xQQ",
        cookie, priority, reason, duration_sec, 0, idle_timeout,
        packet_count, byte_count,
    )
    return _pack(OFPT_FLOW_REMOVED, body, xid)


def decode_flow_removed(buf: bytes) -> dict:
    msg_type, length, _xid = peek_header(buf)
    if msg_type != OFPT_FLOW_REMOVED:
        raise ValueError(f"not a flow_removed (type {msg_type})")
    body = buf[_HEADER.size:length]
    match = decode_match(body)
    (cookie, priority, reason, dur_s, _dur_ns, idle_t, pkts,
     bts) = struct.unpack_from("!QHBxIIH2xQQ", body, _MATCH_LEN)
    return {
        "match": match, "cookie": cookie, "priority": priority,
        "reason": reason, "duration_sec": dur_s, "idle_timeout": idle_t,
        "packet_count": pkts, "byte_count": bts,
    }


def encode_barrier_request(xid: int = 0) -> bytes:
    """ofp_header-only OFPT_BARRIER_REQUEST — terminates each batched
    install span so the switch's reply (spec §5.3.7: everything before
    the barrier has been processed) is the install's end-to-end receipt
    (control/recovery.py). The reference never sent one; its installs
    were fire-and-forget."""
    return _pack(OFPT_BARRIER_REQUEST, b"", xid)


def encode_barrier_reply(xid: int = 0) -> bytes:
    return _pack(OFPT_BARRIER_REPLY, b"", xid)


def decode_barrier_reply(buf: bytes) -> int:
    """Returns the xid echoing the request's (the pending-barrier key)."""
    msg_type, _length, xid = peek_header(buf)
    if msg_type != OFPT_BARRIER_REPLY:
        raise ValueError(f"not a barrier_reply (type {msg_type})")
    return xid


def encode_error(err_type: int, code: int, data: bytes = b"",
                 xid: int = 0) -> bytes:
    """ofp_error_msg — switches reject bad requests with these; the
    southbound surfaces them instead of dropping them on the floor."""
    return _pack(OFPT_ERROR, struct.pack("!HH", err_type, code) + data, xid)


def decode_error(buf: bytes) -> tuple[int, int, bytes]:
    """Returns (err_type, code, data) of an ofp_error_msg."""
    msg_type, length, _xid = peek_header(buf)
    if msg_type != OFPT_ERROR:
        raise ValueError(f"not an error message (type {msg_type})")
    err_type, code = struct.unpack_from("!HH", buf, _HEADER.size)
    return err_type, code, buf[_HEADER.size + 4:length]


OFPT_PORT_STATUS = 12
OFPPR_ADD = 0
OFPPR_DELETE = 1
OFPPR_MODIFY = 2
OFPPS_LINK_DOWN = 1 << 0


def encode_port_status(
    reason: int, port_no: int, state: int = 0, xid: int = 0
) -> bytes:
    """ofp_port_status — a switch reporting a port add/delete/modify
    (cable events; Ryu surfaced these as Event{PortAdd,PortDelete})."""
    body = struct.pack("!B7x", reason) + _PHY_PORT.pack(
        port_no, b"\0" * 6, b"\0" * 16, 0, state, 0, 0, 0, 0
    )
    return _pack(OFPT_PORT_STATUS, body, xid)


def decode_port_status(buf: bytes) -> tuple[int, int, int]:
    """Returns (reason, port_no, state)."""
    msg_type, _length, _xid = peek_header(buf)
    if msg_type != OFPT_PORT_STATUS:
        raise ValueError(f"not a port_status (type {msg_type})")
    (reason,) = struct.unpack_from("!B", buf, _HEADER.size)
    port_no, _hw, _name, _config, state, *_rest = _PHY_PORT.unpack_from(
        buf, _HEADER.size + 8
    )
    return reason, port_no, state


def encode_features_request(xid: int = 0) -> bytes:
    """ofp_header-only OFPT_FEATURES_REQUEST — the controller's first
    question after Hello in the OF 1.0 handshake (Ryu performed this
    for the reference before any app saw the datapath)."""
    return _pack(OFPT_FEATURES_REQUEST, b"", xid)


_FEATURES_HEAD = struct.Struct("!QIB3xII")  # ofp_switch_features fixed part
_PHY_PORT = struct.Struct("!H6s16sIIIIII")  # ofp_phy_port, 48 bytes


def encode_features_reply(
    dpid: int, port_nos: list[int], xid: int = 0, n_buffers: int = 256,
    n_tables: int = 1,
) -> bytes:
    """ofp_switch_features + one ofp_phy_port per port. Port hw_addr is
    derived from (dpid, port_no) and names are synthesized — the
    controller only consumes dpid + port numbers (core Switch entity)."""
    body = _FEATURES_HEAD.pack(dpid, n_buffers, n_tables, 0, 0)
    for p in port_nos:
        hw = bytes([0x02, 0, (dpid >> 16) & 0xFF, (dpid >> 8) & 0xFF,
                    dpid & 0xFF, p & 0xFF])
        name = f"port{p}".encode()[:15]
        body += _PHY_PORT.pack(p, hw, name.ljust(16, b"\0"), 0, 0, 0, 0, 0, 0)
    return _pack(OFPT_FEATURES_REPLY, body, xid)


def decode_features_reply(buf: bytes) -> tuple[int, list[int]]:
    """Returns (datapath_id, [port_no, ...]); OFPP_LOCAL and other
    reserved ports (>= 0xff00) are filtered — the topology model tracks
    only physical ports."""
    msg_type, length, _xid = peek_header(buf)
    if msg_type != OFPT_FEATURES_REPLY:
        raise ValueError(f"not a features_reply (type {msg_type})")
    dpid, _bufs, _tables, _cap, _act = _FEATURES_HEAD.unpack_from(
        buf, _HEADER.size
    )
    ports = []
    off = _HEADER.size + _FEATURES_HEAD.size
    while off + _PHY_PORT.size <= length:
        (port_no, *_rest) = _PHY_PORT.unpack_from(buf, off)
        if port_no < 0xFF00:
            ports.append(port_no)
        off += _PHY_PORT.size
    return dpid, ports


def encode_port_stats_request(
    port_no: int = of.OFPP_NONE, xid: int = 0
) -> bytes:
    """ofp_stats_request(OFPST_PORT) — the Monitor's 1 Hz poll
    (reference: sdnmpi/monitor.py:54-60; OFPP_NONE = all ports)."""
    body = struct.pack("!HH", OFPST_PORT, 0) + struct.pack("!H6x", port_no)
    return _pack(OFPT_STATS_REQUEST, body, xid)


def decode_port_stats_request(buf: bytes) -> int:
    """Returns the requested port_no (OFPP_NONE = all)."""
    msg_type, length, _xid = peek_header(buf)
    if msg_type != OFPT_STATS_REQUEST:
        raise ValueError(f"not a stats_request (type {msg_type})")
    stats_type, _flags = struct.unpack_from("!HH", buf, _HEADER.size)
    if stats_type != OFPST_PORT:
        raise ValueError(f"unsupported stats type {stats_type}")
    (port_no,) = struct.unpack_from("!H", buf, _HEADER.size + 4)
    return port_no


_PORT_STATS = struct.Struct("!H6xQQQQQQQQQQQQ")  # ofp_port_stats, 104 bytes


def encode_port_stats_reply(
    entries: list[of.PortStatsEntry], xid: int = 0
) -> bytes:
    """ofp_stats_reply(OFPST_PORT) with one ofp_port_stats per port; the
    counters the Monitor differentiates into pps/bps
    (reference: sdnmpi/monitor.py:62-94). Unmodeled error/drop counters
    are zero."""
    body = struct.pack("!HH", OFPST_PORT, 0)
    for e in entries:
        body += _PORT_STATS.pack(
            e.port_no, e.rx_packets, e.tx_packets, e.rx_bytes, e.tx_bytes,
            0, 0, 0, 0, 0, 0, 0, 0,
        )
    return _pack(OFPT_STATS_REPLY, body, xid)


def decode_port_stats_reply(buf: bytes) -> list[of.PortStatsEntry]:
    msg_type, length, _xid = peek_header(buf)
    if msg_type != OFPT_STATS_REPLY:
        raise ValueError(f"not a stats_reply (type {msg_type})")
    stats_type, _flags = struct.unpack_from("!HH", buf, _HEADER.size)
    if stats_type != OFPST_PORT:
        raise ValueError(f"unsupported stats type {stats_type}")
    entries = []
    off = _HEADER.size + 4
    while off + _PORT_STATS.size <= length:
        (port_no, rx_p, tx_p, rx_b, tx_b, *_rest) = _PORT_STATS.unpack_from(
            buf, off
        )
        entries.append(of.PortStatsEntry(port_no, rx_p, rx_b, tx_p, tx_b))
        off += _PORT_STATS.size
    return entries


# -- OFPST_FLOW: flow-table ground truth -------------------------
#
# The fabric audit plane (control/audit.py) pulls every switch's actual
# flow table and diffs it against the desired store — the verification
# channel the reference never had (its Monitor polls OFPST_PORT only,
# sdnmpi/monitor.py:54-60). Replies are MULTIPART: the OF 1.0 header's
# length field is 16-bit, so a serving-scale table cannot fit one
# message — the encoder splits on record boundaries with
# OFPSF_REPLY_MORE set on every part but the last, and the decoder
# accepts the whole part list. Record assembly is numpy-batched like
# encode_flow_mods_batch: the Router's install shapes (exact-L2 match;
# no-action / output / rewrite+output) build as uint8 record matrices,
# one group per layout; anything else (control rules with richer
# matches) takes the scalar struct path, byte-identically.

#: ofp_flow_stats body after the (length, table_id, pad) prefix + match:
#: duration_sec, duration_nsec, priority, idle, hard, pad[6],
#: cookie, packet_count, byte_count
_FLOW_STATS_BODY = struct.Struct("!IIHHH6xQQQ")
_FLOW_STATS_FIXED = 4 + _MATCH_LEN + _FLOW_STATS_BODY.size  # 88 bytes
assert _FLOW_STATS_FIXED == 88

#: max stats-reply body bytes per multipart message (header 8 + stats
#: preamble 4 + body must fit the 16-bit length field)
OFP_MAX_STATS_BODY = 65535 - _HEADER.size - 4


def encode_flow_stats_request(
    match: of.Match = of.Match(), out_port: int = of.OFPP_NONE,
    table_id: int = 0xFF, xid: int = 0,
) -> bytes:
    """ofp_stats_request(OFPST_FLOW) — all-wildcard match + table 0xFF
    + OFPP_NONE is the audit plane's "dump the whole table" pull."""
    body = struct.pack("!HH", OFPST_FLOW, 0) + encode_match(match) + (
        struct.pack("!BxH", table_id, out_port)
    )
    return _pack(OFPT_STATS_REQUEST, body, xid)


def decode_flow_stats_request(buf: bytes) -> tuple[of.Match, int, int]:
    """Returns (match, table_id, out_port)."""
    msg_type, _length, _xid = peek_header(buf)
    if msg_type != OFPT_STATS_REQUEST:
        raise ValueError(f"not a stats_request (type {msg_type})")
    stats_type, _flags = struct.unpack_from("!HH", buf, _HEADER.size)
    if stats_type != OFPST_FLOW:
        raise ValueError(f"unsupported stats type {stats_type}")
    off = _HEADER.size + 4
    match = decode_match(buf[off:off + _MATCH_LEN])
    table_id, out_port = struct.unpack_from("!BxH", buf, off + _MATCH_LEN)
    return match, table_id, out_port


def peek_stats_type(buf: bytes) -> tuple[int, int]:
    """(stats_type, flags) of an OFPT_STATS_REQUEST/REPLY — enough for
    the southbound's dispatch to route OFPST_PORT vs OFPST_FLOW and to
    detect a multipart reply's REPLY_MORE flag."""
    return struct.unpack_from("!HH", buf, _HEADER.size)


def _encode_flow_stats_entry(e: "of.FlowStatsEntry") -> bytes:
    """Scalar ofp_flow_stats record — the general-match fallback and
    the differential reference the batched assembly is tested against."""
    actions = encode_actions(e.actions)
    return (
        struct.pack("!HBx", _FLOW_STATS_FIXED + len(actions), 0)
        + encode_match(e.match)
        + _FLOW_STATS_BODY.pack(
            e.duration_sec, 0, e.priority, e.idle_timeout,
            e.hard_timeout, e.cookie, e.packet_count, e.byte_count,
        )
        + actions
    )


def _decode_flow_stats_entry(rec: bytes) -> "of.FlowStatsEntry":
    """Scalar twin of the batched record decode. Exact-L2 rows (the
    overwhelming bulk of a route table) take a memoized fast parse;
    general matches go through decode_match/decode_actions."""
    (wild,) = struct.unpack_from("!I", rec, 4)
    if wild == _L2_WILDCARDS:
        src = _memo_mac(int.from_bytes(rec[10:16], "big"))
        dst = _memo_mac(int.from_bytes(rec[16:22], "big"))
        match = of.Match(dl_src=src, dl_dst=dst)
    else:
        match = decode_match(rec[4:4 + _MATCH_LEN])
    (dur_s, _dur_ns, priority, idle_t, hard_t, cookie, pkts,
     bts) = _FLOW_STATS_BODY.unpack_from(rec, 4 + _MATCH_LEN)
    return of.FlowStatsEntry(
        match=match, actions=decode_actions(rec[_FLOW_STATS_FIXED:]),
        priority=priority, duration_sec=dur_s, idle_timeout=idle_t,
        hard_timeout=hard_t, cookie=cookie, packet_count=pkts,
        byte_count=bts,
    )


#: action-layout classes of the batched record assembly: bytes of the
#: action section per class (drop / output / rewrite + output)
_FS_ACT_LEN = (0, 8, 24)

#: record count below which the scalar struct path beats the batched
#: matrix assembly (numpy's per-call fixed cost only amortizes past
#: this; an audit sweep pulls hundreds of SMALL per-switch tables, and
#: the two paths are byte-identical by the differential test)
_FS_BATCH_MIN = 64

def _memo_mac(key: int) -> str:
    """Shared bounded MAC memo (one audit sweep re-materializes the
    same endpoint MACs for every switch on a path)."""
    from sdnmpi_tpu_torch.utils.mac import int_to_mac_memo

    return int_to_mac_memo(key)


def _flow_stats_blob(entries) -> tuple[bytes, "object"]:
    """Concatenated ofp_flow_stats records + [N + 1] int64 offsets.

    Exact-L2 rows with the Router's action shapes assemble as uint8
    record matrices (one numpy pass per action layout, the
    encode_flow_mods_spans idiom); other rows — the bootstrap control
    rules with richer matches — encode through the scalar path into the
    same offset table, so record order is preserved either way."""
    import numpy as np

    from sdnmpi_tpu_torch.utils.mac import mac_to_int

    n = len(entries)
    offsets = np.zeros(n + 1, np.int64)
    if n == 0:
        return b"", offsets
    if n < _FS_BATCH_MIN:
        # small table: the scalar path wins (byte-identical)
        recs = [_encode_flow_stats_entry(e) for e in entries]
        np.cumsum([len(r) for r in recs], out=offsets[1:])
        return b"".join(recs), offsets
    cls = np.full(n, -1, np.int64)
    src = np.zeros(n, np.int64)
    dst = np.zeros(n, np.int64)
    port = np.zeros(n, np.int64)
    rew = np.zeros(n, np.int64)
    slow: dict[int, bytes] = {}
    for i, e in enumerate(entries):
        m = e.match
        a = e.actions
        if (
            m.dl_src is not None and m.dl_dst is not None
            and m.in_port is None and m.dl_type is None
            and m.nw_proto is None and m.tp_dst is None
        ):
            if a == ():
                cls[i] = 0
            elif len(a) == 1 and isinstance(a[0], of.ActionOutput):
                cls[i] = 1
                port[i] = a[0].port
            elif (
                len(a) == 2
                and isinstance(a[0], of.ActionSetDlDst)
                and isinstance(a[1], of.ActionOutput)
            ):
                cls[i] = 2
                rew[i] = mac_to_int(a[0].mac)
                port[i] = a[1].port
        if cls[i] >= 0:
            src[i] = mac_to_int(m.dl_src)
            dst[i] = mac_to_int(m.dl_dst)
        else:
            slow[i] = _encode_flow_stats_entry(e)
    lens = np.where(
        cls >= 0,
        _FLOW_STATS_FIXED + np.choose(np.maximum(cls, 0), _FS_ACT_LEN),
        0,
    )
    for i, rec in slow.items():
        lens[i] = len(rec)
    np.cumsum(lens, out=offsets[1:])
    buf = np.zeros(int(offsets[-1]), np.uint8)
    dur = np.array([e.duration_sec for e in entries], np.int64)
    prio = np.array([e.priority for e in entries], np.int64)
    idle = np.array([e.idle_timeout for e in entries], np.int64)
    hard = np.array([e.hard_timeout for e in entries], np.int64)
    cookie = np.array([e.cookie for e in entries], np.uint64)
    pkts = np.array([e.packet_count for e in entries], np.uint64)
    bts = np.array([e.byte_count for e in entries], np.uint64)
    for c in (0, 1, 2):
        rows = np.nonzero(cls == c)[0]
        if not len(rows):
            continue
        length = _FLOW_STATS_FIXED + _FS_ACT_LEN[c]
        rec = np.zeros((len(rows), length), np.uint8)
        rec[:, 0:2] = _be16_cols(np.full(len(rows), length))
        # match at 4: exact-L2 wildcards + the two MACs
        rec[:, 4:8] = _be32_cols(np.full(len(rows), _L2_WILDCARDS))
        rec[:, 10:16] = _mac_cols(src[rows])
        rec[:, 16:22] = _mac_cols(dst[rows])
        body = 4 + _MATCH_LEN
        rec[:, body:body + 4] = _be32_cols(dur[rows])
        rec[:, body + 8:body + 10] = _be16_cols(prio[rows])
        rec[:, body + 10:body + 12] = _be16_cols(idle[rows])
        rec[:, body + 12:body + 14] = _be16_cols(hard[rows])
        rec[:, body + 20:body + 28] = _be64_cols(cookie[rows])
        rec[:, body + 28:body + 36] = _be64_cols(pkts[rows])
        rec[:, body + 36:body + 44] = _be64_cols(bts[rows])
        act = _FLOW_STATS_FIXED
        if c == 2:
            rec[:, act:act + 4] = np.frombuffer(
                struct.pack("!HH", OFPAT_SET_DL_DST, 16), np.uint8
            )
            rec[:, act + 4:act + 10] = _mac_cols(rew[rows])
            act += 16
        if c >= 1:
            rec[:, act:act + 4] = np.frombuffer(
                struct.pack("!HH", OFPAT_OUTPUT, 8), np.uint8
            )
            rec[:, act + 4:act + 6] = _be16_cols(
                port[rows].astype(np.uint16)
            )
            rec[:, act + 6:act + 8] = 0xFF  # max_len, as encode_actions
        pos = offsets[rows][:, None] + np.arange(length)[None, :]
        buf[pos.ravel()] = rec.ravel()
    out = buf.tobytes()
    if slow:
        b = bytearray(out)
        for i, rec in slow.items():
            b[int(offsets[i]):int(offsets[i + 1])] = rec
        out = bytes(b)
    return out, offsets


def encode_flow_stats_reply(
    entries, xid: int = 0, max_body: int = OFP_MAX_STATS_BODY
) -> list[bytes]:
    """ofp_stats_reply(OFPST_FLOW) messages for a whole flow table —
    a LIST because the reply is multipart (module section comment): the
    record stream splits on record boundaries at ``max_body`` bytes and
    every part but the last carries OFPSF_REPLY_MORE. An empty table is
    one empty-bodied part (the switch must still answer)."""
    blob, offsets = _flow_stats_blob(entries)
    parts: list[bytes] = []
    lo = 0
    n = len(offsets) - 1
    while True:
        hi = lo
        while hi < n and int(offsets[hi + 1] - offsets[lo]) <= max_body:
            hi += 1
        if hi == lo and lo < n:
            raise ValueError(
                f"flow stats record {lo} exceeds max_body {max_body}"
            )
        last = hi >= n
        body = struct.pack(
            "!HH", OFPST_FLOW, 0 if last else OFPSF_REPLY_MORE
        ) + blob[int(offsets[lo]):int(offsets[hi])]
        parts.append(_pack(OFPT_STATS_REPLY, body, xid))
        if last:
            return parts
        lo = hi


def decode_flow_stats_reply(msgs) -> list["of.FlowStatsEntry"]:
    """Decode one OFPST_FLOW reply — a single message or the whole
    multipart list — back to FlowStatsEntry records. Fixed-stride
    record groups decode through uint8 matrices (vectorized counters /
    MAC columns for exact-L2 rows, the batched-encode mirror); richer
    matches and unknown action layouts fall back to the scalar parser
    per record."""
    import numpy as np

    if isinstance(msgs, (bytes, bytearray, memoryview)):
        msgs = [bytes(msgs)]
    entries: list[of.FlowStatsEntry] = []
    for buf in msgs:
        msg_type, length, _xid = peek_header(buf)
        if msg_type != OFPT_STATS_REPLY:
            raise ValueError(f"not a stats_reply (type {msg_type})")
        stats_type, _flags = struct.unpack_from("!HH", buf, _HEADER.size)
        if stats_type != OFPST_FLOW:
            raise ValueError(f"unsupported stats type {stats_type}")
        body = buf[_HEADER.size + 4:length]
        off = 0
        starts: list[int] = []
        lens: list[int] = []
        while off + _FLOW_STATS_FIXED <= len(body):
            (rec_len,) = struct.unpack_from("!H", body, off)
            if rec_len < _FLOW_STATS_FIXED or off + rec_len > len(body):
                raise ValueError(f"malformed flow stats record at {off}")
            starts.append(off)
            lens.append(rec_len)
            off += rec_len
        if off != len(body):
            raise ValueError("trailing bytes in flow stats reply")
        if not starts:
            continue
        if len(starts) < _FS_BATCH_MIN:
            # small table: the scalar parser wins (same records)
            entries.extend(
                _decode_flow_stats_entry(body[lo:lo + ln])
                for lo, ln in zip(starts, lens)
            )
            continue
        raw = np.frombuffer(body, np.uint8)
        starts_a = np.array(starts, np.int64)
        lens_a = np.array(lens, np.int64)
        out: list = [None] * len(starts)
        for rec_len in np.unique(lens_a):
            rows = np.nonzero(lens_a == rec_len)[0]
            m = raw[
                starts_a[rows][:, None] + np.arange(int(rec_len))[None, :]
            ]
            decoded = _decode_flow_stats_matrix(m, int(rec_len), body,
                                                starts_a[rows])
            for k, i in enumerate(rows):
                out[int(i)] = decoded[k]
        entries.extend(out)
    return entries


def _decode_flow_stats_matrix(m, rec_len: int, body: bytes, starts):
    """Decode one fixed-stride record group ([n, rec_len] uint8).
    Exact-L2 rows with a recognized action layout decode vectorized;
    the rest re-parse scalar from ``body`` at their ``starts``."""
    import numpy as np

    n = len(m)
    wild = m[:, 4:8].copy().view(">u4").ravel()
    fast = wild == np.uint32(_L2_WILDCARDS)
    act_len = rec_len - _FLOW_STATS_FIXED
    act = _FLOW_STATS_FIXED
    if act_len == 0:
        actions_ok = np.ones(n, bool)
    elif act_len == 8:
        actions_ok = (
            (m[:, act:act + 4].copy().view(">u4").ravel()
             == np.uint32((OFPAT_OUTPUT << 16) | 8))
        )
    elif act_len == 24:
        actions_ok = (
            (m[:, act:act + 4].copy().view(">u4").ravel()
             == np.uint32((OFPAT_SET_DL_DST << 16) | 16))
            & (m[:, act + 16:act + 20].copy().view(">u4").ravel()
               == np.uint32((OFPAT_OUTPUT << 16) | 8))
        )
    else:
        actions_ok = np.zeros(n, bool)
    fast = fast & actions_ok
    out: list = [None] * n
    if fast.any():
        rows = np.nonzero(fast)[0]
        f = m[rows]
        body_off = 4 + _MATCH_LEN

        def _u8(col):  # 6-byte MAC columns -> int64 keys
            k = np.zeros((len(f), 8), np.uint8)
            k[:, 2:] = f[:, col:col + 6]
            return k.view(">u8").ravel().astype(np.int64)

        def _be(lo, width):
            v = f[:, lo:lo + width].copy()
            return v.view(f">u{width}").ravel()

        src = _u8(10)
        dst = _u8(16)
        dur = _be(body_off, 4)
        prio = _be(body_off + 8, 2)
        idle = _be(body_off + 10, 2)
        hard = _be(body_off + 12, 2)
        cookie = _be(body_off + 20, 8)
        pkts = _be(body_off + 28, 8)
        bts = _be(body_off + 36, 8)
        if act_len == 24:
            rew = _u8(act + 4)
            out_port = _be(act + 16 + 4, 2)
        elif act_len == 8:
            rew = None
            out_port = _be(act + 4, 2)
        else:
            rew = out_port = None
        _mac = _memo_mac

        for k, i in enumerate(rows):
            actions: tuple = ()
            if out_port is not None:
                actions = (of.ActionOutput(int(out_port[k])),)
                if rew is not None:
                    actions = (
                        of.ActionSetDlDst(_mac(int(rew[k]))),
                    ) + actions
            out[int(i)] = of.FlowStatsEntry(
                match=of.Match(
                    dl_src=_mac(int(src[k])), dl_dst=_mac(int(dst[k]))
                ),
                actions=actions,
                priority=int(prio[k]),
                duration_sec=int(dur[k]),
                idle_timeout=int(idle[k]),
                hard_timeout=int(hard[k]),
                cookie=int(cookie[k]),
                packet_count=int(pkts[k]),
                byte_count=int(bts[k]),
            )
    for i in np.nonzero(~fast)[0]:
        lo = int(starts[int(i)])
        out[int(i)] = _decode_flow_stats_entry(body[lo:lo + rec_len])
    return out

"""LLDP frames for packet-level topology discovery.

The reference learns its link map from LLDP: ``--observe-links``
(reference: run_router.sh:2) makes Ryu's ``switches`` app flood an LLDP
frame out of every switch port and infer a directed link when the frame
packet-ins back from the neighbor (consumed at reference:
sdnmpi/topology.py:184-202 as EventLinkAdd/Delete). This module is the
frame ABI for this framework's equivalent (control/discovery.py):
real TLV bytes in the payload, the same ``dpid:%016x`` chassis-id
convention Ryu uses, parsed back to ``(dpid, port_no)``.
"""

from __future__ import annotations

import struct

from sdnmpi_tpu_torch.protocol import openflow as of

#: nearest-bridge multicast group — LLDP frames are link-local, never
#: forwarded by compliant switches (hence one frame <-> one link hop)
LLDP_MAC_NEAREST_BRIDGE = "01:80:c2:00:00:0e"

_TLV_END = 0
_TLV_CHASSIS_ID = 1
_TLV_PORT_ID = 2
_TLV_TTL = 3

_CHASSIS_SUBTYPE_LOCAL = 7  # locally assigned string (Ryu's choice)
_PORT_SUBTYPE_COMPONENT = 2

_TTL_SECONDS = 120


def _tlv(tlv_type: int, value: bytes) -> bytes:
    return struct.pack("!H", (tlv_type << 9) | len(value)) + value


def encode_lldp(dpid: int, port_no: int) -> of.Packet:
    """The probe frame the controller floods out (dpid, port_no)."""
    payload = (
        _tlv(_TLV_CHASSIS_ID,
             bytes([_CHASSIS_SUBTYPE_LOCAL]) + f"dpid:{dpid:016x}".encode())
        + _tlv(_TLV_PORT_ID,
               bytes([_PORT_SUBTYPE_COMPONENT]) + struct.pack("!I", port_no))
        + _tlv(_TLV_TTL, struct.pack("!H", _TTL_SECONDS))
        + _tlv(_TLV_END, b"")
    )
    # source MAC is cosmetic (parsers use the TLVs); derive one from the
    # dpid's low 40 bits with the locally-administered bit set
    low = dpid & ((1 << 40) - 1)
    src = "06:" + ":".join(f"{b:02x}" for b in low.to_bytes(5, "big"))
    return of.Packet(
        eth_src=src,
        eth_dst=LLDP_MAC_NEAREST_BRIDGE,
        eth_type=of.ETH_TYPE_LLDP,
        payload=payload,
    )


def decode_lldp(pkt: of.Packet) -> tuple[int, int]:
    """(origin dpid, origin port_no) from a probe frame's TLVs.

    Raises ValueError on anything that is not one of our probes (foreign
    LLDP speakers are legitimate on a real network; callers skip them).
    """
    if pkt.eth_type != of.ETH_TYPE_LLDP:
        raise ValueError("not an LLDP frame")
    dpid = port_no = None
    buf = pkt.payload
    off = 0
    while off + 2 <= len(buf):
        (head,) = struct.unpack_from("!H", buf, off)
        tlv_type, tlv_len = head >> 9, head & 0x1FF
        value = buf[off + 2:off + 2 + tlv_len]
        if tlv_type == _TLV_END:
            break
        if tlv_type == _TLV_CHASSIS_ID and value[:1] == bytes(
            [_CHASSIS_SUBTYPE_LOCAL]
        ):
            text = value[1:].decode(errors="replace")
            if not text.startswith("dpid:"):
                raise ValueError(f"foreign chassis id {text!r}")
            dpid = int(text[5:], 16)
        elif tlv_type == _TLV_PORT_ID and value[:1] == bytes(
            [_PORT_SUBTYPE_COMPONENT]
        ):
            if len(value) < 5:
                raise ValueError("truncated port-id TLV")
            (port_no,) = struct.unpack("!I", value[1:5])
        off += 2 + tlv_len
    if dpid is None or port_no is None:
        raise ValueError("LLDP frame without dpid/port TLVs")
    return dpid, port_no

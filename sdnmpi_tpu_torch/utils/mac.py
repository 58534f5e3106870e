"""MAC address helpers.

The reference leans on ``ryu.lib.mac.haddr_to_bin`` and ad-hoc parsing
(reference: sdnmpi/util/topology_db.py:124-125, sdnmpi/router.py:162-178).
These are the dependency-free equivalents.
"""

from __future__ import annotations

BROADCAST_MAC = "ff:ff:ff:ff:ff:ff"
IPV6_MCAST_PREFIX = "33:33"


def mac_to_int(mac: str) -> int:
    """Parse ``"02:00:00:00:00:01"`` -> 0x020000000001."""
    return int(mac.replace(":", ""), 16)


def int_to_mac(value: int) -> str:
    if not 0 <= value < 1 << 48:
        raise ValueError(f"MAC value out of range: {value:#x}")
    raw = f"{value:012x}"
    return ":".join(raw[i : i + 2] for i in range(0, 12, 2))


#: bounded int48 -> "aa:bb:.." memo behind :func:`int_to_mac_memo` —
#: hot decode paths (flow-stats sweeps, phase-row indexes) re-
#: materialize the same endpoint MACs constantly; the key space is the
#: fabric's endpoints, but cap anyway
_MAC_MEMO: dict = {}
_MAC_MEMO_CAP = 1 << 16


def int_to_mac_memo(value: int) -> str:
    """Memoized :func:`int_to_mac` (bounded, process-wide)."""
    s = _MAC_MEMO.get(value)
    if s is None:
        if len(_MAC_MEMO) >= _MAC_MEMO_CAP:
            _MAC_MEMO.clear()
        s = _MAC_MEMO[value] = int_to_mac(value)
    return s


def mac_to_bytes(mac: str) -> bytes:
    return bytes.fromhex(mac.replace(":", ""))


def bytes_to_mac(raw: bytes) -> str:
    if len(raw) != 6:
        raise ValueError(f"MAC must be 6 bytes, got {len(raw)}")
    return ":".join(f"{b:02x}" for b in raw)


def macs_to_ints(macs) -> "np.ndarray":
    """Vectorized ``mac_to_int`` over a sequence -> [N] int64.

    N is the number of *unique endpoints* (hosts/ranks), not flows, so a
    Python loop here is fine — the flow-scale arrays downstream index
    into this."""
    import numpy as np

    return np.array([int(m.replace(":", ""), 16) for m in macs], dtype=np.int64)


def ints_to_macs(values: "np.ndarray") -> "np.ndarray":
    """Vectorized ``int_to_mac``: [N] int64 -> [N] str array.

    Byte-sliced through a 256-entry hex lookup table — no per-element
    Python formatting, so encoding millions of flow MACs stays in numpy.
    """
    import numpy as np

    values = np.asarray(values, dtype=np.int64)
    lut = np.array([f"{i:02x}" for i in range(256)])
    sep = np.array(":")
    out = lut[(values >> 40) & 0xFF]
    for shift in (32, 24, 16, 8, 0):
        out = np.char.add(np.char.add(out, sep), lut[(values >> shift) & 0xFF])
    return out


def is_broadcast(mac: str) -> bool:
    return mac.lower() == BROADCAST_MAC


def is_ipv6_multicast(mac: str) -> bool:
    """IPv6 multicast MACs start with 33:33 (reference: router.py:142)."""
    return mac.lower().startswith(IPV6_MCAST_PREFIX)

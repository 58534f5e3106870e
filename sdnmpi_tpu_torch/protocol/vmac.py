"""Virtual destination MAC codec — the "MPI packet" addressing ABI.

The reference encodes the MPI collective type and the source/destination
ranks of a message into the destination MAC address of the Ethernet frame
(decoded at reference: sdnmpi/router.py:162-178):

    byte 0:  (coll_type << 2) | 0x02     -- locally-administered bit marks
                                            the address as SDN-MPI
    byte 1:  unused (0)
    bytes 2-3: src_rank, little-endian int16
    bytes 4-5: dst_rank, little-endian int16

An address is recognized as SDN-MPI iff bit 0x02 of byte 0 is set
(reference: sdnmpi/router.py:162-164).
"""

from __future__ import annotations

import dataclasses
import struct

from sdnmpi_tpu_torch.utils.mac import bytes_to_mac, mac_to_bytes


class CollectiveType:
    """Well-known collective ids carried in the vMAC type field."""

    P2P = 0
    BCAST = 1
    REDUCE = 2
    ALLREDUCE = 3
    GATHER = 4
    SCATTER = 5
    ALLGATHER = 6
    REDUCE_SCATTER = 7
    ALLTOALL = 8
    BARRIER = 9


def is_sdn_mpi_addr(mac: str) -> bool:
    """True iff the locally-administered bit marks this as an SDN-MPI vMAC."""
    return bool(mac_to_bytes(mac)[0] & 0x02)


@dataclasses.dataclass(frozen=True)
class VirtualMac:
    coll_type: int
    src_rank: int
    dst_rank: int

    def encode(self) -> str:
        if not 0 <= self.coll_type < 64:
            raise ValueError(f"coll_type must fit in 6 bits: {self.coll_type}")
        for name, rank in (("src_rank", self.src_rank), ("dst_rank", self.dst_rank)):
            if not -(1 << 15) <= rank < 1 << 15:
                raise ValueError(f"{name} must fit in int16: {rank}")
        b0 = (self.coll_type << 2) | 0x02
        raw = bytes([b0, 0]) + struct.pack("<hh", self.src_rank, self.dst_rank)
        return bytes_to_mac(raw)

    @classmethod
    def decode(cls, mac: str) -> "VirtualMac":
        raw = mac_to_bytes(mac)
        if not raw[0] & 0x02:
            raise ValueError(f"not an SDN-MPI virtual MAC: {mac}")
        coll_type = raw[0] >> 2
        src_rank, dst_rank = struct.unpack("<hh", raw[2:6])
        return cls(coll_type, src_rank, dst_rank)


def encode_batch_ints(coll_type: int, src_ranks, dst_ranks) -> "object":
    """Vectorized vMAC encoding to int48 MAC keys ([F] int64 numpy).

    Same byte layout as :meth:`VirtualMac.encode` (big-endian MAC int of
    bytes b0..b5; ranks little-endian int16 at bytes 2-3 / 4-5), produced
    with array ops so a whole collective's F rank pairs encode in one
    shot — the per-pair string form is only materialized where a string
    API needs it (utils.mac.ints_to_macs).
    """
    import numpy as np

    if not 0 <= coll_type < 64:
        raise ValueError(f"coll_type must fit in 6 bits: {coll_type}")
    src = np.asarray(src_ranks, dtype=np.int64) & 0xFFFF
    dst = np.asarray(dst_ranks, dtype=np.int64) & 0xFFFF
    b0 = np.int64(((coll_type << 2) | 0x02) << 40)
    return (
        b0
        | ((src & 0xFF) << 24)  # byte 2: src low
        | ((src >> 8) << 16)  # byte 3: src high
        | ((dst & 0xFF) << 8)  # byte 4: dst low
        | (dst >> 8)  # byte 5: dst high
    )

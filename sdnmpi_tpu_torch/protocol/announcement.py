"""MPI process announcement sideband codec.

Wire format of the UDP:61000 packets a modified MPI runtime broadcasts to
the controller, as defined by the reference with the ``construct`` library
(reference: sdnmpi/protocol/announcement.py:3-18):

    int32 (little-endian)  type   -- 0 = LAUNCH, 1 = EXIT
    int32 (little-endian)  rank   -- union arg; only member is the rank

Total 8 bytes. This is a dependency-free re-implementation with the same
byte layout so existing senders interoperate unchanged.
"""

from __future__ import annotations

import dataclasses
import enum
import struct

_STRUCT = struct.Struct("<ii")

ANNOUNCEMENT_PACKET_LEN = _STRUCT.size  # 8


class AnnouncementType(enum.IntEnum):
    LAUNCH = 0
    EXIT = 1


@dataclasses.dataclass(frozen=True)
class Announcement:
    type: AnnouncementType
    rank: int

    def encode(self) -> bytes:
        return _STRUCT.pack(int(self.type), self.rank)

    @classmethod
    def decode(cls, payload: bytes) -> "Announcement":
        if len(payload) < ANNOUNCEMENT_PACKET_LEN:
            raise ValueError(
                f"announcement packet too short: {len(payload)} < "
                f"{ANNOUNCEMENT_PACKET_LEN}"
            )
        type_raw, rank = _STRUCT.unpack_from(payload)
        return cls(AnnouncementType(type_raw), rank)

"""The yardstick's peaks and the bytes a kernel's call needs.

The peak is NVIDIA's data sheet for the H100 SXM at its 700 W limit. A
roofline share is the least time the bytes of the calls take at the
peak, over the time the profiler saw them take on the card. K2 is bound
by its bytes. Each input byte is counted read once and each output byte
written once.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12  # HBM3


def sampler_bytes(v: int, d: int, links: int, n_dst: int, t: int, f: int,
                  hops: int) -> int:
    """Bytes K2 and its set-up need for one call (the path's set-up then
    the sampler): the ``[v, d]`` int32 topology table and its ``links``
    f32 link weights, the f32 distance columns of the ``n_dst``
    destinations the flows name and the ``t``-entry destination set, read
    once each; the ``f`` flows' int32 sources and destinations read and
    their ``hops`` int8 slots written."""
    flows = 2 * f * 4 + f * hops
    return v * d * 4 + links * 4 + n_dst * v * 4 + t * 4 + flows


def bytes_seconds(n_bytes: float) -> float:
    return n_bytes / PEAK_BYTES_S

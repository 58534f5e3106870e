"""The bounded bucket ladder of the churn plane's dynamic index sets.

Counterpart of ``sdnmpi_tpu/kernels/tiling.py``, two of its three
functions: :func:`col_bucket` and :func:`bucket_pad`, which the
incremental APSP repair (``oracle/incremental.py``) and the utilization
plane (``oracle/utilplane.py``) share. The reference's ``col_block`` is
the TPU's on-chip memory tiling policy and has no counterpart here.

A dirty-column set or a sample batch varies in size from one event to
the next; both are padded to a power-of-two bucket so that the device
work keeps a bounded set of shapes. The pads carry an out-of-range
sentinel: gathers clamp it, and every scatter in the port slices the
pads away before it writes (an out-of-range ``index_put_`` raises on the
CPU and is a device-side assert on the card).
"""

from __future__ import annotations

import numpy as np


def col_bucket(n: int, v: int) -> int:
    """``n`` rounded up to the next power of two (floor 8), capped at
    ``v``: at most ``log2(v/8) + 2`` distinct sizes per ``v``."""
    b = 8
    while b < n:
        b *= 2
    return min(b, v)


def bucket_pad(idx, sentinel: int, cap: int, vals=None):
    """``idx`` (int32) end-padded to its :func:`col_bucket` length (capped
    at ``cap``) with ``sentinel``; with ``vals``, a parallel f32 vector
    zero-padded to the same length. Returns ``(idx, vals or None)``."""
    n = col_bucket(len(idx), cap)
    out = np.full(n, sentinel, dtype=np.int32)
    out[: len(idx)] = idx
    if vals is None:
        return out, None
    v = np.zeros(n, dtype=np.float32)
    v[: len(vals)] = vals
    return out, v

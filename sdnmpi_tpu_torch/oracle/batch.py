"""Array-native result form for whole-collective routing.

The reference resolves one (src, dst) pair per packet-in and returns one
fdb list per query (reference: sdnmpi/topology.py:138-142); scaling that
contract to a 4096-rank alltoall means 16.7M Python list objects before
anything is installed. ``CollectiveRoutes`` is the batched contract:
per-pair state lives in numpy arrays, the actual hop sequences live once
per *sub-flow* (pairs sharing an (edge, edge) transit and an ECMP split
slot share their transit hops), and per-pair fdb lists are materialized
only on demand — the block install path (control/router.py) never
materializes them at all.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def bucket_len(n: int, multiple: int = 8) -> int:
    """Round a batch length up to the bucket the oracle's device entry
    points use (multiple-of-8, floor ``multiple``)."""
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def bucket_pow2(n: int, floor: int = 8) -> int:
    """Round a batch length up to the next power of two (floor 8), the
    coarse bucket tier of workloads whose batch sizes vary freely per
    event (the delta-narrowed churn path pads with it). A
    smaller ``floor`` is honored."""
    out = max(1, floor)
    while out < n:
        out *= 2
    return out


def pad_flow_batch(
    *arrays: np.ndarray, multiple: int = 8, fill: int = -1,
    pow2: bool = False,
) -> tuple[np.ndarray, ...]:
    """End-pad equal-length 1-D index arrays to a shared bucketed length,
    as the reference's device entry points do (its jit cache keys on the
    bucket; here it keeps the flow axis the reference's shape). The fill
    value ``-1`` is the path kernels' "dead flow" marker (masked out of
    walks and reduces); end-padding keeps real rows' positions — and
    therefore their hash streams — unchanged, so callers just trim
    outputs back to the true length. ``pow2`` selects the power-of-two
    tier (:func:`bucket_pow2`).
    """
    n = len(arrays[0])
    padded = bucket_pow2(n, multiple) if pow2 else bucket_len(n, multiple)
    if padded == n:
        return arrays
    out = []
    for a in arrays:
        a = np.asarray(a)
        p = np.full(padded, fill, dtype=a.dtype)
        p[:n] = a
        out.append(p)
    return tuple(out)


class RouteWindow:
    """Handle for one dispatched (possibly still in-flight) route
    window — the split-phase contract of the pipelined install plane.

    The oracle's ``*_dispatch`` entry points enqueue the window's device
    work (torch returns as soon as the kernels are queued on the
    stream) and hand back one of these; :meth:`reap` runs the host-side
    decode and blocks only on THIS window's results, so a caller that
    dispatches window k+1 before reaping window k overlaps k+1's device
    compute with k's host decode. Entry points with no device leg
    (host chase, pure-Python backend, empty batches) return an
    already-completed window; ``reap`` is
    idempotent either way.
    """

    __slots__ = ("_reap", "_result")

    def __init__(self, reap=None, result=None):
        self._reap = reap
        self._result = result

    @property
    def done(self) -> bool:
        return self._reap is None

    def reap(self):
        """Host decode of the dispatched window (blocking; idempotent)."""
        if self._reap is not None:
            self._result = self._reap()
            self._reap = None
        return self._result


@dataclasses.dataclass
class WindowRoutes:
    """One resolved route window in struct-of-arrays form: the reap
    result :class:`RouteWindow` yields for the pair-batch entry points.
    Row k is input pair k: ``hop_len[k] == 0`` marks an
    unroutable/unresolved pair, otherwise ``hop_dpid[k, :hop_len[k]]`` /
    ``hop_port[k, :hop_len[k]]`` are its fdb hops with the final hop's
    port already the destination's attachment port. ``fdbs()`` is the
    list form of the scalar API.
    """

    hop_dpid: np.ndarray  # [F, L] int64, -1 padded
    hop_port: np.ndarray  # [F, L] int32, -1 padded
    hop_len: np.ndarray  # [F] int32 (0 = unroutable)
    #: max discrete link load of the window's chosen paths (balanced)
    max_congestion: float = 0.0
    #: pairs detoured through a Valiant intermediate (adaptive policy)
    n_detours: int = 0
    #: [F] bool, True where the pair's new path crosses a dirtied switch
    #: set; set only by the delta-narrowed entry points,
    #: None everywhere else
    touched: np.ndarray | None = None

    @property
    def n_pairs(self) -> int:
        return self.hop_len.shape[0]

    def fdb(self, k: int) -> list[tuple[int, int]]:
        n = int(self.hop_len[k])
        return [
            (int(self.hop_dpid[k, h]), int(self.hop_port[k, h]))
            for h in range(n)
        ]

    def fdbs(self) -> list[list[tuple[int, int]]]:
        return [self.fdb(k) for k in range(self.n_pairs)]

    def set_fdb(self, k: int, fdb: list[tuple[int, int]]) -> None:
        """Overlay one pair's fdb list onto the arrays; the hop axis grows
        when the list outruns it."""
        need = len(fdb)
        f, l = self.hop_dpid.shape
        if need > l:
            grow_d = np.full((f, need), -1, self.hop_dpid.dtype)
            grow_p = np.full((f, need), -1, self.hop_port.dtype)
            grow_d[:, :l] = self.hop_dpid
            grow_p[:, :l] = self.hop_port
            self.hop_dpid, self.hop_port = grow_d, grow_p
        self.hop_len[k] = need
        for h, (dpid, port) in enumerate(fdb):
            self.hop_dpid[k, h] = dpid
            self.hop_port[k, h] = port

    @classmethod
    def from_fdbs(
        cls, fdbs: list[list[tuple[int, int]]], max_congestion: float = 0.0,
        n_detours: int = 0,
    ) -> "WindowRoutes":
        """Array form of a list-of-fdb-lists result (host chase, py
        backend)."""
        f = len(fdbs)
        l = max((len(fdb) for fdb in fdbs), default=0) or 1
        out = cls(
            np.full((f, l), -1, np.int64),
            np.full((f, l), -1, np.int32),
            np.zeros(f, np.int32),
            max_congestion=max_congestion,
            n_detours=n_detours,
        )
        for k, fdb in enumerate(fdbs):
            if fdb:
                out.set_fdb(k, fdb)
        return out


@dataclasses.dataclass
class CollectiveRoutes:
    """Routes for an F-pair collective, S sub-flows, paths up to L hops.

    ``pair_sub[k]`` is pair k's sub-flow id (-1 = unresolved endpoint);
    a pair is *routed* iff ``pair_sub[k] >= 0 and
    hop_len[pair_sub[k]] > 0``. Sub-flow hop arrays hold the transit
    switch sequence; the final switch's out-port is per *pair*
    (``final_port`` — the destination host's attachment port), not per
    sub-flow, so ``hop_port[s, hop_len[s]-1]`` is a placeholder (-1).
    """

    pair_sub: np.ndarray  # [F] int32
    final_port: np.ndarray  # [F] int32
    hop_dpid: np.ndarray  # [S, L] int64, -1 padded
    hop_port: np.ndarray  # [S, L] int32, -1 padded
    hop_len: np.ndarray  # [S] int32 (0 = unroutable sub-flow)
    #: max discrete link load of the routed pairs (1 per pair per link)
    max_congestion: float = 0.0
    #: pairs whose route takes a UGAL/Valiant detour (adaptive policy)
    n_detours: int = 0
    #: [N] int32 final out-port per *endpoint* (the LUT ``final_port``
    #: was gathered from; -1 = unresolved) — the block install path
    #: feeds this to the native member scatter instead of re-deriving
    #: per-pair ports
    endpoint_port: np.ndarray | None = None

    @property
    def n_pairs(self) -> int:
        return self.pair_sub.shape[0]

    @property
    def n_subflows(self) -> int:
        return self.hop_len.shape[0]

    def routed_mask(self) -> np.ndarray:
        """[F] bool: pairs that have an installable route."""
        sub = self.pair_sub
        ok = sub >= 0
        out = np.zeros(sub.shape[0], dtype=bool)
        out[ok] = self.hop_len[sub[ok]] > 0
        return out

    def fdb(self, k: int) -> list[tuple[int, int]]:
        """Materialize pair k's ``[(dpid, out_port)]`` fdb ([] if unrouted)."""
        s = int(self.pair_sub[k])
        if s < 0:
            return []
        n = int(self.hop_len[s])
        if n == 0:
            return []
        hops = [
            (int(self.hop_dpid[s, h]), int(self.hop_port[s, h]))
            for h in range(n - 1)
        ]
        hops.append((int(self.hop_dpid[s, n - 1]), int(self.final_port[k])))
        return hops

    def fdbs(self) -> list[list[tuple[int, int]]]:
        """All per-pair fdbs (O(F) — compat shim for the list-based API)."""
        return [self.fdb(k) for k in range(self.n_pairs)]

"""Bookkeeping for proactively block-installed collectives.

The per-pair SwitchFDB (core/switch_fdb.py) records reactive installs at
(dpid, src, dst) granularity, as the reference does (reference:
sdnmpi/util/switch_fdb.py:1-32). Block installs of whole collectives are
tracked here instead, at collective granularity: one record per install
carrying the compressed pair arrays (macs + index arrays), so topology
changes can re-route the entire collective in one oracle call and
process exits can tear it down by cookie — per-pair dicts at 16.7M pairs
would defeat the point of the array-native path.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Optional


@dataclasses.dataclass
class CollectiveInstall:
    """One block-installed collective (identified by ``cookie``)."""

    cookie: int
    coll_type: int
    ranks: tuple[int, ...]
    root: Optional[int]
    policy: str
    macs: list  # [N] endpoint MAC strings (rank order)
    src_idx: "object"  # [F] int array into macs
    dst_idx: "object"
    n_pairs: int = 0
    n_flows: int = 0  # switch-level flow entries across all blocks
    max_congestion: float = 0.0
    #: dpids the install's routed blocks actually ride — the dirty-set
    #: index of delta-narrowed revalidation (control/router.py): a link
    #: flap re-routes a collective only when a dirtied switch is in
    #: here. Empty = unknown (pre-index installs) -> always re-route.
    switches: frozenset = frozenset()
    #: directed (src_dpid, dst_dpid) links the routed blocks ride —
    #: the congestion-analytics attribution index: a hot
    #: link's load is attributed to exactly the collectives whose
    #: installed blocks traverse it. Empty = unknown.
    links: frozenset = frozenset()
    #: phase count of a scheduled install's phased flow program
    #:; 0 = flat single-shot install
    n_phases: int = 0
    #: directed link -> sorted tuple of phase ids whose routed blocks
    #: ride it — the phase-grain attribution index: a hot
    #: link resolves not just to the collective but to the PHASE(S)
    #: riding it. None for flat installs.
    phase_links: "object" = None
    #: [(phase id, [N, 3] int array of (dpid, src key, dst key)), ...]
    #: — the exact switch rows each installed phase put on the wire
    #: (install order), kept as MAC-key arrays (a flagship program holds
    #: millions of rows; string tuples would cost ~10x the memory). The
    #: MAC strings re-materialize at teardown (router._mac_rows); the
    #: chaos tests assert installed == desired against them per phase.
    #: None for flat installs.
    phase_rows: "object" = None

    @property
    def signature(self) -> tuple:
        return (self.coll_type, self.root, self.ranks)


class CollectiveTable:
    def __init__(self) -> None:
        self.installs: dict[int, CollectiveInstall] = {}
        self._by_signature: dict[tuple, int] = {}
        self._cookies = itertools.count(1)

    def next_cookie(self) -> int:
        return next(self._cookies)

    def add(self, install: CollectiveInstall) -> None:
        self.installs[install.cookie] = install
        self._by_signature[install.signature] = install.cookie

    def get_by_signature(self, signature: tuple) -> Optional[CollectiveInstall]:
        cookie = self._by_signature.get(signature)
        return self.installs.get(cookie) if cookie is not None else None

    def remove(self, cookie: int) -> Optional[CollectiveInstall]:
        install = self.installs.pop(cookie, None)
        if install is not None:
            self._by_signature.pop(install.signature, None)
        return install

    def with_rank(self, rank: int) -> list[CollectiveInstall]:
        return [i for i in self.installs.values() if rank in i.ranks]

    def __iter__(self) -> Iterator[CollectiveInstall]:
        return iter(list(self.installs.values()))

    def __len__(self) -> int:
        return len(self.installs)

    def to_dict(self) -> dict:
        """Summary for the RPC mirror (counts, never per-pair rows)."""
        return {
            str(i.cookie): {
                "coll_type": i.coll_type,
                "n_ranks": len(i.ranks),
                "n_pairs": i.n_pairs,
                "n_flows": i.n_flows,
                "policy": i.policy,
                "max_congestion": i.max_congestion,
            }
            for i in self.installs.values()
        }

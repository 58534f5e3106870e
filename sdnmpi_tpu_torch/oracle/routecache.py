"""Memoized route cache — the serving plane's fast path.

Counterpart of ``sdnmpi_tpu/oracle/routecache.py``, host code copied
with its imports rewritten. :meth:`RouteCache.topology_digest` gives
the reference's string for the same fabric, so a checkpoint written by
either package restores into the other.

Production MPI fleets re-issue the *same* collectives against a
slowly-changing fabric, which makes route memoization the dominant
serving win (the incremental-reuse argument of DeltaPath, arxiv
1808.06893): a repeated route window or collective request should hit a
dict, not the oracle's device pipeline.

One :class:`RouteCache` sits in front of the oracle inside
``TopologyDB`` (``find_routes_batch_dispatch`` /
``find_routes_collective``), keyed by

    (kind, policy, UtilPlane epoch, pair-set digest, policy-knob digest)

with the **topology version deliberately outside the key**: instead of
missing on every fabric mutation, the cache *invalidates through the
TopologyDB delta log* (:meth:`sync`), so a link flap evicts only the
entries whose stored routes actually rode the deleted link — the same
delete-narrowing soundness argument the delta revalidation pass proves
(control/router.py ``_reval_dirty_set``: a pair's chosen shortest path
changes under a delete only if it rode the deleted link). Deltas the
narrowing cannot cover soundly (link adds re-optimize globally; host /
switch membership moves endpoint resolution; a broken/overflowed log)
clear the cache — conservative, never stale. Utilization-seeded results
(balanced / adaptive / collective) additionally carry the UtilPlane
epoch in their key and are dropped on ANY topology delta: their choice
depends on the whole DAG plus measured loads, so no per-entry narrowing
is sound for them.

A hit returns the stored, already-reaped result — the caller gets a
completed :class:`~sdnmpi_tpu_torch.oracle.batch.RouteWindow` and the install
plane consumes the struct arrays exactly as it would a fresh reap, so
hit and miss are bit-identical by construction (the stored object IS a
prior miss's reap). Stored arrays are treated as immutable by every
consumer (the Router's window installer only reads them).

Observability rides the metrics and tracing plane: ``route_cache_hits_total`` /
``route_cache_misses_total`` / ``route_cache_evictions_total`` /
``route_cache_entries``, and each hit emits a ``route_cache_hit`` child
span under the ambient request span so flight-recorder bundles show
hit-vs-miss serve paths.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Optional

import numpy as np

from sdnmpi_tpu_torch.utils.metrics import REGISTRY
from sdnmpi_tpu_torch.utils.tracing import start_child_span

#: format version of the serialized memo (api/snapshot rides it beside
#: the compile cache); restores refuse any other value
ROUTE_CACHE_SNAPSHOT_VERSION = 1

_m_hits = REGISTRY.counter(
    "route_cache_hits_total",
    "route window / collective requests served from the memo cache "
    "(no oracle dispatch)",
)
_m_misses = REGISTRY.counter(
    "route_cache_misses_total",
    "cacheable requests that had to run the oracle",
)
_m_evictions = REGISTRY.counter(
    "route_cache_evictions_total",
    "entries dropped: LRU capacity plus delta-log invalidation",
)
_m_entries = REGISTRY.gauge(
    "route_cache_entries", "live route-cache entries right now"
)


def _digest(parts) -> bytes:
    """Stable 16-byte digest of an iterable of strings/ints/bytes —
    compact keys for arbitrarily large pair sets (a 4096-pair window's
    key must not retain 8192 MAC strings per entry). One join + one
    hash update: the digest runs on EVERY cacheable request, hit or
    miss, so per-part update calls would tax the ~100 us hit path the
    cache exists to provide."""
    return hashlib.blake2b(
        b"\x1f".join(
            p if isinstance(p, bytes) else str(p).encode() for p in parts
        ),
        digest_size=16,
    ).digest()


class _Entry:
    __slots__ = ("result", "riders", "util_keyed")

    def __init__(self, result, riders: frozenset, util_keyed: bool):
        self.result = result
        #: dpids the stored routes ride — the link-delete narrowing index
        self.riders = riders
        #: True for balanced/adaptive/collective results: invalidated on
        #: ANY topology delta (no per-entry narrowing is sound for them)
        self.util_keyed = util_keyed


class RouteCache:
    """LRU memo of reaped route results, delta-log invalidated."""

    def __init__(self, max_entries: int = 4096) -> None:
        self.max_entries = max(1, int(max_entries))
        self._lru: OrderedDict[tuple, _Entry] = OrderedDict()
        #: TopologyDB version the cache last synced to (None = never)
        self._version: Optional[int] = None

    def __len__(self) -> int:
        return len(self._lru)

    # -- invalidation (the delta-log seam) --------------------------------

    def sync(self, db) -> None:
        """Absorb the TopologyDB's mutations since the last sync.

        Pure link deletes narrow: only entries whose stored routes ride
        a deleted link's endpoints are evicted (plus every util-keyed
        entry — see module docstring). Any other delta kind — and a log
        that no longer covers the gap — clears the cache: correctness
        over reuse, exactly the reval pass's narrowing rules."""
        version = db.version
        if self._version is None:
            self._version = version
            return
        if version == self._version:
            return
        deltas_since = getattr(db, "deltas_since", None)
        deltas = deltas_since(self._version) if deltas_since else None
        self._version = version
        if not deltas:
            # no basis (broken/overflowed log, or a duck-typed DB whose
            # log does not cover the gap): correctness over reuse
            self._clear()
            return
        # the ONE copy of the delta-narrowing kind rules (shared with
        # the Router's delta-narrowed revalidation — see its docstring
        # for the soundness proofs): None = some delta defeats
        # narrowing. The PodMap + live-border pair arms the
        # intra-pod link-ADD narrowing (an interior add evicts only
        # that pod's riders); without an annotation, adds clear.
        from sdnmpi_tpu_torch.core.topology_db import narrowed_dirty_set

        dirty = narrowed_dirty_set(
            deltas, getattr(db, "podmap", None),
            db if hasattr(db, "live_border_set") else None,
        )
        if dirty is None:
            self._clear()
            return
        doomed = [
            key for key, e in self._lru.items()
            if e.util_keyed or not dirty.isdisjoint(e.riders)
        ]
        for key in doomed:
            del self._lru[key]
        if doomed:
            _m_evictions.inc(len(doomed))
            _m_entries.set(len(self._lru))

    def _clear(self) -> None:
        if self._lru:
            _m_evictions.inc(len(self._lru))
            self._lru.clear()
            _m_entries.set(0.0)

    # -- keys --------------------------------------------------------------

    @staticmethod
    def _util_epoch(link_util) -> Optional[int]:
        """Cache-key epoch of a utilization input: 0 for no measured
        load (None / empty dict — the idle-fabric base is deterministic),
        the published epoch for a device UtilPlane, and None —
        *uncacheable* — for a non-empty host dict (no epoch discipline
        to key on) OR a UtilPlane holding staged-but-unflushed samples:
        an uncached dispatch flushes those into a NEW epoch and routes
        on them (engine._normalized_base), so hitting on the pre-flush
        epoch would serve pre-sample routes and break hit == miss."""
        if not link_util:
            return 0
        epoch = getattr(link_util, "epoch", None)
        if epoch is None:
            return None  # raw host dict with live samples: no epoch
        if getattr(link_util, "has_staged", False):
            return None  # mid-pass: the next dispatch will re-epoch
        return int(epoch)

    def window_key(
        self, pairs, policy: str, link_util, kwargs: dict
    ) -> Optional[tuple]:
        """Key for a batch route window, or None when uncacheable."""
        if policy == "shortest":
            epoch = 0  # shortest paths never read utilization
        else:
            epoch = self._util_epoch(link_util)
            if epoch is None:
                return None
        knobs = _digest(
            f"{k}={v!r}" for k, v in sorted(kwargs.items())
            if k != "link_util"
        )
        return (
            "window", policy, epoch,
            _digest(f"{s}>{d}" for s, d in pairs), knobs,
        )

    def collective_key(
        self, macs, src_idx, dst_idx, policy: str, link_util, kwargs: dict
    ) -> Optional[tuple]:
        """Key for a whole-collective request, or None when uncacheable."""
        if policy == "shortest":
            # deterministic next-hop paths never read utilization: a
            # live epoch in the key would miss the identical re-issued
            # collective on every Monitor pass for nothing (same rule
            # as window_key)
            epoch = 0
        else:
            epoch = self._util_epoch(link_util)
            if epoch is None:
                return None
        knobs = _digest(
            f"{k}={v!r}" for k, v in sorted(kwargs.items())
            if k != "link_util"
        )
        pair_bytes = (
            np.ascontiguousarray(src_idx, np.int32).tobytes()
            + np.ascontiguousarray(dst_idx, np.int32).tobytes()
        )
        return (
            "collective", policy, epoch,
            _digest(list(macs) + [pair_bytes]), knobs,
        )

    # -- lookup / store ----------------------------------------------------

    def lookup(self, key: tuple):
        """The stored result for ``key`` (hit: LRU-touched, counted,
        spanned) or None (miss counted)."""
        e = self._lru.get(key)
        if e is None:
            _m_misses.inc()
            return None
        self._lru.move_to_end(key)
        _m_hits.inc()
        # the hit's own span stage: flight-recorder bundles distinguish
        # cache-served requests from oracle-dispatched ones
        sp = start_child_span("route_cache_hit", entry=key[0], policy=key[1])
        sp.end()
        return e.result

    def store(self, key: tuple, result, hop_dpid) -> Any:
        """Memoize a reaped result (returns it, for reap-wrapper use).

        ``hop_dpid`` is the result's hop array — the ridden-switch set
        becomes the entry's link-delete narrowing index. A result
        computed before a mutation that raced its reap is dropped
        (store only when the cache is still synced to the version the
        dispatch keyed under — the caller syncs before dispatch)."""
        hops = np.asarray(hop_dpid)
        riders = frozenset(int(d) for d in np.unique(hops[hops >= 0]))
        self._lru[key] = _Entry(result, riders, key[1] != "shortest")
        self._lru.move_to_end(key)
        while len(self._lru) > self.max_entries:
            self._lru.popitem(last=False)
            _m_evictions.inc()
        _m_entries.set(len(self._lru))
        return result

    # -- restart persistence --------------------------

    @staticmethod
    def topology_digest(db) -> str:
        """Canonical digest of the routed graph (sorted switches,
        directed links with ports, host attachments) — the restore
        guard: a memo snapshot only applies to the EXACT fabric it was
        taken on. Sorted forms, so dict insertion order (which differs
        between a discovered and a restored controller) cannot flip
        the digest."""
        h = hashlib.blake2b(digest_size=16)
        for dpid in sorted(db.switches):
            h.update(b"s%d" % dpid)
        links = sorted(
            (src, dst, link.src.port_no)
            for src, dst_map in db.links.items()
            for dst, link in dst_map.items()
        )
        for src, dst, port in links:
            h.update(b"l%d>%d:%d" % (src, dst, port))
        for mac in sorted(db.hosts):
            host = db.hosts[mac]
            h.update(
                f"h{mac}@{host.port.dpid}:{host.port.port_no}".encode()
            )
        return h.hexdigest()

    def snapshot_entries(self, db) -> dict:
        """Serializable form of the SURVIVING entries — the shortest-
        policy memo only. Utilization-keyed entries (balanced /
        adaptive / collective with a live epoch) are deliberately
        dropped: UtilPlane epochs restart from zero, so a restored
        epoch-N key would collide with a fresh epoch N carrying
        different measured loads and break hit == miss. Version-
        guarded (format + topology digest) on restore."""
        from sdnmpi_tpu_torch.oracle.batch import WindowRoutes

        # settle pending deltas FIRST: the digest below describes the
        # CURRENT graph, so serializing entries still awaiting
        # invalidation would stamp stale routes with a digest a
        # restarted controller legitimately matches (review
        # regression: a deleted link's rider served as a post-restore
        # hit)
        self.sync(db)
        entries = []
        for key, e in self._lru.items():
            if e.util_keyed:
                continue
            r = e.result
            if isinstance(r, WindowRoutes):
                if r.touched is not None:
                    continue  # delta-narrowed windows are churn-local
                payload = {
                    "kind": "window",
                    "hop_dpid": r.hop_dpid.tolist(),
                    "hop_port": r.hop_port.tolist(),
                    "hop_len": r.hop_len.tolist(),
                    "max_congestion": float(r.max_congestion),
                    "n_detours": int(r.n_detours),
                }
            else:  # CollectiveRoutes
                payload = {
                    "kind": "collective",
                    "pair_sub": r.pair_sub.tolist(),
                    "final_port": r.final_port.tolist(),
                    "hop_dpid": r.hop_dpid.tolist(),
                    "hop_port": r.hop_port.tolist(),
                    "hop_len": r.hop_len.tolist(),
                    "max_congestion": float(r.max_congestion),
                    "n_detours": int(r.n_detours),
                    "endpoint_port": (
                        None if r.endpoint_port is None
                        else r.endpoint_port.tolist()
                    ),
                }
            entries.append({
                "key": [
                    p.hex() if isinstance(p, bytes) else p for p in key
                ],
                "key_bytes": [
                    i for i, p in enumerate(key) if isinstance(p, bytes)
                ],
                "riders": sorted(e.riders),
                "result": payload,
            })
        return {
            "version": ROUTE_CACHE_SNAPSHOT_VERSION,
            "topology_digest": self.topology_digest(db),
            "entries": entries,
        }

    def restore_entries(self, snapshot: dict, db) -> int:
        """Re-seed the memo from :meth:`snapshot_entries` output.
        Returns the number of entries restored; 0 — never an error —
        when the format version or the topology digest does not match
        the LIVE fabric (a restarted controller that discovered a
        different network must not serve the old one's routes)."""
        from sdnmpi_tpu_torch.oracle.batch import CollectiveRoutes, WindowRoutes

        # entries already LIVE in this cache may have pending un-synced
        # deltas (restore_controller itself mutates the db — host adds
        # — right before calling here); settle them through the normal
        # invalidation sweep FIRST, before any guard can return and
        # before the restore rebases the version — or their eviction
        # would silently be skipped
        self.sync(db)
        if snapshot.get("version") != ROUTE_CACHE_SNAPSHOT_VERSION:
            return 0
        if snapshot.get("topology_digest") != self.topology_digest(db):
            return 0
        restored = 0
        for item in snapshot.get("entries", []):
            byte_slots = set(item.get("key_bytes", []))
            key = tuple(
                bytes.fromhex(p) if i in byte_slots else
                (tuple(p) if isinstance(p, list) else p)
                for i, p in enumerate(item["key"])
            )
            payload = item["result"]
            hop_dpid = np.asarray(payload["hop_dpid"], np.int64)
            hop_port = np.asarray(payload["hop_port"], np.int32)
            hop_len = np.asarray(payload["hop_len"], np.int32)
            if payload["kind"] == "window":
                result: Any = WindowRoutes(
                    hop_dpid, hop_port, hop_len,
                    max_congestion=payload["max_congestion"],
                    n_detours=payload["n_detours"],
                )
            else:
                ep = payload.get("endpoint_port")
                result = CollectiveRoutes(
                    np.asarray(payload["pair_sub"], np.int32),
                    np.asarray(payload["final_port"], np.int32),
                    hop_dpid, hop_port, hop_len,
                    max_congestion=payload["max_congestion"],
                    n_detours=payload["n_detours"],
                    endpoint_port=(
                        None if ep is None else np.asarray(ep, np.int32)
                    ),
                )
            self._lru[key] = _Entry(
                result, frozenset(item.get("riders", [])), False
            )
            self._lru.move_to_end(key)
            restored += 1
        while len(self._lru) > self.max_entries:
            self._lru.popitem(last=False)
        if restored:
            _m_entries.set(len(self._lru))
            # baseline the delta sync at the live version: the digest
            # match proves the graph is the snapshot's graph
            self._version = db.version
        return restored

    def store_window(self, key: tuple, window, version: int):
        """Wrap a dispatched :class:`RouteWindow` so its reap lands in
        the cache (already-completed windows store eagerly). ``version``
        is the TopologyDB version the dispatch keyed under: a reap that
        lands after further mutations is served to its caller but NOT
        memoized (its key would lie about the fabric it was computed
        on)."""
        from sdnmpi_tpu_torch.oracle.batch import RouteWindow

        def _landed(wr):
            if self._version == version:
                self.store(key, wr, wr.hop_dpid)
            return wr

        if window.done:
            return RouteWindow(result=_landed(window.reap()))
        return RouteWindow(reap=lambda: _landed(window.reap()))

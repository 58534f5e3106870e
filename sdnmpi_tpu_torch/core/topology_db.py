"""Topology store and routing facade.

Counterpart of ``sdnmpi_tpu/core/topology_db.py``: dictionaries of
switches (dpid -> switch), directed links (src dpid -> dst dpid -> link)
and hosts (MAC -> host), plus ``find_route(src_mac, dst_mac)`` returning
an "fdb" — a list of ``(dpid, out_port)`` hops — the pair-batch APIs
(``find_routes_batch``, ``find_routes_batch_dispatch``,
``find_routes_batch_balanced``, ``find_routes_batch_adaptive``) and the
array-native ``find_routes_collective``.

The path computation is pluggable: ``backend="torch"`` (the default)
routes through the torch oracle (``oracle/engine.py``) on ``device``,
which is ``"cuda"`` unless the caller asks for the CPU; asking for CUDA
without a card raises. ``backend="py"`` is a pure-Python BFS whose
semantics match the oracle exactly (lowest-dpid tie-break), the
differential oracle of the tests. Mutations bump a version counter so
the oracle caches device tensors until the topology changes, and each
mutation is logged as a delta (``deltas_since``) that the control
plane's revalidation reads through :func:`narrowed_dirty_set`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from sdnmpi_tpu_torch.protocol.openflow import OFPP_LOCAL
from sdnmpi_tpu_torch.utils.mac import mac_to_int
from sdnmpi_tpu_torch.utils.metrics import REGISTRY

_BACKENDS = ("torch", "py")

_m_log_breaks = REGISTRY.counter(
    "topology_delta_log_breaks_total",
    "delta-log breaks (structural mutations forcing full recomputes)",
)


@dataclasses.dataclass(frozen=True)
class Port:
    dpid: int
    port_no: int

    def to_dict(self) -> dict:
        return {"dpid": self.dpid, "port_no": self.port_no}


@dataclasses.dataclass(frozen=True)
class Host:
    mac: str
    port: Port

    def to_dict(self) -> dict:
        return {"mac": self.mac, "port": _entity_dict(self.port)}


@dataclasses.dataclass(frozen=True)
class Link:
    src: Port
    dst: Port

    def to_dict(self) -> dict:
        return {"src": _entity_dict(self.src), "dst": _entity_dict(self.dst)}


@dataclasses.dataclass
class _Datapath:
    id: int


@dataclasses.dataclass
class Switch:
    """Switch entity. ``dp.id`` is the dpid, matching the Ryu attribute
    the reference reads (sdnmpi/util/topology_db.py:24)."""

    dp: _Datapath
    ports: list[Port] = dataclasses.field(default_factory=list)

    @classmethod
    def make(cls, dpid: int, ports: Optional[list[Port]] = None) -> "Switch":
        return cls(_Datapath(dpid), ports or [])

    def to_dict(self) -> dict:
        return {"dpid": self.dp.id, "ports": [_entity_dict(p) for p in self.ports]}


def _entity_dict(obj: Any) -> Any:
    """Best-effort JSON form for our dataclasses or duck-typed stand-ins."""
    to_dict = getattr(obj, "to_dict", None)
    if callable(to_dict):
        return to_dict()
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    out = {}
    for attr in ("dpid", "port_no", "mac", "dp", "src", "dst", "port"):
        if hasattr(obj, attr):
            value = getattr(obj, attr)
            out[attr] = value if isinstance(value, (int, str)) else _entity_dict(value)
    return out


def narrowed_dirty_set(deltas, podmap=None, db=None) -> Optional[set]:
    """The delta-narrowing rules, in ONE place .

    Given :meth:`TopologyDB.deltas_since` entries, returns the dirtied
    dpid set when every delta is individually narrowable, or None when
    ANY delta kind defeats narrowing. The rules:

    - ``link-`` narrows to its endpoint dpids. Soundness: a pair's
      chosen shortest path changes under a delete only if it rode the
      deleted link, so its hops contain both endpoints.
    - ``switch_upsert`` (a port-set refresh of a known dpid) never
      changes the routed graph and is ignorable.
    - ``link+`` normally defeats narrowing — a restored cable can
      shorten flows whose current detour avoids both endpoints (the
      torus counterexample). EXCEPT when the topology
      carries a :class:`~sdnmpi_tpu_torch.topogen.podmap.PodMap` whose
      generator certified ``intra_add_narrows``, BOTH endpoints are
      *interior* (non-border) switches of ONE pod, AND every live
      border pair of that pod is currently within in-pod distance 2
      (:func:`_pod_borders_within_two`), the add narrows to that pod's
      member set. Soundness, in two steps. (1) An interior add cannot
      change any border-pair in-pod distance that is currently <= 2:
      every new path between borders via the added link spends >= 1
      hop reaching the first interior endpoint and >= 1 hop returning
      from the second, so it has length >= 3. The <= 2 precondition is
      checked LIVE — it holds for pristine fat-tree pods (every agg
      pair meets through every edge switch) and dragonfly groups
      (complete), exactly the structural facts the generators certify,
      and it automatically FAILS (falling back to the clear) once
      intra-pod deletes degrade the pod, where an interior add really
      can restore a border-to-border transit (e.g. a pod whose two
      agg-edge diagonals were cut: an edge-edge add revives the
      agg->agg path at length 3). (2) With every border-to-border
      transit cost through the pod unchanged, any pair with both
      endpoints OUTSIDE the pod is unaffected — its shortest distance
      decomposes at the pod's borders. Any pair a shorter path COULD
      reach has an endpoint inside the pod, and its installed route
      necessarily rides its own endpoint switch, a pod member, so the
      pod-member dirty set always covers it. Border membership is
      evaluated against the CURRENT link set, which only
      over-approximates the pre-add borders — over-approximation can
      only force MORE adds down the clear path, never unsound
      narrowing. Unannotated fabrics and partitioner-recovered maps
      (``intra_add_narrows=False``) keep the always-sound clear.
    - host / switch membership deltas move endpoint resolution in ways
      installed hop sets cannot express: never narrowable.

    All consumers — the Router's delta-narrowed revalidation
    (control/router.py) and the route cache's invalidation sweep
    (oracle/routecache.py) — share this helper so the proofs cannot
    drift between them. ``podmap`` is the TopologyDB's annotation (or
    None) and ``db`` the live TopologyDB — borders and the <= 2
    precondition are properties of the CURRENT links, not the
    annotation, and are only computed when a link+ delta actually
    needs them. Callers that cannot supply both keep the stricter
    rules."""
    dirty: set = set()
    members_of: Optional[list] = None
    borders: Optional[set] = None
    for entry in deltas:
        kind = entry[1]
        if kind == "link-":
            dirty.add(entry[2])
            dirty.add(entry[3])
        elif (
            kind == "link+"
            and podmap is not None
            and db is not None
            and getattr(podmap, "intra_add_narrows", False)
        ):
            a, b = entry[2], entry[3]
            pa = podmap.pod_of.get(a)
            if pa is None or podmap.pod_of.get(b) != pa:
                return None  # inter-pod or unmapped add: clear
            if borders is None:
                borders = db.live_border_set()
            if a in borders or b in borders:
                return None  # a border endpoint: no structural cert
            if members_of is None:
                members_of = podmap.members()
            members = members_of[pa]
            if not _pod_borders_within_two(db, members, borders):
                return None  # a degraded pod: the cert's premise fell
            dirty.update(members)
        elif kind != "switch_upsert":
            return None
    return dirty


def _pod_borders_within_two(db, members, borders) -> bool:
    """The live precondition of the intra-pod add narrowing: every
    ordered pair of the pod's borders is within IN-POD distance 2
    (direct link, or a shared pod-member relay, checked per direction
    — the graph discipline is symmetric cables, but staying
    directed-safe costs nothing). See ``narrowed_dirty_set`` step (1)
    for why <= 2 is the exact threshold an interior add cannot
    touch."""
    pod_set = set(members)
    bs = sorted(d for d in members if d in borders)
    out_nb = {
        x: {n for n in db.links.get(x, ()) if n in pod_set} for x in bs
    }
    in_nb = {
        y: {z for z in pod_set if y in db.links.get(z, ())} for y in bs
    }
    for x in bs:
        for y in bs:
            if x == y or y in out_nb[x]:
                continue
            if out_nb[x].isdisjoint(in_nb[y]):
                return False
    return True


#: delta-log depth: enough to cover any burst the oracle would repair
#: incrementally (Config.delta_repair_threshold plus the switch-upsert
#: chatter cabling changes produce) with a wide margin; overflow just
#: advances the floor, forcing the next refresh down the full path
_DELTA_LOG_CAP = 64


class TopologyDB:
    def __init__(
        self,
        backend: str = "torch",
        pad_multiple: int = 8,
        max_diameter: int = 0,
        device="cuda",
        mesh_devices: int = 0,
        shard_oracle: bool = False,
        ring_exchange: bool = False,
        delta_repair_threshold: Optional[int] = None,
        route_cache: bool = False,
        route_cache_max_entries: int = 4096,
        hier_oracle: bool = False,
        hier_pod_target: int = 0,
        hier_fused: bool = True,
        hier_warm: bool = True,
    ) -> None:
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
        # dpid -> switch entity
        self.switches: dict[int, Any] = {}
        # src dpid -> dst dpid -> link entity (directed; the discovery layer
        # adds both directions)
        self.links: dict[int, dict[int, Any]] = {}
        # MAC -> host entity
        self.hosts: dict[str, Any] = {}
        self.backend = backend
        self.pad_multiple = pad_multiple
        self.max_diameter = max_diameter
        self.device = device
        #: shards of the oracle's mesh (0 = one device), the full
        #: shardplane refresh, and the ring exchange on its legs; the
        #: oracle's rules apply (oracle/engine.RouteOracle)
        self.mesh_devices = mesh_devices
        self.shard_oracle = shard_oracle
        self.ring_exchange = ring_exchange
        #: the hierarchical two-level oracle (oracle/hier.py): dense
        #: per-pod blocks + a border skeleton replace the dense [V, V]
        #: planes. Only meaningful on the torch backend.
        self.hier_oracle = hier_oracle
        #: partitioner pod-size target when the topology carries no
        #: PodMap annotation (0 = ~sqrt(V) auto)
        self.hier_pod_target = hier_pod_target
        #: fused hier composition + batched hop walk; False is the
        #: bit-identical scalar escape hatch
        self.hier_fused = hier_fused
        #: run the hier pow2 program ladder during warm_serving
        self.hier_warm = hier_warm
        if backend == "torch":
            from sdnmpi_tpu_torch.oracle.engine import resolve_device

            self.device = resolve_device(device)
        #: pod structure annotation (topogen/podmap.py), set by
        #: TopoSpec.to_topology_db for generator fabrics
        self.podmap = None
        #: max link deltas the oracle absorbs by in-place repair
        #: (oracle/incremental.py) before a full recompute; None keeps
        #: the oracle's default
        self.delta_repair_threshold = delta_repair_threshold
        #: memoized route cache (oracle/routecache.py): reaped route
        #: windows and collective results served straight from the memo
        #: on a repeat request, invalidated through this DB's own delta
        #: log. None = off (the uncached dispatch path). Works on both
        #: backends.
        self.route_cache = None
        if route_cache:
            from sdnmpi_tpu_torch.oracle.routecache import RouteCache

            self.route_cache = RouteCache(route_cache_max_entries)
        self._version = 0
        self._oracle = None  # lazily-created torch oracle (oracle/engine.py)
        #: epoch + dirty-set log: one entry per version bump,
        #: ``(version, kind, ...)`` — see :meth:`deltas_since`.
        #: Structural mutations (switch deletion) break the log instead.
        self._delta_log: list[tuple] = []
        #: deltas at versions <= the floor are unknown (pre-history,
        #: log overflow, or a structural break)
        self._delta_floor = 0

    # -- mutators (reference: sdnmpi/util/topology_db.py:20-42) ----------

    def _log_delta(self, *entry) -> None:
        self._delta_log.append((self._version, *entry))
        if len(self._delta_log) > _DELTA_LOG_CAP:
            self._delta_floor = self._delta_log.pop(0)[0]

    def _break_deltas(self) -> None:
        self._delta_log.clear()
        self._delta_floor = self._version
        # structural mutation the repair path cannot express: every
        # oracle/utilplane consumer falls back to its full path
        _m_log_breaks.inc()

    def add_host(self, host: Any) -> None:
        self.hosts[host.mac] = host
        self._version += 1
        self._log_delta("host", host.port.dpid)

    def delete_host(self, mac: str) -> None:
        host = self.hosts.pop(mac, None)
        if host is not None:
            self._version += 1
            self._log_delta("host", host.port.dpid)

    def add_switch(self, switch: Any) -> None:
        known = switch.dp.id in self.switches
        self.switches[switch.dp.id] = switch
        self._version += 1
        # an upsert (port-set refresh of a known dpid — what every
        # cabling change produces via EventPortAdd) never changes the
        # routed graph; a genuinely new switch may grow the node set
        self._log_delta(
            "switch_upsert" if known else "switch_new", switch.dp.id
        )

    def delete_switch(self, switch: Any) -> None:
        if switch.dp.id in self.switches:
            del self.switches[switch.dp.id]
            self._version += 1
            self._break_deltas()  # node set may shrink: full recompute

    def add_link(self, link: Any) -> None:
        self.links.setdefault(link.src.dpid, {})[link.dst.dpid] = link
        self._version += 1
        self._log_delta(
            "link+", link.src.dpid, link.dst.dpid, link.src.port_no
        )

    def delete_link(self, link: Any) -> None:
        dst_map = self.links.get(link.src.dpid)
        if dst_map and link.dst.dpid in dst_map:
            del dst_map[link.dst.dpid]
            self._version += 1
            self._log_delta("link-", link.src.dpid, link.dst.dpid)

    @property
    def version(self) -> int:
        """Bumped on every mutation; oracle caches are keyed on this."""
        return self._version

    def live_border_set(self) -> set:
        """Dpids with at least one link whose far end lives in another
        pod of :attr:`podmap` (or outside it) — the LIVE border set the
        narrowed link-add invalidation checks interiors against
        (:func:`narrowed_dirty_set`). Empty without an annotation."""
        podmap = self.podmap
        if podmap is None:
            return set()
        pod_of = podmap.pod_of
        borders: set = set()
        for src, dst_map in self.links.items():
            ps = pod_of.get(src)
            for dst in dst_map:
                if pod_of.get(dst) != ps or ps is None:
                    borders.add(src)
                    borders.add(dst)
        return borders

    def deltas_since(self, version: int) -> Optional[list[tuple]]:
        """Every mutation after ``version``, as ``(version, kind, ...)``
        tuples — ``("link+", src, dst, port)`` / ``("link-", src, dst)``
        link deltas plus ``switch_upsert`` / ``switch_new`` / ``host``
        membership markers — or None when the log no longer covers that
        epoch (overflow or a structural break). The incremental oracle
        (oracle/incremental.py) repairs its tensors from this instead
        of recomputing the full APSP."""
        if version < self._delta_floor:
            return None
        return [e for e in self._delta_log if e[0] > version]

    def to_dict(self) -> dict:
        """JSON snapshot, same layout as the reference's
        (sdnmpi/util/topology_db.py:44-57)."""
        links = [
            _entity_dict(link)
            for dst_map in self.links.values()
            for link in dst_map.values()
        ]
        return {
            "switches": [_entity_dict(s) for s in self.switches.values()],
            "links": links,
            "hosts": [_entity_dict(h) for h in self.hosts.values()],
        }

    # -- endpoint resolution (reference: topology_db.py:143-166) ---------

    def _resolve_endpoint(self, mac: str) -> Optional[tuple[int, bool]]:
        """Map a MAC to (edge dpid, is_switch_local).

        A MAC that parses to a known dpid addresses the switch's local
        port; otherwise it must be a known host, whose attachment port
        names the edge switch."""
        as_int = mac_to_int(mac)
        if as_int in self.switches:
            return as_int, True
        host = self.hosts.get(mac)
        if host is None:
            return None
        return host.port.dpid, False

    def _final_hop(self, dst_mac: str, dst_dpid: int, is_local: bool) -> tuple[int, int]:
        if is_local:
            return (dst_dpid, OFPP_LOCAL)
        return (dst_dpid, self.hosts[dst_mac].port.port_no)

    def _route_to_fdb(
        self, route: list[int], dst_mac: str, dst_dpid: int, is_local_dst: bool
    ) -> list[tuple[int, int]]:
        """Convert a dpid path to ``[(dpid, out_port)]``
        (reference: topology_db.py:127-138)."""
        fdb = [
            (dpid, self.links[dpid][route[i + 1]].src.port_no)
            for i, dpid in enumerate(route[:-1])
        ]
        fdb.append(self._final_hop(dst_mac, dst_dpid, is_local_dst))
        return fdb

    # -- routing ---------------------------------------------------------

    def find_route(self, src_mac: str, dst_mac: str, multiple: bool = False):
        """Route between two endpoints.

        Returns ``[(dpid, out_port), ...]`` (empty when unreachable), or a
        list of such fdbs — all equal-cost shortest paths — when
        ``multiple`` is set. Same contract as the reference
        (topology_db.py:140-188) except single-path results are shortest.
        """
        if multiple:
            return self.find_all_routes(src_mac, dst_mac)[0]
        src = self._resolve_endpoint(src_mac)
        dst = self._resolve_endpoint(dst_mac)
        if src is None or dst is None:
            return []
        src_dpid, _ = src
        dst_dpid, is_local_dst = dst
        route = self._shortest_route(src_dpid, dst_dpid)
        if not route:
            return []
        return self._route_to_fdb(route, dst_mac, dst_dpid, is_local_dst)

    def find_all_routes(
        self, src_mac: str, dst_mac: str, max_paths: Optional[int] = None
    ) -> tuple[list, bool]:
        """All equal-cost shortest routes as fdbs, with a truncation
        flag. ``max_paths`` bounds the inherently-exponential
        enumeration (see ``_py_all_shortest_routes``) — the fix-of-the-
        fix of the reference's dead FindAllRoutes API
        (sdnmpi/topology.py:37-48). Returns ``(fdbs, truncated)``."""
        src = self._resolve_endpoint(src_mac)
        dst = self._resolve_endpoint(dst_mac)
        if src is None or dst is None:
            return [], False
        src_dpid, _ = src
        dst_dpid, is_local_dst = dst
        routes, truncated = self._shortest_routes(src_dpid, dst_dpid, max_paths)
        return [
            self._route_to_fdb(r, dst_mac, dst_dpid, is_local_dst) for r in routes
        ], truncated

    def find_routes_batch(
        self, pairs: list[tuple[str, str]]
    ) -> list[list[tuple[int, int]]]:
        """Batched single-path routing: on the torch backend the whole
        batch resolves against the cached next-hop matrix; on the
        pure-Python backend it loops."""
        if self.backend == "torch":
            return self._oracle_engine().routes_batch(self, pairs)
        return [self.find_route(s, d) for s, d in pairs]

    def find_routes_batch_balanced(
        self,
        pairs: list[tuple[str, str]],
        link_util: Optional[dict[tuple[int, int], float]] = None,
        alpha: float = 1.0,
        chunk: int = 4096,
        link_capacity: float = 10e9,
        ecmp_ways: int = 4,
        rounds: int = 2,
        dag_threshold: Optional[int] = None,
    ) -> tuple[list[list[tuple[int, int]]], float]:
        """Load-aware batched routing: the batch spreads across
        equal-cost paths on the device, seeded with measured link
        utilization (a ``(dpid, port) -> bps`` dict). Returns ``(fdbs,
        max_congestion)``. Batches of at least ``dag_threshold``
        sub-flows use the DAG balancer and kernel K2, smaller ones the
        greedy scanner (``RouteOracle.routes_batch_balanced``).

        The pure-Python backend has no balancing: it routes the plain
        batch and reports the congestion of the chosen paths."""
        if self.backend == "torch":
            return self._oracle_engine().routes_batch_balanced(
                self, pairs, link_util, alpha, chunk, link_capacity,
                ecmp_ways, rounds, dag_threshold,
            )
        fdbs = [self.find_route(s, d) for s, d in pairs]
        return fdbs, _fdb_congestion(fdbs)

    def find_routes_batch_adaptive(
        self,
        pairs: list[tuple[str, str]],
        link_util: Optional[dict[tuple[int, int], float]] = None,
        ugal_candidates: int = 4,
        ugal_bias: float = 1.0,
        alpha: float = 1.0,
        link_capacity: float = 10e9,
        ecmp_ways: int = 4,
    ) -> tuple[list[list[tuple[int, int]]], int, float]:
        """UGAL adaptive min/non-min batched routing
        (``oracle/adaptive.py``): flows may detour through a Valiant
        intermediate when measured congestion makes their hop-minimal
        routes expensive. Returns ``(fdbs, n_detoured_pairs,
        max_congestion)``.

        The pure-Python backend has no adaptive machinery: it routes the
        plain batch with zero detours."""
        if self.backend == "torch":
            return self._oracle_engine().routes_batch_adaptive(
                self,
                pairs,
                link_util=link_util,
                ugal_candidates=ugal_candidates,
                ugal_bias=ugal_bias,
                alpha=alpha,
                link_capacity=link_capacity,
                ecmp_ways=ecmp_ways,
            )
        return [self.find_route(s, d) for s, d in pairs], 0, 0.0

    def find_routes_batch_dispatch(
        self,
        pairs: list[tuple[str, str]],
        policy: str = "shortest",
        **kwargs,
    ):
        """Split-phase batch routing: launch the oracle's device work and
        return a :class:`~sdnmpi_tpu_torch.oracle.batch.RouteWindow` at
        once; ``reap()`` yields the window's ``WindowRoutes``.

        ``kwargs`` are the knobs of the blocking API of ``policy``
        (``"balanced"`` or ``"adaptive"``; any other policy routes
        shortest paths). The adaptive policy and the pure-Python backend
        come back as completed windows.

        With :attr:`route_cache` armed, a repeat request (same pairs,
        same policy knobs, same topology and utilization state) returns
        the memoized reaped window without dispatching anything, equal
        to the miss it memoizes (oracle/routecache.py owns the
        invalidation rules)."""
        cache = self.route_cache
        key = None
        if cache is not None:
            cache.sync(self)
            key = cache.window_key(
                pairs, policy, kwargs.get("link_util"), kwargs
            )
            if key is not None:
                hit = cache.lookup(key)
                if hit is not None:
                    from sdnmpi_tpu_torch.oracle.batch import RouteWindow

                    return RouteWindow(result=hit)
        window = self._find_routes_batch_dispatch(pairs, policy, **kwargs)
        if key is not None:
            return cache.store_window(key, window, self._version)
        return window

    def _find_routes_batch_dispatch(
        self,
        pairs: list[tuple[str, str]],
        policy: str = "shortest",
        **kwargs,
    ):
        """The uncached dispatch leg (see find_routes_batch_dispatch)."""
        from sdnmpi_tpu_torch.oracle.batch import RouteWindow, WindowRoutes

        if policy == "balanced":
            if self.backend == "torch":
                return self._oracle_engine().routes_batch_balanced_dispatch(
                    self, pairs, **kwargs
                )
            fdbs, maxc = self.find_routes_batch_balanced(pairs, **kwargs)
            return RouteWindow(result=WindowRoutes.from_fdbs(
                fdbs, max_congestion=maxc,
            ))
        if policy == "adaptive":
            fdbs, n_detours, maxc = self.find_routes_batch_adaptive(
                pairs, **kwargs
            )
            return RouteWindow(result=WindowRoutes.from_fdbs(
                fdbs, max_congestion=maxc, n_detours=n_detours,
            ))
        if self.backend == "torch":
            return self._oracle_engine().routes_batch_dispatch(self, pairs)
        fdbs = [self.find_route(s, d) for s, d in pairs]
        return RouteWindow(result=WindowRoutes.from_fdbs(fdbs))

    def find_routes_batch_delta_dispatch(self, pairs, dirty_dpids):
        """Delta-narrowed split-phase routing (the churn dataflow's
        re-scoring stage): :meth:`find_routes_batch_dispatch` with the
        shortest policy, whose reaped ``WindowRoutes`` carries the
        per-pair ``touched`` flag (the new path crosses the dirtied
        switch set). On the torch backend the refresh absorbs the delta
        log by the in-place APSP repair; the pure-Python backend loops
        and intersects sets, the differential twin."""
        if self.backend == "torch":
            return self._oracle_engine().routes_batch_delta_dispatch(
                self, pairs, dirty_dpids
            )
        from sdnmpi_tpu_torch.oracle.batch import RouteWindow, WindowRoutes

        fdbs = [self.find_route(s, d) for s, d in pairs]
        wr = WindowRoutes.from_fdbs(fdbs)
        dirty = set(dirty_dpids)
        wr.touched = np.array(
            [any(dpid in dirty for dpid, _ in fdb) for fdb in fdbs], bool
        )
        return RouteWindow(result=wr)

    def find_routes_collective_phased(
        self,
        macs: list,
        src_idx,
        dst_idx,
        policy: str = "balanced",
        n_phases: int = 0,
        **kwargs,
    ):
        """Phase-scheduled whole-collective routing: the pairs are packed
        into K link-load-balanced phases and each phase is routed as its
        own batch; returns a
        :class:`~sdnmpi_tpu_torch.sched.program.PhasedFlowProgram` whose
        phases the Router installs in order. On the torch backend the
        packer runs on the oracle's device; the pure-Python backend runs
        its host twin over the same grouping (idle background loads) and
        routes each phase through :meth:`find_routes_collective`."""
        if self.backend == "torch":
            return self._oracle_engine().routes_collective_phased_dispatch(
                self, macs, src_idx, dst_idx, policy, n_phases=n_phases,
                **kwargs,
            )
        from sdnmpi_tpu_torch.oracle.batch import RouteWindow
        from sdnmpi_tpu_torch.sched import choose_n_phases, pack_phases
        from sdnmpi_tpu_torch.sched.phases import aggregate_groups
        from sdnmpi_tpu_torch.sched.program import PhasedFlowProgram, PhasePlan

        src_idx = np.ascontiguousarray(src_idx, dtype=np.int32)
        dst_idx = np.ascontiguousarray(dst_idx, dtype=np.int32)
        f = len(src_idx)
        # compact switch index over sorted dpids (the tensor path's row
        # order), so both packers see the same group ids
        dpids = sorted(self.switches)
        index = {d: i for i, d in enumerate(dpids)}
        v = max(1, len(dpids))
        edge = np.full(len(macs), -1, np.int32)
        for i, mac in enumerate(macs):
            resolved = self._resolve_endpoint(mac)
            if resolved is not None and resolved[0] in index:
                edge[i] = index[resolved[0]]
        src_sw = edge[src_idx]
        dst_sw = edge[dst_idx]
        ok = (src_sw >= 0) & (dst_sw >= 0)
        pair_phase = np.full(f, -1, np.int32)
        k = choose_n_phases(0, n_phases)
        if ok.any():
            _, uniq, inv, _, g_src, g_dst, w = aggregate_groups(
                src_sw[ok], dst_sw[ok], v
            )
            k = choose_n_phases(len(uniq), n_phases)
            packed = pack_phases(g_src, g_dst, w, k, v, device=None)
            pair_phase[ok] = packed[inv]
        phases = []
        for p in range(k):
            sel = np.nonzero(pair_phase == p)[0]
            if not len(sel):
                continue
            routes = self.find_routes_collective(
                macs, src_idx[sel], dst_idx[sel], policy, **kwargs
            )
            phases.append(PhasePlan(p, sel, RouteWindow(result=routes)))
        return PhasedFlowProgram(k, pair_phase, phases)

    def find_routes_collective(
        self,
        macs: list,
        src_idx,
        dst_idx,
        policy: str = "balanced",
        **kwargs,
    ):
        """Array-native whole-collective routing (oracle/batch.py).

        ``macs`` lists unique endpoints once; ``src_idx``/``dst_idx`` are
        [F] indices into it. Returns a ``CollectiveRoutes``. On the torch
        backend this is one resolve + one device program + one decode;
        the pure-Python backend loops (differential oracle).

        With :attr:`route_cache` armed, a re-issued collective (same
        member set, same policy and epoch state) is served from the memo
        without touching the oracle."""
        cache = self.route_cache
        key = None
        if cache is not None:
            cache.sync(self)
            key = cache.collective_key(
                macs, src_idx, dst_idx, policy,
                kwargs.get("link_util"), kwargs,
            )
            if key is not None:
                hit = cache.lookup(key)
                if hit is not None:
                    return hit
        routes = self._find_routes_collective(
            macs, src_idx, dst_idx, policy, **kwargs
        )
        if key is not None:
            cache.store(key, routes, routes.hop_dpid)
        return routes

    def _find_routes_collective(
        self,
        macs: list,
        src_idx,
        dst_idx,
        policy: str = "balanced",
        **kwargs,
    ):
        """The uncached collective leg (see find_routes_collective)."""
        if self.backend == "torch":
            return self._oracle_engine().routes_collective(
                self, macs, src_idx, dst_idx, policy, **kwargs
            )
        from sdnmpi_tpu_torch.oracle.batch import CollectiveRoutes

        src_idx = np.asarray(src_idx)
        dst_idx = np.asarray(dst_idx)
        f = len(src_idx)
        fdbs = [
            self.find_route(macs[int(s)], macs[int(d)])
            for s, d in zip(src_idx, dst_idx)
        ]
        max_l = max((len(fdb) for fdb in fdbs), default=1) or 1
        hop_dpid = np.full((f, max_l), -1, np.int64)
        hop_port = np.full((f, max_l), -1, np.int32)
        hop_len = np.zeros(f, np.int32)
        final_port = np.full(f, -1, np.int32)
        for k, fdb in enumerate(fdbs):
            hop_len[k] = len(fdb)
            for h, (dpid, port) in enumerate(fdb):
                hop_dpid[k, h] = dpid
                hop_port[k, h] = port
            if fdb:
                final_port[k] = fdb[-1][1]
                hop_port[k, len(fdb) - 1] = -1  # per-pair placeholder
        endpoint_port = np.full(len(macs), -1, np.int32)
        for i, mac in enumerate(macs):
            host = self.hosts.get(mac)
            if host is not None:
                endpoint_port[i] = host.port.port_no
            elif mac_to_int(mac) in self.switches:
                endpoint_port[i] = OFPP_LOCAL
        return CollectiveRoutes(
            np.arange(f, dtype=np.int32), final_port, hop_dpid, hop_port,
            hop_len, max_congestion=_fdb_congestion(fdbs),
            endpoint_port=endpoint_port,
        )

    def warm_serving(self, shapes=(8, 256)) -> dict:
        """Run the serving path once against the current topology before
        the first request: the refresh plus one window-extraction
        dispatch per batch bucket (``RouteOracle.warm_serving``). No-op
        on the pure-Python backend."""
        if self.backend != "torch":
            return {"warm_s": 0.0, "shapes": [], "max_len": 0}
        return self._oracle_engine().warm_serving(self, shapes)

    def hier_border_snapshot(self) -> Optional[dict]:
        """Serializable snapshot of the hier oracle's materialized
        border-row plane (None when the hier oracle is off, stale, or
        has no rows): api/snapshot persists it beside the route-cache
        memo."""
        if not self.hier_oracle or self.backend != "torch":
            return None
        return self._oracle_engine().border_snapshot(self)

    def hier_restore_border_rows(self, snap) -> int:
        """Seed the hier oracle's border-row plane from a snapshot
        (topology-digest guarded: a mismatch counts
        ``hier_snapshot_rejected_total`` and leaves the cold lazy build,
        never a crash). Returns the restored row count."""
        if not self.hier_oracle or self.backend != "torch":
            return 0
        return self._oracle_engine().restore_border_rows(snap, self)

    # -- backend dispatch ------------------------------------------------

    def _shortest_route(self, src_dpid: int, dst_dpid: int) -> list[int]:
        if self.backend == "torch":
            return self._oracle_engine().shortest_route(self, src_dpid, dst_dpid)
        return _py_shortest_route(self, src_dpid, dst_dpid)

    def _shortest_routes(
        self, src_dpid: int, dst_dpid: int, max_paths: Optional[int] = None
    ) -> tuple[list[list[int]], bool]:
        if self.backend == "torch":
            return self._oracle_engine().all_shortest_routes(
                self, src_dpid, dst_dpid, max_paths
            )
        return _py_all_shortest_routes(self, src_dpid, dst_dpid, max_paths)

    def _oracle_engine(self):
        if self._oracle is None:
            if self.hier_oracle:
                from sdnmpi_tpu_torch.oracle.hier import HierOracle

                self._oracle = HierOracle(
                    self.pad_multiple, self.max_diameter,
                    mesh_devices=self.mesh_devices,
                    shard_oracle=self.shard_oracle,
                    ring_exchange=self.ring_exchange,
                    pod_target=self.hier_pod_target,
                    fused=self.hier_fused,
                    hier_warm=self.hier_warm,
                    device=self.device,
                )
            else:
                from sdnmpi_tpu_torch.oracle.engine import RouteOracle

                self._oracle = RouteOracle(
                    self.pad_multiple, self.max_diameter,
                    mesh_devices=self.mesh_devices,
                    shard_oracle=self.shard_oracle,
                    ring_exchange=self.ring_exchange,
                    device=self.device,
                )
            if self.delta_repair_threshold is not None:
                self._oracle.delta_repair_threshold = self.delta_repair_threshold
        return self._oracle


# -- pure-Python backend -------------------------------------------------


def _fdb_congestion(fdbs: list[list[tuple[int, int]]]) -> float:
    """Max discrete link load of fdbs: each adds 1 to every link of its
    path."""
    load: dict[tuple[int, int], float] = {}
    for fdb in fdbs:
        for (a, _), (b, _) in zip(fdb, fdb[1:]):
            load[(a, b)] = load.get((a, b), 0.0) + 1.0
    return max(load.values(), default=0.0)

#
# Chosen to match the torch oracle exactly: distances-to-destination via
# reverse BFS, then a greedy forward walk picking the lowest-dpid neighbor
# that strictly decreases the distance. This yields the lexicographically
# smallest shortest path (by dpid sequence), which is also what the
# device-side argmin-with-lowest-index tie-break produces.


def _py_dist_to(db: TopologyDB, dst_dpid: int) -> dict[int, int]:
    """Hop distance from every switch to ``dst_dpid`` over directed links."""
    reverse: dict[int, list[int]] = {}
    for src, dst_map in db.links.items():
        for dst in dst_map:
            reverse.setdefault(dst, []).append(src)
    dist = {dst_dpid: 0}
    frontier = [dst_dpid]
    while frontier:
        next_frontier = []
        for node in frontier:
            for pred in reverse.get(node, []):
                if pred not in dist:
                    dist[pred] = dist[node] + 1
                    next_frontier.append(pred)
        frontier = next_frontier
    return dist


def _py_shortest_route(db: TopologyDB, src_dpid: int, dst_dpid: int) -> list[int]:
    if src_dpid == dst_dpid:
        # the reference returns the trivial path unconditionally
        # (topology_db.py:63-71 via DFS immediate goal hit)
        return [src_dpid]
    dist = _py_dist_to(db, dst_dpid)
    if src_dpid not in dist:
        return []
    route = [src_dpid]
    node = src_dpid
    while node != dst_dpid:
        node = min(
            n for n in db.links.get(node, {}) if dist.get(n, -1) == dist[node] - 1
        )
        route.append(node)
    return route


def _py_all_shortest_routes(
    db: TopologyDB, src_dpid: int, dst_dpid: int,
    max_paths: Optional[int] = None,
) -> tuple[list[list[int]], bool]:
    """All equal-cost shortest paths, capped at ``max_paths``.

    The path count is exponential in the worst case (a k-ary fat-tree
    pair has (k/2)^2 equal-cost paths; richer DAGs explode further), so
    enumeration stops — with ``truncated=True`` — once the cap is hit.
    Every DAG branch leads to the destination (distance is strictly
    decreasing), so work between emitted paths is bounded by the path
    length: the cap bounds total time, not just output size. Returns
    ``(routes, truncated)``.
    """
    if src_dpid == dst_dpid:
        return [[src_dpid]], False
    dist = _py_dist_to(db, dst_dpid)
    if src_dpid not in dist:
        return [], False

    routes: list[list[int]] = []
    # explicit stack, reversed push order == sorted-dpid emission order
    stack: list[list[int]] = [[src_dpid]]
    while stack:
        acc = stack.pop()
        node = acc[-1]
        if node == dst_dpid:
            routes.append(acc)
            if max_paths is not None and len(routes) >= max_paths:
                return routes, bool(stack)
            continue
        for nxt in sorted(db.links.get(node, {}), reverse=True):
            if dist.get(nxt, -1) == dist[node] - 1:
                stack.append(acc + [nxt])
    return routes, False

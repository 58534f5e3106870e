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
the oracle caches device tensors until the topology changes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from sdnmpi_tpu_torch.protocol.openflow import OFPP_LOCAL
from sdnmpi_tpu_torch.utils.mac import mac_to_int

_BACKENDS = ("torch", "py")


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
        hier_oracle: bool = False,
        hier_pod_target: int = 0,
        hier_fused: bool = True,
        hier_warm: bool = True,
    ) -> None:
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
        if hier_oracle or hier_pod_target or not (hier_fused and hier_warm):
            raise NotImplementedError(
                "the hierarchical oracle (hier_oracle and its hier_* "
                "arguments) is ROADMAP A13"
            )
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
        if backend == "torch":
            from sdnmpi_tpu_torch.oracle.engine import resolve_device

            self.device = resolve_device(device)
        #: pod structure annotation (topogen/podmap.py), set by
        #: TopoSpec.to_topology_db for generator fabrics
        self.podmap = None
        self._version = 0
        self._oracle = None  # lazily-created torch oracle (oracle/engine.py)

    # -- mutators ----------------------------------------------------------

    def add_host(self, host: Any) -> None:
        self.hosts[host.mac] = host
        self._version += 1

    def delete_host(self, mac: str) -> None:
        if self.hosts.pop(mac, None) is not None:
            self._version += 1

    def add_switch(self, switch: Any) -> None:
        self.switches[switch.dp.id] = switch
        self._version += 1

    def delete_switch(self, switch: Any) -> None:
        if switch.dp.id in self.switches:
            del self.switches[switch.dp.id]
            self._version += 1

    def add_link(self, link: Any) -> None:
        self.links.setdefault(link.src.dpid, {})[link.dst.dpid] = link
        self._version += 1

    def delete_link(self, link: Any) -> None:
        dst_map = self.links.get(link.src.dpid)
        if dst_map and link.dst.dpid in dst_map:
            del dst_map[link.dst.dpid]
            self._version += 1

    @property
    def version(self) -> int:
        """Bumped on every mutation; oracle caches are keyed on this."""
        return self._version

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
        come back as completed windows."""
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
        raise NotImplementedError("delta-narrowed batches are ROADMAP A7")

    def find_routes_collective_phased(self, *args, **kwargs):
        raise NotImplementedError("phase-scheduled collectives are ROADMAP A10")

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
        the pure-Python backend loops (differential oracle)."""
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

    # -- backend dispatch ------------------------------------------------

    def _shortest_route(self, src_dpid: int, dst_dpid: int) -> list[int]:
        if self.backend == "torch":
            return self._oracle_engine().shortest_route(self, src_dpid, dst_dpid)
        return _py_shortest_route(self, src_dpid, dst_dpid)

    def _shortest_routes(
        self, src_dpid: int, dst_dpid: int, max_paths: Optional[int] = None
    ) -> tuple[list[list[int]], bool]:
        if self.backend == "torch":
            raise NotImplementedError(
                "equal-cost route enumeration on the torch oracle is ROADMAP A5"
            )
        return _py_all_shortest_routes(self, src_dpid, dst_dpid, max_paths)

    def _oracle_engine(self):
        if self._oracle is None:
            from sdnmpi_tpu_torch.oracle.engine import RouteOracle

            self._oracle = RouteOracle(
                self.pad_multiple, self.max_diameter,
                mesh_devices=self.mesh_devices,
                shard_oracle=self.shard_oracle,
                ring_exchange=self.ring_exchange,
                device=self.device,
            )
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

"""Route oracle: tensorized topology + cached APSP on a torch device.

Counterpart of ``sdnmpi_tpu/oracle/engine.py`` on one device: the
topology becomes dense ``[V, V]`` tensors, all-pairs distances and next
hops are computed once per topology version, and the routing entry
points answer from them:

- pair batches (``routes_batch*``): the shortest policy chases the
  next-hop matrix (on the host for small batches, by
  ``oracle/paths.batch_fdb`` on the device otherwise); the balanced
  policy routes its ECMP sub-flows with the DAG balancer and kernel K2
  (``oracle/dag.route_collective``) at or above ``dag_flow_threshold``
  sub-flows and with the greedy scanner
  (``oracle/congestion.route_flows_balanced``) below it; the adaptive
  policy runs the UGAL program (``oracle/adaptive.route_adaptive``);
- whole collectives (``routes_collective*``) in compressed array form,
  with the ``"balanced"``, ``"shortest"`` and ``"adaptive"`` policies.

Every tensor lives on the oracle's ``device``; nothing moves to another
device behind the caller's back.

With ``mesh_devices=n`` the oracle builds a shard mesh
(``shardplane/mesh.py``) and routes balanced collectives through
``shardplane.route_collective_sharded``; with ``shard_oracle`` the
refresh row-shards distances and next hops over it too, and with
``ring_exchange`` the sharded legs stream distances through the ring
kernel K3 instead of replicating them first. The sharded shortest and
adaptive legs raise (ROADMAP A12 item 3); nothing routes on one device
in their place.

Not ported yet, and raising ``NotImplementedError`` where a caller asks
for them: the incremental repair, the hierarchical oracle, the
utilization plane, the delta-narrowed batches and phase scheduling
(ROADMAP A7-A13).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from sdnmpi_tpu_torch.kernels.bfs import neighbor_rows
from sdnmpi_tpu_torch.oracle.apsp import apsp_distances, apsp_next_hops, occ_bucket
from sdnmpi_tpu_torch.utils.metrics import REGISTRY

if TYPE_CHECKING:
    from sdnmpi_tpu_torch.core.topology_db import TopologyDB

_m_full_refreshes = REGISTRY.counter(
    "oracle_full_refreshes_total", "full tensorize + APSP recomputes"
)
_m_disc_congestion = REGISTRY.gauge(
    "congestion_discrete_max",
    "max discrete link load (flows per link) of the last balanced pass's "
    "installed paths",
)
_m_frac_congestion = REGISTRY.gauge(
    "congestion_fractional_max",
    "the DAG balancer's fractional max-link-load bound of the last "
    "balanced pass (the relaxation the discrete sampler rounds)",
)
_m_shard_mesh = REGISTRY.gauge(
    "shard_mesh_devices", "shards of the sharded oracle's mesh (0 = single device)"
)
_m_congestion_ratio = REGISTRY.gauge(
    "congestion_discrete_over_fractional",
    "discrete / fractional max-congestion of the last DAG-balanced pass "
    "(1.0 = sampling achieved the bound; the gap is scheduling headroom)",
)


def resolve_device(device) -> torch.device:
    """The torch device a caller asked for; raises when it is a CUDA
    device and no card is present (the port never moves to the CPU on
    its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def _host(x) -> np.ndarray:
    """A tensor, or a row-sharded list of them, as one host array."""
    if isinstance(x, list):
        from sdnmpi_tpu_torch.convert import gather_rows

        return gather_rows(x)
    return x.cpu().numpy()


def _gather_dist(blocks: list, mesh) -> torch.Tensor:
    """Row-sharded f32 hop counts -> one replicated ``[V, V]`` copy: the
    blocks ride kernel K3 on the 2-byte wire and only the first shard's
    gathered copy is unpacked."""
    from sdnmpi_tpu_torch.kernels.ring import (
        pack_dist_wire,
        ring_all_gather,
        unpack_dist_wire,
    )

    v = blocks[0].shape[1]
    return unpack_dist_wire(
        ring_all_gather([pack_dist_wire(d, v) for d in blocks], mesh)[0]
    )


def _pad(n: int, multiple: int = 8) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


@dataclasses.dataclass
class TopoTensors:
    """Dense tensor form of a TopologyDB snapshot.

    Indices follow sorted-dpid order, so lowest-index tie-breaks match
    the reference's sorted-dpid neighbour iteration. ``adj``/``port``
    live on the oracle's device; ``adj_host``/``port_host`` are their
    numpy twins for the host-side stages."""

    dpids: np.ndarray  # [n] int64, sorted
    index: dict[int, int]  # dpid -> row index
    adj: torch.Tensor  # [V, V] f32 0/1, directed
    port: torch.Tensor  # [V, V] int32, out-port i -> j, -1 if no link
    n_real: int
    #: max out-degree rounded up to a multiple of 8
    max_degree: int = 32
    adj_host: np.ndarray | None = None
    port_host: np.ndarray | None = None
    #: directed-link count; -1 = unknown
    n_links: int = -1
    #: [V, max_degree] int32 sorted out-neighbours (V past the degree),
    #: on the device: the table kernels K1 and K2 walk, built with the
    #: tensors, so once per topology version
    neigh: torch.Tensor | None = None

    def __post_init__(self) -> None:
        if self.neigh is None:
            self.neigh = neighbor_rows(self.adj > 0, min(self.max_degree, self.v))

    def link_count(self) -> int:
        if self.n_links < 0:
            self.n_links = int((self.host_adj() > 0).sum())
        return self.n_links

    @property
    def v(self) -> int:
        return self.adj.shape[0]

    def host_adj(self) -> np.ndarray:
        return self.adj_host if self.adj_host is not None else self.adj.cpu().numpy()

    def host_port(self) -> np.ndarray:
        return (
            self.port_host if self.port_host is not None
            else self.port.cpu().numpy()
        )


def tensorize(
    db: "TopologyDB", pad_multiple: int = 8, device="cuda"
) -> TopoTensors:
    """Build padded adjacency/port tensors from the graph dictionaries.

    The node set is every dpid mentioned anywhere (switches, link
    endpoints, host attachments); routing only consults ``links``."""
    dev = resolve_device(device)
    dpid_set = set(db.switches)
    edges: list[tuple[int, int, int]] = []
    for src, dst_map in db.links.items():
        dpid_set.add(src)
        dpid_set.update(dst_map)
        for dst, link in dst_map.items():
            edges.append((src, dst, link.src.port_no))
    for host in db.hosts.values():
        dpid_set.add(host.port.dpid)

    dpids = np.array(sorted(dpid_set), dtype=np.int64)
    index = {int(d): i for i, d in enumerate(dpids)}
    v = _pad(len(dpids), pad_multiple)
    adj = np.zeros((v, v), dtype=np.float32)
    port = np.full((v, v), -1, dtype=np.int32)
    if edges:
        earr = np.asarray(edges, dtype=np.int64)
        li = np.searchsorted(dpids, earr[:, 0])
        lj = np.searchsorted(dpids, earr[:, 1])
        adj[li, lj] = 1.0
        port[li, lj] = earr[:, 2].astype(np.int32)
    out_degree = int((adj > 0).sum(axis=1).max()) if len(dpids) else 0
    return TopoTensors(
        dpids=dpids,
        index=index,
        # torch.tensor copies: the host twins stay private to numpy
        adj=torch.tensor(adj, device=dev),
        port=torch.tensor(port, device=dev),
        n_real=len(dpids),
        max_degree=max(8, ((out_degree + 7) // 8) * 8),
        adj_host=adj,
        port_host=port,
        n_links=len(edges),
    )


class RouteOracle:
    """Per-TopologyDB cache of tensors + APSP results on one device.

    Single-path queries chase next hops on the host against the cached
    matrices; whole collectives run ``dag.route_collective`` on the
    device."""

    #: occupancy-bucket width: when the padded capacity V exceeds the
    #: occupied switch count by a bucket, the APSP computes only the
    #: occupied block (the padding block is analytic); 0 disables
    occ_bucket_multiple: int = 128
    #: pair batches of at most this many hops (pairs x hop budget) chase
    #: the cached next hops on the host; larger ones run on the device
    host_chase_hop_budget: int = 4096
    #: balanced pair batches of at least this many sub-flows route with
    #: the DAG balancer and kernel K2, smaller ones with the greedy
    #: scanner (the reference's ``Config.dag_flow_threshold``)
    dag_flow_threshold: int = 512

    def __init__(
        self,
        pad_multiple: int = 8,
        max_diameter: int = 0,
        mesh_devices: int = 0,
        shard_oracle: bool = False,
        ring_exchange: bool = False,
        device="cuda",
    ) -> None:
        log = logging.getLogger(__name__)
        self.device = resolve_device(device)
        if shard_oracle and not mesh_devices:
            log.warning("shard_oracle needs mesh_devices > 0; staying single-device")
            shard_oracle = False
        #: the shard mesh, built here so that a mesh that cannot exist
        #: raises at construction (there is no fallback to one device)
        self._mesh = None
        if mesh_devices:
            from sdnmpi_tpu_torch.shardplane.mesh import make_mesh

            self._mesh = make_mesh(mesh_devices, self.device)
            # the sharded DAG step splits V rows and flows over the mesh
            pad_multiple = math.lcm(pad_multiple, mesh_devices)
            _m_shard_mesh.set(mesh_devices)
        self.pad_multiple = pad_multiple
        self.max_diameter = max_diameter
        self.mesh_devices = mesh_devices
        #: the refresh row-shards distances and next hops over the mesh
        self.shard_oracle = bool(shard_oracle)
        if ring_exchange and not self.shard_oracle:
            log.warning("ring_exchange needs shard_oracle; staying on the gather path")
        #: the sharded legs stream distances through the ring (kernel K3)
        self.ring_exchange = bool(ring_exchange) and self.shard_oracle
        self._version: Optional[int] = None
        self._tensors: Optional[TopoTensors] = None
        #: distances and next hops: [V, V] tensors, or row-sharded lists
        #: of per-shard blocks under shard_oracle
        self._dist_d = None
        self._next_d = None
        #: replicated copy of row-sharded distances, gathered on first use
        self._dist_full_d: Optional[torch.Tensor] = None
        self._dist_h: Optional[np.ndarray] = None  # lazy host twin
        self._next_h: Optional[np.ndarray] = None  # lazy host twin
        self._port: Optional[np.ndarray] = None
        self._order: Optional[np.ndarray] = None  # sorted-neighbour table
        #: mac -> (row index, final out-port) | None, valid for one
        #: topology version (refresh clears it)
        self._endpoint_memo: dict[str, Optional[tuple[int, int]]] = {}
        self.full_refresh_count: int = 0
        self.last_fractional_congestion: float = 0.0
        self.last_discrete_congestion: float = 0.0
        self.last_congestion_ratio: float = 0.0

    def _occ_v(self, t: TopoTensors) -> int:
        """Occupied-bucket V of this topology version (t.v when
        bucketing is off or would not shrink the block)."""
        return occ_bucket(t.n_real, t.v, self.occ_bucket_multiple)

    # -- cache management -------------------------------------------------

    def refresh(self, db: "TopologyDB") -> TopoTensors:
        """Recompute tensors, distances and next hops when the topology
        version moved (always a full recompute: the incremental repair
        is ROADMAP A7)."""
        if self._version != db.version or self._tensors is None:
            from sdnmpi_tpu_torch import native

            tensors = tensorize(db, self.pad_multiple, self.device)
            v_occ = self._occ_v(tensors)
            n_occ = 0 if v_occ >= tensors.v else v_occ
            mesh = self._dag_mesh()
            if (
                self.shard_oracle
                and self.max_diameter == 0  # the sharded BFS has no cap
                and tensors.v % self.mesh_devices == 0
            ):
                # shardplane refresh: BFS sources and next-hop rows
                # row-shard over every shard; under ring_exchange the
                # argmin consumes the distance blocks off the ring
                from sdnmpi_tpu_torch.shardplane import (
                    apsp_distances_rowsharded,
                    apsp_next_hops_ringed,
                    apsp_next_hops_rowsharded,
                )

                dist = apsp_distances_rowsharded(tensors.adj, mesh)
                next_fn = (
                    apsp_next_hops_ringed if self.ring_exchange
                    else apsp_next_hops_rowsharded
                )
                nxt = next_fn(
                    tensors.adj, dist, mesh, tensors.max_degree, n_occ=n_occ
                )
            elif (
                mesh is not None
                and self.max_diameter == 0
                and mesh.shape["v"] > 1  # v = 1 would just replicate
                and tensors.v % mesh.shape["v"] == 0
            ):
                # mesh-only refresh: the BFS row-shards over the "v" axis,
                # K3 replicates it, the next hops run on one device
                from sdnmpi_tpu_torch.shardplane import (
                    ShardMesh,
                    apsp_distances_sharded,
                )

                nv = mesh.shape["v"]
                dist = _gather_dist(
                    apsp_distances_sharded(tensors.adj, mesh),
                    ShardMesh(mesh.devices[:nv]),
                )
                nxt = apsp_next_hops(
                    tensors.adj, dist, max_degree=tensors.max_degree,
                    n_occ=n_occ,
                )
            else:
                dist = apsp_distances(tensors.adj, self.max_diameter, n_occ=n_occ)
                nxt = apsp_next_hops(
                    tensors.adj, dist, max_degree=tensors.max_degree, n_occ=n_occ
                )
            self._tensors = tensors
            self._dist_d = dist
            self._next_d = nxt
            self._dist_full_d = None
            self._dist_h = None
            self._next_h = None
            self._port = tensors.host_port()
            self._order = native.neighbor_order(tensors.host_adj())
            self._endpoint_memo = {}
            self._version = db.version
            self.full_refresh_count += 1
            _m_full_refreshes.inc()
        return self._tensors

    @property
    def _dist(self) -> Optional[np.ndarray]:
        """Host twin of the distance matrix, copied on first use per
        topology version (shard by shard when row-sharded)."""
        if self._dist_h is None and self._dist_d is not None:
            self._dist_h = _host(self._dist_d)
        return self._dist_h

    @property
    def _next(self) -> Optional[np.ndarray]:
        if self._next_h is None and self._next_d is not None:
            self._next_h = _host(self._next_d)
        return self._next_h

    def _dist_full(self) -> torch.Tensor:
        """The distance matrix as one ``[V, V]`` tensor on the oracle's
        device. Row-sharded distances are gathered once per topology
        version, by kernel K3 on the 2-byte wire, and only the first
        shard's copy is unpacked."""
        if not isinstance(self._dist_d, list):
            return self._dist_d
        if self._dist_full_d is None:
            self._dist_full_d = _gather_dist(self._dist_d, self._dag_mesh())
        return self._dist_full_d

    def _dag_mesh(self):
        """The shard mesh of the sharded DAG engine, or None."""
        return self._mesh

    def _shard_mesh(self):
        """The mesh when the full shardplane (shard_oracle) is on."""
        return self._mesh if self.shard_oracle else None

    def _pad_flows(self, src_idx, dst_idx):
        """End-pad a flow batch to a multiple of the shard count with -1
        endpoints (dead flows); the real flows keep their global ids, and
        so their noise. Callers trim back with ``[: len(src_idx)]``."""
        pad = (-len(src_idx)) % self.mesh_devices
        src_p = np.concatenate([src_idx, np.full(pad, -1, np.int32)])
        dst_p = np.concatenate([dst_idx, np.full(pad, -1, np.int32)])
        return src_p.astype(np.int32), dst_p.astype(np.int32)

    # -- queries ----------------------------------------------------------

    def shortest_route(
        self, db: "TopologyDB", src_dpid: int, dst_dpid: int
    ) -> list[int]:
        """Switch-dpid sequence of the chosen shortest path ([] if none)."""
        if src_dpid == dst_dpid:
            return [src_dpid]
        t = self.refresh(db)
        si = t.index.get(src_dpid)
        di = t.index.get(dst_dpid)
        if si is None or di is None or not np.isfinite(self._dist[si, di]):
            return []
        route = [src_dpid]
        node = si
        while node != di:
            node = int(self._next[node, di])
            route.append(int(t.dpids[node]))
        return route

    def _next_full(self) -> torch.Tensor:
        """The next-hop matrix as one ``[V, V]`` tensor on the oracle's
        device. Row-sharded next hops (``shard_oracle``) feed only the
        sharded chase, which is not ported (ROADMAP A12 item 3)."""
        if isinstance(self._next_d, list):
            raise NotImplementedError(
                "the device chase of row-sharded next hops "
                "(shardplane.batch_fdb_sharded) is not ported yet "
                "(ROADMAP A12 item 3)"
            )
        return self._next_d

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the oracle's device."""
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True)

    # -- pair batches -----------------------------------------------------

    def _resolve_rows(
        self,
        db: "TopologyDB",
        pairs: list[tuple[str, str]],
        t: TopoTensors,
        results: list,
    ) -> list[tuple[int, int, int, int]]:
        """Map (src_mac, dst_mac) pairs to (pair idx, src idx, dst idx,
        final out-port) rows. Unresolvable pairs keep their [] in
        ``results``; a pair whose dpid escaped tensorization takes the
        scalar path. Endpoint resolution is memoized per topology
        version."""
        memo = self._endpoint_memo
        rows: list[tuple[int, int, int, int]] = []
        for k, (src_mac, dst_mac) in enumerate(pairs):
            src = (
                memo[src_mac] if src_mac in memo
                else self._memo_endpoint(db, t, src_mac)
            )
            dst = (
                memo[dst_mac] if dst_mac in memo
                else self._memo_endpoint(db, t, dst_mac)
            )
            if src is None or dst is None:
                continue
            si, di, port = src[0], dst[0], dst[1]
            if si < 0 or di < 0:
                results[k] = db.find_route(src_mac, dst_mac)
                continue
            rows.append((k, si, di, port))
        return rows

    def _memo_endpoint(
        self, db: "TopologyDB", t: TopoTensors, mac: str
    ) -> Optional[tuple[int, int]]:
        """Resolve one MAC to (row index, final out-port); a -1 row index
        marks a dpid that escaped tensorization (scalar path). Cached
        until the next topology version."""
        from sdnmpi_tpu_torch.protocol.openflow import OFPP_LOCAL

        resolved = db._resolve_endpoint(mac)
        if resolved is None:
            value = None
        else:
            dpid, is_local = resolved
            idx = t.index.get(dpid)
            if idx is None:
                value = (-1, -1)
            else:
                port = OFPP_LOCAL if is_local else db.hosts[mac].port.port_no
                value = (idx, port)
        self._endpoint_memo[mac] = value
        return value

    @staticmethod
    def _group_ecmp_subflows(
        rows: list[tuple[int, int, int, int]], ecmp_ways: int
    ) -> tuple[dict, dict, np.ndarray, np.ndarray, np.ndarray]:
        """Aggregate resolved pairs by (src, dst) transit and split each
        group into up to ``ecmp_ways`` weighted sub-flows, members dealt
        round-robin. Returns (groups, group_subs, src, dst, weight) where
        ``group_subs[key] = (first sub-flow index, n)``."""
        groups: dict[tuple[int, int], list[tuple[int, int]]] = {}
        for k, si, di, final_port in rows:
            groups.setdefault((si, di), []).append((k, final_port))
        sub_src: list[int] = []
        sub_dst: list[int] = []
        sub_w: list[float] = []
        group_subs: dict[tuple[int, int], tuple[int, int]] = {}
        for key in sorted(groups):
            members = groups[key]
            nsub = max(1, min(ecmp_ways, len(members)))
            group_subs[key] = (len(sub_src), nsub)
            for _ in range(nsub):
                sub_src.append(key[0])
                sub_dst.append(key[1])
                sub_w.append(len(members) / nsub)
        return (
            groups,
            group_subs,
            np.array(sub_src, dtype=np.int32),
            np.array(sub_dst, dtype=np.int32),
            np.array(sub_w, dtype=np.float32),
        )

    def _subflow_fdbs(self, t: TopoTensors, group_subs: dict, paths: np.ndarray):
        """Per-sub-flow fdb arrays of node rows (native batch decode):
        ``(dpid, port, length)``; a path that does not end at its
        group's destination switch gets length 0."""
        from sdnmpi_tpu_torch import native

        n_sub = paths.shape[0]
        dst_sw = np.full(n_sub, -1, np.int32)
        for key, (first, nsub) in group_subs.items():
            dst_sw[first : first + nsub] = key[1]
        return native.materialize_fdbs(
            paths, self._port, t.dpids, dst_sw, np.zeros(n_sub, np.int32)
        )

    def _materialize_window(
        self,
        t: TopoTensors,
        groups: dict,
        group_subs: dict,
        paths: np.ndarray,
        n_pairs: int,
        results: list,
        detour: Optional[np.ndarray] = None,
    ):
        """Per-sub-flow node rows ``[S, L]`` -> the whole window as a
        :class:`~sdnmpi_tpu_torch.oracle.batch.WindowRoutes`. Each pair is
        dealt onto its group's sub-flows round-robin; members share the
        transit hops and differ in the final hop's port, the pair's own
        attachment port. Scalar-path pairs already in ``results`` are
        merged in. ``max_congestion`` is the max discrete link load of the
        installed pairs (each adds 1 to every link of its sub-flow's path);
        ``n_detours`` counts the installed pairs whose sub-flow is marked
        in ``detour`` ([S] bool, the adaptive policy's)."""
        from sdnmpi_tpu_torch.oracle.adaptive import link_loads
        from sdnmpi_tpu_torch.oracle.batch import WindowRoutes

        od, op, ln = self._subflow_fdbs(t, group_subs, paths)
        g_of_pair = np.full(n_pairs, -1, np.int64)
        fport = np.full(n_pairs, -1, np.int32)
        for key, members in groups.items():
            first, nsub = group_subs[key]
            for j, (k, final_port) in enumerate(members):
                g_of_pair[k] = first + j % nsub
                fport[k] = final_port
        ok = g_of_pair >= 0
        g_safe = np.where(ok, g_of_pair, 0)
        ln_p = np.where(ok, ln[g_safe], 0).astype(np.int32)
        od_p = od[g_safe]  # fancy index: owned copies
        op_p = op[g_safe]
        good = ln_p > 0
        rows = np.nonzero(good)[0]
        op_p[rows, ln_p[rows] - 1] = fport[rows]
        od_p[~good] = -1
        op_p[~good] = -1
        counts = np.bincount(g_of_pair[rows], minlength=paths.shape[0]).astype(
            np.float32
        )
        wr = WindowRoutes(
            od_p, op_p, ln_p,
            max_congestion=float(link_loads(paths, counts, t.v).max(initial=0.0)),
            n_detours=0 if detour is None else int(detour[g_of_pair[rows]].sum()),
        )
        for k, fdb in enumerate(results):
            if fdb:  # merge the scalar-path pairs back in
                wr.set_fdb(k, fdb)
        return wr

    def routes_batch(
        self, db: "TopologyDB", pairs: list[tuple[str, str]]
    ) -> list[list[tuple[int, int]]]:
        """Resolve a batch of (src_mac, dst_mac) pairs to shortest-path
        fdbs: :meth:`routes_batch_dispatch` and its reap back to back,
        as per-pair fdb lists."""
        return self.routes_batch_dispatch(db, pairs).reap().fdbs()

    def routes_batch_dispatch(self, db: "TopologyDB", pairs: list[tuple[str, str]]):
        """Split-phase shortest-path batch routing: returns a
        :class:`~sdnmpi_tpu_torch.oracle.batch.RouteWindow` whose
        ``reap()`` yields the window's
        :class:`~sdnmpi_tpu_torch.oracle.batch.WindowRoutes`.

        Endpoints resolve on the host. A batch of at most
        :attr:`host_chase_hop_budget` hops chases the cached next hops on
        the host and comes back completed; a larger one is one
        ``oracle/paths.batch_fdb`` call on the device, padded to a
        multiple of 8, that ``reap()`` copies back. Under
        ``shard_oracle`` the reference chases row-sharded next hops, which
        is not ported (ROADMAP A12 item 3): a large batch raises."""
        from sdnmpi_tpu_torch.oracle.batch import (
            RouteWindow,
            WindowRoutes,
            pad_flow_batch,
        )
        from sdnmpi_tpu_torch.oracle.paths import batch_fdb

        t = self.refresh(db)
        results: list[list[tuple[int, int]]] = [[] for _ in pairs]
        rows = self._resolve_rows(db, pairs, t, results)
        if not rows:
            return RouteWindow(result=WindowRoutes.from_fdbs(results))

        src_idx = np.array([r[1] for r in rows], dtype=np.int32)
        dst_idx = np.array([r[2] for r in rows], dtype=np.int32)
        final_port = np.array([r[3] for r in rows], dtype=np.int32)
        max_len = self._batch_max_len(src_idx, dst_idx)
        if max_len == 0:
            return RouteWindow(result=WindowRoutes.from_fdbs(results))

        if len(rows) * max_len <= self.host_chase_hop_budget:
            dist, nxt_h, port_h, dpids = self._dist, self._next, self._port, t.dpids
            for k, si, di, fport in rows:
                if not np.isfinite(dist[si, di]):
                    continue
                fdb: list[tuple[int, int]] = []
                node = si
                while node != di:
                    nxt = int(nxt_h[node, di])
                    fdb.append((int(dpids[node]), int(port_h[node, nxt])))
                    node = nxt
                fdb.append((int(dpids[di]), int(fport)))
                results[k] = fdb
            return RouteWindow(result=WindowRoutes.from_fdbs(results))

        if self._shard_mesh() is not None:
            chase = "batch_fdb_ringed" if self.ring_exchange else "batch_fdb_sharded"
            raise NotImplementedError(
                f"the sharded chase (shardplane.{chase}) is not ported yet "
                "(ROADMAP A12 item 3)"
            )
        src_p, dst_p, fport_p = pad_flow_batch(src_idx, dst_idx, final_port)
        nodes_d, ports_d, length_d = batch_fdb(
            self._next_full(), t.port, self._put(src_p), self._put(dst_p),
            self._put(fport_p), max_len,
        )
        pair_rows = np.array([r[0] for r in rows], dtype=np.int64)
        n_pairs = len(pairs)
        dpids = t.dpids

        def reap() -> WindowRoutes:
            n_rows = len(pair_rows)
            nodes = nodes_d.cpu().numpy()[:n_rows]
            ports = ports_d.cpu().numpy()[:n_rows]
            length = length_d.cpu().numpy()[:n_rows]
            # the hop axis covers the device's and any scalar-path fdb
            width = max([nodes.shape[1]] + [len(f) for f in results if f])
            od = np.full((n_pairs, width), -1, np.int64)
            op = np.full((n_pairs, width), -1, np.int32)
            ln = np.zeros(n_pairs, np.int32)
            safe = np.clip(nodes, 0, len(dpids) - 1)
            od[pair_rows, : nodes.shape[1]] = np.where(nodes >= 0, dpids[safe], -1)
            op[pair_rows, : ports.shape[1]] = ports
            ln[pair_rows] = length
            wr = WindowRoutes(od, op, ln)
            for k, fdb in enumerate(results):
                if fdb:  # merge the scalar-path pairs back in
                    wr.set_fdb(k, fdb)
            return wr

        return RouteWindow(reap)

    def routes_batch_balanced(
        self,
        db: "TopologyDB",
        pairs: list[tuple[str, str]],
        link_util: Optional[dict[tuple[int, int], float]] = None,
        alpha: float = 1.0,
        chunk: int = 4096,
        link_capacity: float = 10e9,
        ecmp_ways: int = 4,
        rounds: int = 2,
        dag_threshold: Optional[int] = None,
    ) -> tuple[list[list[tuple[int, int]]], float]:
        """Load-aware batch routing: spreads the batch across equal-cost
        paths, seeded with measured utilization. Returns ``(fdbs,
        max_congestion)``, the max discrete link load of the installed
        fdbs (each pair counts 1 per link of its path).

        Pairs sharing an (edge, edge) transit aggregate and split into up
        to ``ecmp_ways`` weighted sub-flows. Batches of at least
        ``dag_threshold`` (default :attr:`dag_flow_threshold`) sub-flows
        route through the DAG balancer and kernel K2
        (``oracle/dag.route_collective``), smaller ones through the greedy
        scanner (``oracle/congestion.route_flows_balanced``)."""
        wr = self.routes_batch_balanced_dispatch(
            db, pairs, link_util, alpha, chunk, link_capacity, ecmp_ways,
            rounds, dag_threshold,
        ).reap()
        return wr.fdbs(), wr.max_congestion

    def routes_batch_balanced_dispatch(
        self,
        db: "TopologyDB",
        pairs: list[tuple[str, str]],
        link_util: Optional[dict[tuple[int, int], float]] = None,
        alpha: float = 1.0,
        chunk: int = 4096,
        link_capacity: float = 10e9,
        ecmp_ways: int = 4,
        rounds: int = 2,
        dag_threshold: Optional[int] = None,
    ):
        """Split-phase twin of :meth:`routes_batch_balanced`: the device
        work (DAG leg or greedy scanner, same rule) is enqueued and a
        :class:`~sdnmpi_tpu_torch.oracle.batch.RouteWindow` returned;
        ``reap()`` decodes and materializes the window's
        ``WindowRoutes``."""
        from sdnmpi_tpu_torch.oracle.batch import RouteWindow, WindowRoutes
        from sdnmpi_tpu_torch.oracle.congestion import route_flows_balanced

        t = self.refresh(db)
        results: list[list[tuple[int, int]]] = [[] for _ in pairs]
        rows = self._resolve_rows(db, pairs, t, results)
        if not rows:
            return RouteWindow(result=WindowRoutes.from_fdbs(results))

        groups, group_subs, src_idx, dst_idx, sub_w = self._group_ecmp_subflows(
            rows, ecmp_ways
        )
        base = self._normalized_base(
            db, t, link_util, alpha, link_capacity, len(rows)
        )
        threshold = self.dag_flow_threshold if dag_threshold is None else dag_threshold
        used_dag = len(src_idx) >= threshold
        max_len = self._batch_max_len(src_idx, dst_idx, multiple=1 if used_dag else 8)
        if max_len == 0:
            return RouteWindow(result=WindowRoutes.from_fdbs(results))
        if used_dag:
            paths_reap = self._dag_paths_dispatch(
                t, src_idx, dst_idx, sub_w, base, max_len, rounds
            )
        else:
            nodes_d, _, _ = route_flows_balanced(
                t.adj, self._dist_full(), self._put(base.astype(np.float32)),
                self._put(src_idx), self._put(dst_idx), self._put(sub_w),
                max_len, chunk=chunk, neigh=t.neigh,
            )

            def paths_reap() -> np.ndarray:
                return nodes_d.cpu().numpy()

        n_pairs = len(pairs)

        def reap():
            wr = self._materialize_window(
                t, groups, group_subs, paths_reap(), n_pairs, results
            )
            self._note_congestion(wr.max_congestion, dag=used_dag)
            return wr

        return RouteWindow(reap)

    def routes_batch_adaptive(
        self,
        db: "TopologyDB",
        pairs: list[tuple[str, str]],
        link_util: Optional[dict[tuple[int, int], float]] = None,
        ugal_candidates: int = 4,
        ugal_bias: float = 1.0,
        rounds: int = 2,
        alpha: float = 1.0,
        link_capacity: float = 10e9,
        ecmp_ways: int = 4,
    ) -> tuple[list[list[tuple[int, int]]], int, float]:
        """UGAL adaptive min/non-min batch routing
        (``oracle/adaptive.route_adaptive``): like
        :meth:`routes_batch_balanced`, but each sub-flow may detour
        through a Valiant intermediate when measured congestion makes its
        hop-minimal routes expensive. Returns ``(fdbs, n_detoured_pairs,
        max_congestion)``, the last the max discrete link load of the
        installed routes."""
        from sdnmpi_tpu_torch.oracle.adaptive import stitch_paths

        t = self.refresh(db)
        results: list[list[tuple[int, int]]] = [[] for _ in pairs]
        rows = self._resolve_rows(db, pairs, t, results)
        if not rows:
            return results, 0, 0.0

        groups, group_subs, src_idx, dst_idx, weight = self._group_ecmp_subflows(
            rows, ecmp_ways
        )
        max_len = self._batch_max_len(src_idx, dst_idx)
        if max_len == 0:
            return results, 0, 0.0
        base = self._normalized_base(
            db, t, link_util, alpha, link_capacity, len(rows)
        )
        inter, n1, n2 = self._adaptive_paths(
            t, src_idx, dst_idx, weight, base, max_len, rounds,
            ugal_candidates, ugal_bias,
        )
        wr = self._materialize_window(
            t, groups, group_subs, stitch_paths(n1, n2, inter), len(pairs),
            results, detour=inter >= 0,
        )
        return wr.fdbs(), wr.n_detours, wr.max_congestion

    def _adaptive_paths(
        self, t, src_idx, dst_idx, weight, base, max_len, rounds,
        ugal_candidates, ugal_bias,
    ):
        """The UGAL program for a sub-flow batch, end-padded to a multiple
        of 8 with dead flows (their ids, hence the real flows' hash
        streams, unchanged), on the cached distances (so no K1), with the
        packed slot streams decoded on the host. Returns ``(inter, n1,
        n2)`` numpy arrays trimmed to the batch. With a shard mesh the
        reference runs the sharded program, which is not ported (ROADMAP
        A12 item 3): it raises."""
        from sdnmpi_tpu_torch.oracle.adaptive import decode_segments, route_adaptive
        from sdnmpi_tpu_torch.oracle.batch import pad_flow_batch

        n = len(src_idx)
        kwargs = dict(
            levels=max_len - 1, rounds=rounds, max_len=max_len,
            n_candidates=ugal_candidates, bias=ugal_bias,
        )
        if self._dag_mesh() is not None:
            raise NotImplementedError(
                "the sharded UGAL program (shardplane.route_adaptive_sharded) "
                "is not ported yet (ROADMAP A12 item 3)"
            )
        src_a, dst_a = pad_flow_batch(
            np.asarray(src_idx, np.int32), np.asarray(dst_idx, np.int32)
        )
        w_a = np.zeros(len(src_a), np.float32)
        w_a[:n] = np.asarray(weight, np.float32)
        inter_d, s1_d, s2_d, _ = route_adaptive(
            t.adj, self._put(base.astype(np.float32)), self._put(src_a),
            self._put(dst_a), self._put(w_a), t.n_real, packed=True,
            dist=self._dist_full(), neigh=t.neigh, **kwargs,
        )
        inter = inter_d.cpu().numpy()
        n1, n2 = decode_segments(
            t.host_adj(), src_a, dst_a, inter, s1_d.cpu().numpy(),
            s2_d.cpu().numpy(), max_len, order=self._order,
        )
        return inter[:n], n1[:n], n2[:n]

    def _resolve_endpoints_array(
        self, db: "TopologyDB", t: TopoTensors, macs: list[str]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Resolve N unique endpoint MACs once -> (edge switch row index,
        final out-port), both [N] int32 with -1 for unresolvable MACs."""
        from sdnmpi_tpu_torch.protocol.openflow import OFPP_LOCAL

        n = len(macs)
        edge = np.full(n, -1, np.int32)
        fport = np.full(n, -1, np.int32)
        for i, mac in enumerate(macs):
            resolved = db._resolve_endpoint(mac)
            if resolved is None:
                continue
            dpid, is_local = resolved
            si = t.index.get(dpid)
            if si is None:
                continue
            edge[i] = si
            fport[i] = OFPP_LOCAL if is_local else db.hosts[mac].port.port_no
        return edge, fport

    def _normalized_base(
        self, db: "TopologyDB", t: TopoTensors, link_util, alpha: float,
        link_capacity: float, n_rows: int,
    ) -> np.ndarray:
        """The Monitor's ``(dpid, port) -> bps`` samples as a ``[V, V]``
        cost in flow-equivalent units: ``(util / cap) * alpha * share``,
        so measured utilization and the balancer's own load are
        comparable in ``cost = base + load``."""
        from sdnmpi_tpu_torch.oracle.congestion import utilization_matrix

        if link_util is not None and not isinstance(link_util, dict):
            raise NotImplementedError(
                "link_util takes the host (dpid, port) -> bps dict; the "
                "device utilization plane is ROADMAP A7"
            )
        n_links = max(1, t.link_count())
        per_link_share = max(1.0, n_rows / n_links)
        cap = max(link_capacity, 1.0)
        util = utilization_matrix(t, link_util or {})
        return (util / cap) * alpha * per_link_share

    def _batch_max_len(
        self, src_idx: np.ndarray, dst_idx: np.ndarray, multiple: int = 8
    ) -> int:
        """Hop budget covering the batch's true maximum distance, rounded
        up to ``multiple``; 0 means nothing is reachable."""
        sel = self._dist[src_idx, dst_idx]
        finite = np.isfinite(sel)
        if not finite.any():
            return 0
        needed = int(sel[finite].max()) + 1
        return ((needed + multiple - 1) // multiple) * multiple

    def _dag_paths_dispatch(
        self,
        t: TopoTensors,
        src_idx: np.ndarray,
        dst_idx: np.ndarray,
        sub_w: np.ndarray,
        base: np.ndarray,
        max_len: int,
        rounds: int,
    ):
        """Launch ``dag.route_collective`` for the sub-flow batch on the
        oracle's device (torch enqueues the work and returns) and hand
        back a zero-argument *reap* closure that copies the slots back
        and decodes them: ``[S, max_len]`` int32 node paths, -1 padded."""
        from sdnmpi_tpu_torch.oracle.batch import pad_flow_batch
        from sdnmpi_tpu_torch.oracle.dag import make_dst_nodes, route_collective

        li, lj = np.nonzero(t.host_adj() > 0)
        util = np.ascontiguousarray(base[li, lj], dtype=np.float32)
        v_eff = self._occ_v(t)
        # rows of the occupied block: its links all lie inside it, and
        # entries >= v_eff read as padding
        neigh_eff = t.neigh[:v_eff]
        if v_eff < t.v:
            adj_eff = t.adj[:v_eff, :v_eff]
            dist_eff = self._dist_full()[:v_eff, :v_eff]
            if isinstance(self._dist_d, list) and v_eff % self.mesh_devices == 0:
                # the occupied block, row-sharded again: each shard's rows
                # of the copy gathered once for this topology version
                rp = v_eff // self.mesh_devices
                dist_eff = [dist_eff[q * rp:(q + 1) * rp]
                            for q in range(self.mesh_devices)]
        else:
            adj_eff, dist_eff = t.adj, self._dist_d
        traffic = np.zeros((v_eff, v_eff), np.float32)
        np.add.at(traffic, (dst_idx, src_idx), sub_w)
        # the destination set restricts the balancing products and the
        # sampler's distance table; where its 128 pad floor reaches V it
        # would do more work than the full contraction, so skip it
        dn = make_dst_nodes(dst_idx)
        put = self._put
        mesh = self._dag_mesh()
        if mesh is not None and v_eff % self.mesh_devices == 0:
            from sdnmpi_tpu_torch.shardplane import route_collective_sharded

            src_p, dst_p = self._pad_flows(src_idx, dst_idx)
            use_dn = len(dn) < v_eff and len(dn) % self.mesh_devices == 0
            slots_sh, maxc_d = route_collective_sharded(
                adj_eff, put(li.astype(np.int32)), put(lj.astype(np.int32)),
                put(util), put(traffic), put(src_p), put(dst_p), mesh,
                levels=max_len - 1, rounds=rounds, max_len=max_len,
                dist=dist_eff, dst_nodes=put(dn) if use_dn else None,
                ring_exchange=self.ring_exchange, neigh=neigh_eff,
            )

            def reap_sharded() -> np.ndarray:
                self.last_fractional_congestion = float(maxc_d)
                _m_frac_congestion.set(self.last_fractional_congestion)
                slots = _host(slots_sh)[: len(src_idx)]
                return self._decode(slots, src_idx, dst_idx)

            return reap_sharded

        if isinstance(dist_eff, list):
            dist_eff = self._dist_full()
        src_p, dst_p = pad_flow_batch(
            np.asarray(src_idx, np.int32), np.asarray(dst_idx, np.int32)
        )
        slots_d, maxc_d = route_collective(
            adj_eff, put(li.astype(np.int32)), put(lj.astype(np.int32)),
            put(util), put(traffic), put(src_p), put(dst_p),
            levels=max_len - 1, rounds=rounds, max_len=max_len,
            dist=dist_eff,  # cached at this topology version: no BFS
            dst_nodes=put(dn) if len(dn) < v_eff else None, neigh=neigh_eff,
        )

        def reap() -> np.ndarray:
            slots = slots_d.cpu().numpy()
            # the balancer's FRACTIONAL max-link bound, kept beside the
            # discrete figure the caller computes from the sampled paths
            self.last_fractional_congestion = float(maxc_d)
            _m_frac_congestion.set(self.last_fractional_congestion)
            return self._decode(slots[: len(src_idx)], src_idx, dst_idx)

        return reap

    def _decode(self, slots, src_idx, dst_idx):
        """Slot decode of the DAG path (C++ when built)."""
        from sdnmpi_tpu_torch import native

        return native.decode_slots(
            slots, self._order, src_idx, dst_idx, complete=True
        )

    def _note_congestion(self, discrete: float, dag: bool) -> None:
        """Record a reaped pass's discrete max-congestion. When the DAG
        balancer routed this pass (``dag``), publish it beside the
        balancer's fractional bound with their ratio; any other pass (the
        greedy scanner, the shortest and adaptive policies) has no
        fractional bound, and clears the pair rather than leave a stale
        one beside its figure."""
        self.last_discrete_congestion = float(discrete)
        _m_disc_congestion.set(self.last_discrete_congestion)
        if dag and discrete > 0 and self.last_fractional_congestion > 0:
            self.last_congestion_ratio = (
                discrete / self.last_fractional_congestion
            )
            _m_congestion_ratio.set(self.last_congestion_ratio)
        elif not dag:
            self.last_fractional_congestion = 0.0
            self.last_congestion_ratio = 0.0
            _m_frac_congestion.set(0.0)
            _m_congestion_ratio.set(0.0)

    def routes_collective(
        self,
        db: "TopologyDB",
        macs: list[str],
        src_idx: np.ndarray,
        dst_idx: np.ndarray,
        policy: str = "balanced",
        **kwargs,
    ):
        """Blocking twin of :meth:`routes_collective_dispatch`: returns
        the collective's :class:`~sdnmpi_tpu_torch.oracle.batch.CollectiveRoutes`."""
        return self.routes_collective_dispatch(
            db, macs, src_idx, dst_idx, policy, **kwargs
        ).reap()

    def routes_collective_dispatch(
        self,
        db: "TopologyDB",
        macs: list[str],
        src_idx: np.ndarray,
        dst_idx: np.ndarray,
        policy: str = "balanced",
        link_util: Optional[dict[tuple[int, int], float]] = None,
        alpha: float = 1.0,
        link_capacity: float = 10e9,
        ecmp_ways: int = 4,
        rounds: int = 2,
        ugal_candidates: int = 4,
        ugal_bias: float = 1.0,
        schedule: Optional[int] = None,
    ):
        """Route an entire collective given in compressed array form,
        split-phase: the device work is launched here and the returned
        :class:`~sdnmpi_tpu_torch.oracle.batch.RouteWindow`'s ``reap()``
        runs the host decode and fdb materialization.

        ``macs`` lists the N unique endpoints once; ``src_idx``/``dst_idx``
        are [F] int32 indices into it. Pairs aggregate to (edge, edge)
        groups, each split into up to ``ecmp_ways`` weighted sub-flows
        (one for ``"shortest"``) whose members are dealt by endpoint hash.
        ``policy`` routes the sub-flows: ``"balanced"`` with the DAG
        balancer and kernel K2, ``"shortest"`` by the device next-hop
        chase (``oracle/paths.batch_paths``), ``"adaptive"`` with the
        UGAL program, whose window completes its device work and decode
        here (only the materialization waits for ``reap()``)."""
        from sdnmpi_tpu_torch import native
        from sdnmpi_tpu_torch.oracle.adaptive import link_loads
        from sdnmpi_tpu_torch.oracle.batch import CollectiveRoutes, RouteWindow

        if schedule is not None:
            raise NotImplementedError(
                "phase-scheduled collectives are ROADMAP A10"
            )
        if policy not in ("balanced", "shortest", "adaptive"):
            raise ValueError(
                f"policy must be 'balanced', 'shortest' or 'adaptive', got {policy!r}"
            )

        t = self.refresh(db)
        src_idx = np.ascontiguousarray(src_idx, dtype=np.int32)
        dst_idx = np.ascontiguousarray(dst_idx, dtype=np.int32)
        f = src_idx.shape[0]
        edge, fport = self._resolve_endpoints_array(db, t, macs)
        final_port = fport[dst_idx]
        vv = t.v * t.v

        def unrouted(n_sub: int, width: int) -> RouteWindow:
            return RouteWindow(result=CollectiveRoutes(
                np.full(f, -1, np.int32), final_port,
                np.full((n_sub, width), -1, np.int64),
                np.full((n_sub, width), -1, np.int32),
                np.zeros(n_sub, np.int32), endpoint_port=fport,
            ))

        # aggregate to unique (edge, edge) groups over the dense [V^2]
        # key space: the C++ kernel fuses the endpoint gathers and the
        # histogram; numpy runs the same computation otherwise
        fused = (
            native.group_pairs(src_idx, dst_idx, edge, t.v)
            if vv <= (16 << 20)
            else None
        )
        if fused is not None:
            key_all, counts_all = fused
            uniq = np.nonzero(counts_all)[0]
            counts = counts_all[uniq]
        else:
            src_sw = edge[src_idx]
            dst_sw = edge[dst_idx]
            ok = (src_sw >= 0) & (dst_sw >= 0)
            all_ok = bool(ok.all())
            if not all_ok and not ok.any():
                return unrouted(0, 1)
            sw_src_ok = src_sw if all_ok else src_sw[ok]
            sw_dst_ok = dst_sw if all_ok else dst_sw[ok]
            key = sw_src_ok * np.int64(t.v) + sw_dst_ok
            if vv <= (16 << 20):
                counts_all = np.bincount(key, minlength=vv)
                uniq = np.nonzero(counts_all)[0]
                counts = counts_all[uniq]
                lookup = np.zeros(vv, np.int64)
                lookup[uniq] = np.arange(len(uniq))
                inv = lookup[key]
            else:
                uniq, inv, counts = np.unique(
                    key, return_inverse=True, return_counts=True
                )
        if not len(uniq):
            return unrouted(0, 1)

        g_src = (uniq // t.v).astype(np.int32)
        g_dst = (uniq % t.v).astype(np.int32)
        ways = 1 if policy == "shortest" else max(1, ecmp_ways)
        nsub = np.minimum(ways, counts).astype(np.int32)
        sub_base = np.zeros(len(uniq), np.int64)
        np.cumsum(nsub[:-1], out=sub_base[1:])
        n_sub = int(nsub.sum())
        sub_src = np.repeat(g_src, nsub)
        sub_dst = np.repeat(g_dst, nsub)
        sub_w = np.repeat((counts / nsub).astype(np.float32), nsub)

        # deal each group's members across its sub-flows by endpoint hash
        if fused is not None:
            lookup = np.zeros(vv, np.int64)
            lookup[uniq] = np.arange(len(uniq))
            pair_sub = native.deal_subflows_keyed(
                key_all, src_idx, dst_idx, lookup, nsub, sub_base
            )
        else:
            dealt = native.deal_subflows(
                inv,
                src_idx if all_ok else src_idx[ok],
                dst_idx if all_ok else dst_idx[ok],
                nsub,
                sub_base,
            )
            if all_ok:
                pair_sub = dealt
            else:
                pair_sub = np.full(f, -1, np.int32)
                pair_sub[ok] = dealt

        max_len = self._batch_max_len(sub_src, sub_dst, multiple=1)
        if max_len == 0:
            return unrouted(n_sub, 1)

        base = self._normalized_base(db, t, link_util, alpha, link_capacity, f)
        inter_h = None
        if policy == "adaptive":
            from sdnmpi_tpu_torch.oracle.adaptive import stitch_paths

            inter_h, n1, n2 = self._adaptive_paths(
                t, sub_src, sub_dst, sub_w, base, max_len, rounds,
                ugal_candidates, ugal_bias,
            )
            stitched = stitch_paths(n1, n2, inter_h)

            def paths_reap() -> np.ndarray:
                return stitched
        elif policy == "shortest":
            from sdnmpi_tpu_torch.oracle.batch import pad_flow_batch
            from sdnmpi_tpu_torch.oracle.paths import batch_paths

            ssrc_p, sdst_p = pad_flow_batch(
                sub_src.astype(np.int32), sub_dst.astype(np.int32)
            )
            nodes_d, _ = batch_paths(
                self._next_full(), self._put(ssrc_p), self._put(sdst_p), max_len
            )

            def paths_reap() -> np.ndarray:
                return nodes_d.cpu().numpy()[:n_sub]
        else:
            paths_reap = self._dag_paths_dispatch(
                t, sub_src.astype(np.int32), sub_dst.astype(np.int32), sub_w,
                base, max_len, rounds,
            )
        sub_dst32 = sub_dst.astype(np.int32)

        def reap():
            paths = paths_reap()
            od, op, ln = native.materialize_fdbs(
                paths, self._port, t.dpids, sub_dst32,
                np.full(n_sub, -1, np.int32),  # final port is per pair
            )
            routes = CollectiveRoutes(
                pair_sub, final_port, od, op, ln, endpoint_port=fport
            )
            # routed members per sub-flow: shift ids by 1 so unresolved
            # pairs (-1) land in bin 0, then zero unroutable sub-flows
            counts_sub = np.bincount(
                pair_sub.astype(np.int64) + 1, minlength=n_sub + 1
            )[1:].astype(np.float32)
            counts_sub[ln == 0] = 0.0
            routes.max_congestion = float(
                link_loads(paths, counts_sub, t.v).max(initial=0.0)
            )
            self._note_congestion(routes.max_congestion, dag=policy == "balanced")
            if inter_h is not None:
                routes.n_detours = int(counts_sub[inter_h >= 0].sum())
            return routes

        return RouteWindow(reap)

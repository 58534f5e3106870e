"""Route oracle: tensorized topology + cached APSP on a torch device.

Counterpart of ``sdnmpi_tpu/oracle/engine.py``, trimmed to the
single-device collective path: the topology becomes dense ``[V, V]``
tensors, all-pairs distances and next hops are computed once per
topology version, and a whole collective is routed by one call of
``oracle/dag.route_collective`` (the DAG balancer plus kernel K2) and
decoded on the host. Every tensor lives on the oracle's ``device``;
nothing moves to another device behind the caller's back.

With ``mesh_devices=n`` the oracle builds a shard mesh
(``shardplane/mesh.py``) and routes collectives through
``shardplane.route_collective_sharded``; with ``shard_oracle`` the
refresh row-shards distances and next hops over it too, and with
``ring_exchange`` the sharded legs stream distances through the ring
kernel K3 instead of replicating them first.

Not ported yet, and raising ``NotImplementedError`` where a caller asks
for them: the incremental repair, the hierarchical oracle, the
utilization plane, the greedy/shortest/adaptive collective policies and
phase scheduling (ROADMAP A5-A13).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

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

        dev = self.device
        li, lj = np.nonzero(t.host_adj() > 0)
        util = np.ascontiguousarray(base[li, lj], dtype=np.float32)
        v_eff = self._occ_v(t)
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

        def put(a):
            return torch.as_tensor(a).to(dev, non_blocking=True)

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
                ring_exchange=self.ring_exchange,
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
            dst_nodes=put(dn) if len(dn) < v_eff else None,
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

    def _note_congestion(self, discrete: float) -> None:
        """Record a reaped balanced pass's discrete max-congestion beside
        the DAG balancer's fractional bound and publish their ratio."""
        self.last_discrete_congestion = float(discrete)
        _m_disc_congestion.set(self.last_discrete_congestion)
        if discrete > 0 and self.last_fractional_congestion > 0:
            self.last_congestion_ratio = (
                discrete / self.last_fractional_congestion
            )
            _m_congestion_ratio.set(self.last_congestion_ratio)

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
        schedule: Optional[int] = None,
    ):
        """Route an entire collective given in compressed array form,
        split-phase: the device work is launched here and the returned
        :class:`~sdnmpi_tpu_torch.oracle.batch.RouteWindow`'s ``reap()``
        runs the host decode and fdb materialization.

        ``macs`` lists the N unique endpoints once; ``src_idx``/``dst_idx``
        are [F] int32 indices into it. Pairs aggregate to (edge, edge)
        groups, each split into up to ``ecmp_ways`` weighted sub-flows
        whose members are dealt by endpoint hash; the sub-flows are
        balanced and sampled on the device. Only ``policy="balanced"``
        is ported."""
        from sdnmpi_tpu_torch import native
        from sdnmpi_tpu_torch.oracle.adaptive import link_loads
        from sdnmpi_tpu_torch.oracle.batch import CollectiveRoutes, RouteWindow

        if schedule is not None:
            raise NotImplementedError(
                "phase-scheduled collectives are ROADMAP A10"
            )
        if policy != "balanced":
            raise NotImplementedError(
                f"collective policy {policy!r} is not ported yet "
                "(ROADMAP A5: shortest; A8: adaptive)"
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
        nsub = np.minimum(max(1, ecmp_ways), counts).astype(np.int32)
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
            self._note_congestion(routes.max_congestion)
            return routes

        return RouteWindow(reap)

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
  with the ``"balanced"``, ``"shortest"`` and ``"adaptive"`` policies,
  in one flat batch or as a phased flow program
  (``routes_collective_phased*``, the scheduler of ``sched/``);
- delta-narrowed re-scoring after a link flap (``routes_batch_delta*``),
  whose refresh absorbs the TopologyDB's delta log by the in-place APSP
  repair of ``oracle/incremental.py`` instead of a full recompute.

``link_util`` is the Monitor's host sample dict or the device
utilization plane (``oracle/utilplane.UtilPlane``).

Every tensor lives on the oracle's ``device``; nothing moves to another
device behind the caller's back.

With ``mesh_devices=n`` the oracle builds a shard mesh
(``shardplane/mesh.py``) and routes balanced collectives through
``shardplane.route_collective_sharded``; with ``shard_oracle`` the
refresh row-shards distances and next hops over it too, and with
``ring_exchange`` the sharded legs stream distances through the ring
kernel K3 instead of replicating them first. Under ``shard_oracle`` the
device chase of pair batches runs flow-sharded on the row-sharded next
hops (``shardplane.batch_fdb_sharded``, or ``batch_fdb_ringed`` under
``ring_exchange``), and with a mesh the adaptive policy runs the
sharded UGAL program (``shardplane.route_adaptive_sharded``). When a
``torch.distributed`` group of several processes is up (``--distributed``,
``shardplane.mesh.init_multihost``), the mesh spans its processes
(``make_multihost_mesh``): each holds an arc of the shards on its own
device and its host results are gathered over the group. Every
sharded dispatch opens a ``shard_dispatch`` span (and a
``shard_exchange`` span where it streams over the ring) and feeds the
``shard_*`` instruments.

The hierarchical two-level oracle (``oracle/hier.py``) subclasses
:class:`RouteOracle` and answers the same entry points.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from sdnmpi_tpu_torch.kernels.bfs import neighbor_rows
from sdnmpi_tpu_torch.oracle.apsp import apsp_distances, apsp_next_hops, occ_bucket
from sdnmpi_tpu_torch.oracle.congestion import (
    route_flows_balanced,
    route_flows_balanced_phases,
    scan_form,
)
from sdnmpi_tpu_torch.utils.metrics import REGISTRY
from sdnmpi_tpu_torch.utils.tracing import NULL_STAGES, STATS, Stages, start_child_span

if TYPE_CHECKING:
    from sdnmpi_tpu_torch.core.topology_db import TopologyDB

_m_repairs = REGISTRY.counter(
    "oracle_repairs_total", "link deltas absorbed by in-place APSP repair"
)
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
# the sharded legs' walls, split into dispatch (enqueue, host work) and
# reap (the blocking copy back and decode of one window); each dispatch
# opens a shard_dispatch span under the Router's ambient span
_m_shard_dispatch_s = REGISTRY.histogram(
    "shard_dispatch_seconds",
    help="sharded-oracle window dispatch (program enqueue) wall seconds",
)
_m_shard_reap_s = REGISTRY.histogram(
    "shard_reap_seconds",
    help="sharded-oracle window reap (transfer + host decode) wall seconds",
)
_m_shard_overlap = REGISTRY.gauge(
    "shard_exchange_overlap_gain",
    "serial exchange+consume wall over the ring-overlapped wall "
    "(config-10 overlap_gain idiom; >1 = exchange hidden behind "
    "consumer compute; authoritative on the bench path)",
)
_m_shard_imbalance = REGISTRY.gauge(
    "shard_occupancy_imbalance",
    "padded-over-real flow rows of the last sharded window dispatch "
    "(real rows sit contiguous at the front of the shard axis, so "
    "this IS the fullest shard's load over the mean — 1.0 = every "
    "shard fully occupied, 2.0 = half the dispatched slots are "
    "padding)",
)
_m_congestion_ratio = REGISTRY.gauge(
    "congestion_discrete_over_fractional",
    "discrete / fractional max-congestion of the last DAG-balanced pass "
    "(1.0 = sampling achieved the bound; the gap is scheduling headroom)",
)
_m_warmup_s = REGISTRY.gauge(
    "serving_warmup_seconds",
    "wall of the last RouteOracle.warm_serving pass (kernel builds or "
    "loads, APSP refresh and window-extraction buckets run before the "
    "first request; with the kernel build directory warm the builds are "
    "loads — see compile_cache_hits_total)",
)


def enable_compile_cache(path: str) -> bool:
    """Keep the CUDA kernels' built libraries under ``path``: the
    counterpart of the reference's persistent compilation cache.

    ``kernels/_build.py`` names each library by a digest of its source
    and flags, so a restarted controller pointed at the same directory
    loads the libraries instead of running ``nvcc`` again. Loads and
    builds are counted in ``compile_cache_hits_total`` and
    ``compile_cache_misses_total``. Returns False for an empty path
    (the package's own ``kernels/build/`` stays in use)."""
    if not path:
        return False
    from sdnmpi_tpu_torch.kernels import _build

    _build.set_build_dir(path)
    return True


def note_exchange_overlap(serial_s: float, overlapped_s: float) -> float:
    """Record the exchange-overlap gain: the serial wall (a blocking
    exchange, then the consumer on the replicated tensors) over the wall
    of the ring-streamed leg. Returns the gain it set."""
    gain = serial_s / max(overlapped_s, 1e-12)
    _m_shard_overlap.set(gain)
    return gain


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


def _host(x, mesh=None) -> np.ndarray:
    """A tensor, or a row-sharded list of them, as one host array; on a
    mesh over several processes the list's blocks come from every
    process."""
    if isinstance(x, list):
        from sdnmpi_tpu_torch.shardplane.mesh import gather_host

        return gather_host(x, mesh)
    return x.cpu().numpy()


def _gather_dist(blocks: list, mesh) -> torch.Tensor:
    """Row-sharded f32 hop counts -> one replicated ``[V, V]`` copy: the
    blocks ride kernel K3 on the 2-byte wire and only this process's
    first shard's gathered copy is unpacked."""
    from sdnmpi_tpu_torch.kernels.ring import (
        pack_dist_wire,
        ring_all_gather,
        unpack_dist_wire,
    )

    v = blocks[mesh.local[0]].shape[1]
    wire = [None if d is None else pack_dist_wire(d, v) for d in blocks]
    return unpack_dist_wire(ring_all_gather(wire, mesh)[mesh.local[0]])


def _touched_rows(nodes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``[F]`` bool: does any valid hop of each -1-padded node row land in
    the dirty-switch mask (``[V]`` bool), computed where the rows are."""
    safe = nodes.long().clamp(min=0)
    return ((nodes >= 0) & mask[safe]).any(dim=1)


def _timed_batch(op: str):
    """Record the wall time and batch size of a routes_* entry point: an
    ``op`` sample in ``STATS`` and an ``oracle`` trace event carrying
    ``n_pairs`` (the length of the call's third argument)."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, db, pairs, *args, **kwargs):
            with STATS.timed(op, n_pairs=len(pairs)):
                return fn(self, db, pairs, *args, **kwargs)

        return wrapper

    return deco


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


class _PhaseScans:
    """The greedy scanner's calls for the balanced phases of one phased
    program. A phase whose call takes S1's resident form
    (``congestion.scan_form``) hands its padded rows, hop budget and base
    to :meth:`add`; once every phase is dispatched, :meth:`launch` uploads
    them together and routes them by one launch of
    ``route_flows_balanced_phases``, a block a phase, each on its own SM.
    A phase that takes the spread form launches ``route_flows_balanced``
    in :meth:`add`, as before. Each phase gets a reader of its
    ``[U_p, max_len_p]`` nodes on the host: the first read of a batched
    phase copies the whole batch home, later reads slice that copy."""

    def __init__(self, oracle: "RouteOracle", t: TopoTensors, chunk: int) -> None:
        self.oracle, self.t, self.chunk = oracle, t, int(chunk)
        self.rows: list = []  # (src, dst, weight) of each held phase
        self.max_lens: list = []
        self.bases: list = []
        self._nodes: Optional[torch.Tensor] = None  # every held phase's nodes
        self._views: list = []  # each held phase's part of them
        self._host: Optional[list] = None

    def add(self, src: np.ndarray, dst: np.ndarray, weight: np.ndarray, max_len: int,
            base):
        o, t = self.oracle, self.t
        if scan_form(t.v, t.neigh.shape[1], self.chunk, len(src)) != "resident":
            nodes_d, _, _ = route_flows_balanced(
                t.adj, o._dist_full(), o._base_tensor(base), o._put(src), o._put(dst),
                o._put(weight), max_len, chunk=self.chunk, neigh=t.neigh,
            )
            return lambda: nodes_d.cpu().numpy()
        q = len(self.max_lens)
        self.rows.append((src, dst, weight))
        self.max_lens.append(int(max_len))
        self.bases.append(base)
        return lambda: self._phase_nodes(q)

    def launch(self) -> None:
        """Route the held phases by one launch; their rows go up as one
        ``[3, U]`` int32 table (source, destination, weight's bits)."""
        o, t = self.oracle, self.t
        counts = [len(r[0]) for r in self.rows]
        src, dst, weight = (np.concatenate(x) for x in zip(*self.rows))
        tab_d = o._put(np.stack([src, dst, weight.view(np.int32)]))
        if any(isinstance(b, torch.Tensor) for b in self.bases):
            bases = torch.stack([o._base_tensor(b) for b in self.bases])
        else:
            bases = o._put(np.stack(self.bases).astype(np.float32, copy=False))
        self._nodes = torch.empty(
            sum(c * m for c, m in zip(counts, self.max_lens)), dtype=torch.int32,
            device=o.device)
        self._views, _ = route_flows_balanced_phases(
            t.adj, o._dist_full(), bases, tab_d[0], tab_d[1],
            tab_d[2].view(torch.float32), np.concatenate([[0], np.cumsum(counts)]),
            self.max_lens, chunk=self.chunk, neigh=t.neigh, out=self._nodes,
        )

    def _phase_nodes(self, q: int) -> np.ndarray:
        if self._host is None:
            flat = self._nodes.cpu().numpy()
            self._host = [flat[n.storage_offset():][:n.numel()].reshape(n.shape)
                          for n in self._views]
        return self._host[q]


class RouteOracle:
    """Per-TopologyDB cache of tensors + APSP results on one device.

    Single-path queries chase next hops on the host against the cached
    matrices; whole collectives run ``dag.route_collective`` on the
    device."""

    #: link deltas the in-place repair (oracle/incremental.py) absorbs
    #: before the refresh recomputes in full; 0 disables the repair (the
    #: reference's ``Config.delta_repair_threshold``)
    delta_repair_threshold: int = 8
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
            from sdnmpi_tpu_torch.shardplane.mesh import (
                make_mesh,
                make_multihost_mesh,
                world,
            )

            if world()[0] > 1:
                # every process of the group holds one arc of the ring
                self._mesh = make_multihost_mesh(mesh_devices, device=self.device)
                self.device = self._mesh.device
            else:
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
        #: replicated copies of row-sharded distances and next hops,
        #: gathered on first use per topology version
        self._dist_full_d: Optional[torch.Tensor] = None
        self._next_full_d: Optional[torch.Tensor] = None
        self._dist_h: Optional[np.ndarray] = None  # lazy host twin
        self._next_h: Optional[np.ndarray] = None  # lazy host twin
        self._port: Optional[np.ndarray] = None
        self._order: Optional[np.ndarray] = None  # sorted-neighbour table
        #: mac -> (row index, final out-port) | None, valid for one
        #: topology version (refresh clears it)
        self._endpoint_memo: dict[str, Optional[tuple[int, int]]] = {}
        #: link deltas absorbed by in-place repair, and full recomputes
        self.repair_count: int = 0
        self.full_refresh_count: int = 0
        self.last_fractional_congestion: float = 0.0
        self.last_discrete_congestion: float = 0.0
        self.last_congestion_ratio: float = 0.0

    def _occ_v(self, t: TopoTensors) -> int:
        """Occupied-bucket V of this topology version (t.v when
        bucketing is off or would not shrink the block)."""
        return occ_bucket(t.n_real, t.v, self.occ_bucket_multiple)

    # -- cache management -------------------------------------------------

    def _try_repair(self, db: "TopologyDB") -> bool:
        """Absorb the version gap by repairing the cached tensors in
        place (``oracle/incremental.py``) when the TopologyDB's delta log
        covers it with at most :attr:`delta_repair_threshold` repairable
        link deltas. Returns True when the cache is current again
        without a full recompute. Never under a distance cap
        (``max_diameter``), whose capped BFS a repair cannot mirror, nor
        with a shard mesh, whose refresh owns its own layout."""
        if (
            self._tensors is None
            or self._version is None
            or not self.delta_repair_threshold
            or self.max_diameter != 0
            or self.mesh_devices
        ):
            return False
        deltas_since = getattr(db, "deltas_since", None)
        deltas = deltas_since(self._version) if deltas_since else None
        if (
            deltas is None
            or not deltas
            or len(deltas) != db.version - self._version
        ):
            return False
        from sdnmpi_tpu_torch.oracle import incremental

        plan = incremental.plan_repair(self._tensors, db, deltas)
        if plan is None:
            return False
        n_edges = len(plan.edges)
        if n_edges > self.delta_repair_threshold:
            return False
        with STATS.timed("oracle_repair", version=db.version, n_edges=n_edges):
            # materialized host twins are patched per delta (only the
            # repaired columns and rows cross to the host); twins never
            # materialized stay lazy
            self._dist_d, self._next_d = incremental.apply_repairs(
                self._tensors, self._dist_d, self._next_d, self._order,
                plan.edges, dist_host=self._dist_h, next_host=self._next_h,
            )
            self._dist_full_d = None
            self._next_full_d = None
            self._port = self._tensors.port_host
            if plan.clear_memo:
                self._endpoint_memo = {}
            self._version = db.version
            self.repair_count += n_edges
            _m_repairs.inc(n_edges)
        return True

    def refresh(self, db: "TopologyDB") -> TopoTensors:
        """Bring tensors, distances and next hops to the topology's
        version: by the in-place repair of the delta log's link deltas
        when it covers the gap (:meth:`_try_repair`), else by a full
        recompute."""
        if self._version != db.version or self._tensors is None:
            if self._try_repair(db):
                return self._tensors
            with STATS.timed("oracle_refresh", version=db.version):
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
                    if self.ring_exchange:
                        from sdnmpi_tpu_torch.kernels.ring import dist_wire_dtype

                        with self._shard_exchange_scope(
                            tensors.v, tensors.v if n_occ == 0 else n_occ,
                            dist_wire_dtype(tensors.v).itemsize,
                        ):
                            nxt = apsp_next_hops_ringed(
                                tensors.adj, dist, mesh, tensors.max_degree,
                                n_occ=n_occ,
                            )
                    else:
                        nxt = apsp_next_hops_rowsharded(
                            tensors.adj, dist, mesh, tensors.max_degree,
                            n_occ=n_occ,
                        )
                elif (
                    mesh is not None
                    and self.max_diameter == 0
                    and mesh.shape["v"] > 1  # v = 1 would just replicate
                    and tensors.v % mesh.shape["v"] == 0
                ):
                    # mesh-only refresh: the BFS row-shards over the "v" axis,
                    # K3 replicates it, the next hops run on one device; on a
                    # mesh over processes every process holds every block
                    # (its own, or crossed by K3) and joins them on its device
                    from sdnmpi_tpu_torch.shardplane import (
                        ShardMesh,
                        apsp_distances_sharded,
                    )

                    nv = mesh.shape["v"]
                    dist = _gather_dist(
                        apsp_distances_sharded(tensors.adj, mesh),
                        ShardMesh([mesh.device] * nv),
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
                self._next_full_d = None
                self._dist_h = None
                self._next_h = None
                self._port = tensors.host_port()
                self._order = native.neighbor_order(tensors.host_adj())
                self._endpoint_memo = {}
                self._version = db.version
                self.full_refresh_count += 1
                _m_full_refreshes.inc()
        return self._tensors

    def warm_serving(self, db: "TopologyDB", shapes=(8, 256)) -> dict:
        """Run the serving path once before the first request.

        On a CUDA device the package's kernels are built (or, with
        :func:`enable_compile_cache` pointing at a warm directory,
        loaded) first. Then the refresh (APSP distances and next hops)
        and one window-extraction dispatch (``oracle/paths.batch_fdb``)
        per requested batch bucket run against the booted topology, with
        the hop budget at the topology's full-diameter bucket. Returns
        ``{"warm_s": wall, "shapes": [...], "max_len": n}``; an empty
        topology costs nothing. The warmed chase is the one the
        configured serving path dispatches: under ``shard_oracle`` the
        sharded chase (ringed under ``ring_exchange``), at buckets that
        are multiples of ``lcm(8, mesh_devices)``."""
        import time as _time

        from sdnmpi_tpu_torch.oracle.batch import bucket_len
        from sdnmpi_tpu_torch.oracle.paths import batch_fdb

        t0 = _time.perf_counter()
        if not getattr(db, "switches", None):
            return {"warm_s": 0.0, "shapes": [], "max_len": 0}
        if self.device.type == "cuda":
            from sdnmpi_tpu_torch.kernels import _build

            _build.load_all()
        t = self.refresh(db)
        dist = self._dist_d if isinstance(self._dist_d, list) else [self._dist_d]
        mx = max(torch.where(torch.isfinite(d), d, 0.0).max().item()
                 for d in dist if d is not None)
        if self._mesh is not None:
            from sdnmpi_tpu_torch.shardplane.mesh import max_over_processes

            mx = max_over_processes(mx, self._mesh)
        max_len = ((int(mx) + 1 + 7) // 8) * 8
        shard_mesh = self._shard_mesh()
        mult = 8 if shard_mesh is None else math.lcm(8, self.mesh_devices)
        warmed = []
        for n in sorted({bucket_len(int(s), mult) for s in shapes if s > 0}):
            zeros = self._put(np.zeros(n, np.int32))
            if shard_mesh is not None:
                from sdnmpi_tpu_torch.shardplane import (
                    batch_fdb_ringed,
                    batch_fdb_sharded,
                )

                chase = batch_fdb_ringed if self.ring_exchange else batch_fdb_sharded
                nodes = chase(
                    self._next_d, t.port, zeros, zeros, zeros, max_len, shard_mesh
                )[0][shard_mesh.local[0]]
            else:
                nodes = batch_fdb(
                    self._next_d, t.port, zeros, zeros, zeros, max_len
                )[0]
            if nodes.is_cuda:
                torch.cuda.synchronize(nodes.device)
            warmed.append(n)
        warm_s = _time.perf_counter() - t0
        _m_warmup_s.set(warm_s)
        return {"warm_s": warm_s, "shapes": warmed, "max_len": max_len}

    @property
    def dist_device(self):
        """The distance matrix of the last ``refresh()`` on the oracle's
        device (None before the first): one ``[V, V]`` tensor, or the
        list of per-shard row blocks under ``shard_oracle``. Lets batch
        callers reuse the distances the refresh already paid for."""
        return self._dist_d

    def matrices(
        self, db: "TopologyDB"
    ) -> tuple[TopoTensors, np.ndarray, np.ndarray]:
        """``(tensors, distances, next hops)`` of the current topology,
        the two matrices as host arrays."""
        t = self.refresh(db)
        return t, self._dist, self._next

    @property
    def _dist(self) -> Optional[np.ndarray]:
        """Host twin of the distance matrix, copied on first use per
        topology version (shard by shard when row-sharded)."""
        if self._dist_h is None and self._dist_d is not None:
            self._dist_h = _host(self._dist_d, self._mesh)
        return self._dist_h

    @property
    def _next(self) -> Optional[np.ndarray]:
        if self._next_h is None and self._next_d is not None:
            self._next_h = _host(self._next_d, self._mesh)
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

    @contextlib.contextmanager
    def _shard_dispatch_scope(self, n_flows: int, n_real: int = 0):
        """A ``shard_dispatch`` child span of the ambient span (the
        Router's ``route_window``/``dispatch``) and a
        ``shard_dispatch_seconds`` sample around one sharded dispatch,
        closed even when the dispatch raises. ``n_real``, the flow count
        before padding, sets ``shard_occupancy_imbalance``: the real rows
        sit at the front of the shard axis, so padded over real is the
        fullest shard's load over the mean."""
        import time

        from sdnmpi_tpu_torch.utils.tracing import start_child_span

        if n_real > 0:
            _m_shard_imbalance.set(n_flows / n_real)
        sp = start_child_span(
            "shard_dispatch", mesh_devices=self.mesh_devices, n_flows=n_flows,
        )
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _m_shard_dispatch_s.observe(time.perf_counter() - t0)
            sp.end()

    @contextlib.contextmanager
    def _shard_exchange_scope(self, v_rows: int, n_cols: int, itemsize: int = 2):
        """A ``shard_exchange`` child span around a ring-streamed leg,
        under ``shard_dispatch`` for windows and under the ambient span
        for the refresh, carrying the wire bytes each shard receives
        (``itemsize`` is the wire word: 2 packed, 4 unpacked). Its
        duration is the enqueue wall; blocking exchange walls go to
        ``shard_exchange_seconds``."""
        from sdnmpi_tpu_torch.kernels.ring import exchange_bytes
        from sdnmpi_tpu_torch.utils.tracing import start_child_span

        sp = start_child_span(
            "shard_exchange",
            exchange_bytes=exchange_bytes(v_rows, n_cols, self.mesh_devices, itemsize),
            mesh_devices=self.mesh_devices,
            ring=True,
        )
        try:
            yield
        finally:
            sp.end()

    @staticmethod
    def _shard_timed_reap(reap_fn):
        """``reap_fn`` timed into ``shard_reap_seconds``: the blocking
        half of a sharded window's dispatch/reap split."""
        import functools
        import time

        @functools.wraps(reap_fn)
        def timed(*args):
            t0 = time.perf_counter()
            try:
                return reap_fn(*args)
            finally:
                _m_shard_reap_s.observe(time.perf_counter() - t0)

        return timed

    def _pad_flows(self, src_idx, dst_idx, weight=None):
        """End-pad a flow batch to a multiple of the shard count with -1
        endpoints (dead flows) and zero weight; the real flows keep their
        global ids, and so their noise. Returns ``(src, dst, weight)``,
        the last None without ``weight``. Callers trim back with
        ``[: len(src_idx)]``."""
        pad = (-len(src_idx)) % self.mesh_devices
        src_p = np.concatenate([src_idx, np.full(pad, -1, np.int32)])
        dst_p = np.concatenate([dst_idx, np.full(pad, -1, np.int32)])
        w_p = (
            None if weight is None
            else np.concatenate([weight, np.zeros(pad, np.float32)])
        )
        return src_p.astype(np.int32), dst_p.astype(np.int32), w_p

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

    def all_shortest_routes(
        self, db: "TopologyDB", src_dpid: int, dst_dpid: int,
        max_paths: Optional[int] = None,
    ) -> tuple[list[list[int]], bool]:
        """Enumerate equal-cost shortest paths, capped at ``max_paths``.

        Walks the shortest-path DAG of the cached distance matrix on the
        host, in ascending-index order. The path count is exponential in
        the worst case, so the walk stops, returning ``truncated=True``,
        once the cap is hit; every DAG branch reaches the destination,
        so the cap bounds the total work. Returns ``(routes, truncated)``.
        """
        if src_dpid == dst_dpid:
            return [[src_dpid]], False
        t = self.refresh(db)
        si = t.index.get(src_dpid)
        di = t.index.get(dst_dpid)
        if si is None or di is None or not np.isfinite(self._dist[si, di]):
            return [], False
        dist = self._dist
        adj = t.host_adj() > 0
        routes: list[list[int]] = []
        stack: list[list[int]] = [[si]]
        while stack:
            acc = stack.pop()
            node = acc[-1]
            if node == di:
                routes.append([int(t.dpids[n]) for n in acc])
                if max_paths is not None and len(routes) >= max_paths:
                    return routes, bool(stack)
                continue
            # reversed push order == ascending-index emission order
            for nxt in np.nonzero(adj[node])[0][::-1]:
                if dist[nxt, di] == dist[node, di] - 1:
                    stack.append(acc + [int(nxt)])
        return routes, False

    def _next_full(self) -> torch.Tensor:
        """The next-hop matrix as one ``[V, V]`` tensor on the oracle's
        device. Row-sharded next hops (``shard_oracle``) are gathered by
        one launch of kernel K3 per topology version (the reference's
        all-gather of its sharded matrix) and this process's first shard's
        copy is kept."""
        if not isinstance(self._next_d, list):
            return self._next_d
        if self._next_full_d is None:
            from sdnmpi_tpu_torch.kernels.ring import ring_all_gather

            mesh = self._dag_mesh()
            self._next_full_d = ring_all_gather(self._next_d, mesh)[mesh.local[0]]
        return self._next_full_d

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

    @_timed_batch("routes_batch")
    def routes_batch(
        self, db: "TopologyDB", pairs: list[tuple[str, str]]
    ) -> list[list[tuple[int, int]]]:
        """Resolve a batch of (src_mac, dst_mac) pairs to shortest-path
        fdbs: :meth:`routes_batch_dispatch` and its reap back to back,
        as per-pair fdb lists."""
        return self.routes_batch_dispatch(db, pairs).reap().fdbs()

    @_timed_batch("routes_batch_delta")
    def routes_batch_delta(
        self, db: "TopologyDB", pairs: list[tuple[str, str]], dirty_dpids
    ):
        """Blocking twin of :meth:`routes_batch_delta_dispatch`: returns
        the window's :class:`~sdnmpi_tpu_torch.oracle.batch.WindowRoutes`
        with ``touched`` set."""
        return self.routes_batch_delta_dispatch(db, pairs, dirty_dpids).reap()

    @_timed_batch("routes_batch_delta_dispatch")
    def routes_batch_delta_dispatch(
        self, db: "TopologyDB", pairs: list[tuple[str, str]], dirty_dpids
    ):
        """Delta-narrowed re-scoring, the oracle leg of the churn
        dataflow: ``pairs`` are the flows a link flap dirtied (their
        installed hops touch ``dirty_dpids``). The refresh absorbs the
        delta log by the in-place repair, so a flap costs O(affected
        pairs), not a full recompute. The pairs route as
        :meth:`routes_batch_dispatch` routes them (shortest paths), and
        the reaped window's ``touched`` flags the pairs whose new path
        crosses a dirtied switch: on the device for the batched leg (the
        dirty set as a ``[V]`` bool mask), on the host otherwise. Batch
        lengths pad to powers of two."""
        t = self.refresh(db)  # delta log -> incremental repair
        uniq = set(dirty_dpids)
        dirty_idx = np.array(
            sorted(t.index[d] for d in uniq if d in t.index), np.int32
        )
        dirty_dpid = np.array(sorted(uniq), np.int64)
        return self.routes_batch_dispatch(
            db, pairs, _dirty=(dirty_idx, dirty_dpid)
        )

    @staticmethod
    def _host_touched(hop_dpid: np.ndarray, dirty_dpid: np.ndarray):
        """``[F]`` bool twin of :func:`_touched_rows` for rows already on
        the host: does the row's dpid sequence meet the dirty set (-1
        pads never do)."""
        return np.isin(hop_dpid, dirty_dpid).any(axis=1)

    @_timed_batch("routes_batch_dispatch")
    def routes_batch_dispatch(
        self, db: "TopologyDB", pairs: list[tuple[str, str]], _dirty=None,
    ):
        """Split-phase shortest-path batch routing: returns a
        :class:`~sdnmpi_tpu_torch.oracle.batch.RouteWindow` whose
        ``reap()`` yields the window's
        :class:`~sdnmpi_tpu_torch.oracle.batch.WindowRoutes`.

        Endpoints resolve on the host. A batch of at most
        :attr:`host_chase_hop_budget` hops chases the cached next hops on
        the host and comes back completed; a larger one is one
        ``oracle/paths.batch_fdb`` call on the device, padded to a
        multiple of 8, that ``reap()`` copies back. Under
        ``shard_oracle`` the batch pads to a multiple of
        ``lcm(8, mesh_devices)`` and the row-sharded next hops are chased
        flow-sharded (``shardplane.batch_fdb_ringed`` under
        ``ring_exchange``, else ``batch_fdb_sharded``).

        ``_dirty`` is the delta entry point's ``(dirty row indices, dirty
        dpids)``; with it the window's ``touched`` is set."""
        from sdnmpi_tpu_torch.oracle.batch import (
            RouteWindow,
            WindowRoutes,
            pad_flow_batch,
        )
        from sdnmpi_tpu_torch.oracle.paths import batch_fdb

        t = self.refresh(db)
        results: list[list[tuple[int, int]]] = [[] for _ in pairs]
        rows = self._resolve_rows(db, pairs, t, results)

        def _finish(wr: WindowRoutes) -> WindowRoutes:
            if _dirty is not None:
                wr.touched = self._host_touched(wr.hop_dpid, _dirty[1])
            return wr

        if not rows:
            return RouteWindow(result=_finish(WindowRoutes.from_fdbs(results)))

        src_idx = np.array([r[1] for r in rows], dtype=np.int32)
        dst_idx = np.array([r[2] for r in rows], dtype=np.int32)
        final_port = np.array([r[3] for r in rows], dtype=np.int32)
        max_len = self._batch_max_len(src_idx, dst_idx)
        if max_len == 0:
            return RouteWindow(result=_finish(WindowRoutes.from_fdbs(results)))

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
            return RouteWindow(result=_finish(WindowRoutes.from_fdbs(results)))

        shard_mesh = self._shard_mesh()
        # shard-divisible buckets: the flow axis splits over every shard
        # (pow2 tiers of an lcm floor stay divisible)
        mult = 8 if shard_mesh is None else math.lcm(8, self.mesh_devices)
        src_p, dst_p, fport_p = pad_flow_batch(
            src_idx, dst_idx, final_port, multiple=mult,
            pow2=_dirty is not None,
        )
        if shard_mesh is not None:
            from sdnmpi_tpu_torch.shardplane import (
                batch_fdb_ringed,
                batch_fdb_sharded,
            )

            with self._shard_dispatch_scope(len(src_p), len(src_idx)):
                if self.ring_exchange:
                    # the next-hop rows ride the ring as int16 wire words
                    # (int32 past the index bound) into the gated chase
                    from sdnmpi_tpu_torch.kernels.ring import NEXT_WIRE_MAX_V

                    wire_item = 2 if t.v <= NEXT_WIRE_MAX_V else 4
                    with self._shard_exchange_scope(t.v, t.v, wire_item):
                        blocks = batch_fdb_ringed(
                            self._next_d, t.port, self._put(src_p),
                            self._put(dst_p), self._put(fport_p), max_len,
                            shard_mesh,
                        )
                else:
                    blocks = batch_fdb_sharded(
                        self._next_d, t.port, self._put(src_p),
                        self._put(dst_p), self._put(fport_p), max_len,
                        shard_mesh,
                    )
            if shard_mesh.multiprocess:
                # each process's blocks stay per shard; the reap gathers
                # every process's onto every host
                nodes_d, ports_d, length_d = blocks
            else:
                # the shards sit on one device: their blocks join there
                nodes_d, ports_d, length_d = (torch.cat(b) for b in blocks)
        else:
            nodes_d, ports_d, length_d = batch_fdb(
                self._next_d, t.port, self._put(src_p), self._put(dst_p),
                self._put(fport_p), max_len,
            )
        touched_d = None
        if _dirty is not None:
            mask = np.zeros(t.v, bool)
            mask[_dirty[0]] = True
            mask_d = self._put(mask)
            touched_d = (_touched_rows(nodes_d, mask_d) if not isinstance(nodes_d, list)
                         else [None if x is None else _touched_rows(x, mask_d)
                               for x in nodes_d])
        pair_rows = np.array([r[0] for r in rows], dtype=np.int64)
        n_pairs = len(pairs)
        dpids = t.dpids
        mesh = self._mesh

        def reap() -> WindowRoutes:
            n_rows = len(pair_rows)
            nodes = _host(nodes_d, mesh)[:n_rows]
            ports = _host(ports_d, mesh)[:n_rows]
            length = _host(length_d, mesh)[:n_rows]
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
            fallbacks = [k for k, fdb in enumerate(results) if fdb]
            for k in fallbacks:  # merge the scalar-path pairs back in
                wr.set_fdb(k, results[k])
            if touched_d is not None:
                touched = np.zeros(n_pairs, bool)
                touched[pair_rows] = _host(touched_d, mesh)[:n_rows]
                if fallbacks:
                    touched[fallbacks] = self._host_touched(
                        wr.hop_dpid[fallbacks], _dirty[1]
                    )
                wr.touched = touched
            return wr

        return RouteWindow(
            self._shard_timed_reap(reap) if shard_mesh is not None else reap
        )

    @_timed_batch("routes_batch_balanced")
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

    @_timed_batch("routes_batch_balanced_dispatch")
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
                t.adj, self._dist_full(), self._base_tensor(base),
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

    @_timed_batch("routes_batch_adaptive")
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
        batch pads to the shard count instead and runs the sharded
        program (``shardplane.route_adaptive_sharded``): flows split over
        the shards, the batch's traffic summed once, hash streams keyed
        by global flow id, so the real flows choose as on one device."""
        from sdnmpi_tpu_torch.oracle.adaptive import decode_segments, route_adaptive
        from sdnmpi_tpu_torch.oracle.batch import pad_flow_batch

        n = len(src_idx)
        kwargs = dict(
            levels=max_len - 1, rounds=rounds, max_len=max_len,
            n_candidates=ugal_candidates, bias=ugal_bias,
        )
        mesh = self._dag_mesh()
        if mesh is not None:
            from sdnmpi_tpu_torch.shardplane import route_adaptive_sharded
            from sdnmpi_tpu_torch.shardplane.mesh import gather_host

            src_p, dst_p, w_p = self._pad_flows(
                np.asarray(src_idx, np.int32), np.asarray(dst_idx, np.int32),
                np.asarray(weight, np.float32),
            )
            with self._shard_dispatch_scope(len(src_p), len(src_idx)):
                inter_sh, s1_sh, s2_sh, _ = route_adaptive_sharded(
                    t.adj, self._base_tensor(base), self._put(src_p),
                    self._put(dst_p), self._put(w_p), t.n_real, mesh,
                    packed=True, dist=self._dist_full(), neigh=t.neigh,
                    **kwargs,
                )
            # every process's shards' flows, on every process's host
            inter = gather_host(inter_sh, mesh)
            n1, n2 = decode_segments(
                t.host_adj(), src_p, dst_p, inter, gather_host(s1_sh, mesh),
                gather_host(s2_sh, mesh), max_len, order=self._order,
            )
            return inter[:n], n1[:n], n2[:n]
        src_a, dst_a = pad_flow_batch(
            np.asarray(src_idx, np.int32), np.asarray(dst_idx, np.int32)
        )
        w_a = np.zeros(len(src_a), np.float32)
        w_a[:n] = np.asarray(weight, np.float32)
        inter_d, s1_d, s2_d, _ = route_adaptive(
            t.adj, self._base_tensor(base), self._put(src_a),
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
    ):
        """The measured utilization as a ``[V, V]`` cost in
        flow-equivalent units: ``(util / cap) * alpha * share``, so
        measured utilization and the balancer's own load are comparable
        in ``cost = base + load``.

        ``link_util`` is the Monitor's ``(dpid, port) -> bps`` host dict
        (rebuilt into a numpy matrix per call) or a
        :class:`~sdnmpi_tpu_torch.oracle.utilplane.UtilPlane`, which is
        synced to the topology, flushed, and read as a device tensor of
        its published epoch. Both compute the same f32 operations in the
        same order, so the two bases are bit-equal.

        The two forms are kept, as the reference keeps them: the dict's
        base is the differential oracle, and its consumers (the per-link
        gather of the DAG leg, the packer's background sums) read it in
        numpy, whose f32 sums the CPU tests hold bit-equal to the
        reference's; a device reduction sums in another order. The
        plane's base stays on the device, so a plane-fed call moves no
        ``[V, V]`` matrix. :meth:`_base_tensor` uploads the dict's base
        where a device program needs it."""
        from sdnmpi_tpu_torch.oracle.congestion import utilization_matrix
        from sdnmpi_tpu_torch.oracle.utilplane import UtilPlane

        n_links = max(1, t.link_count())
        per_link_share = max(1.0, n_rows / n_links)
        cap = max(link_capacity, 1.0)
        if isinstance(link_util, UtilPlane):
            link_util.sync(db, t)
            link_util.flush()  # staged Monitor samples -> this epoch
            return link_util.base(alpha, cap, per_link_share)
        util = utilization_matrix(t, link_util or {})
        return (util / cap) * alpha * per_link_share

    def _base_tensor(self, base) -> torch.Tensor:
        """A base cost (numpy from the host dict, or the plane's device
        tensor) as an f32 tensor on the oracle's device."""
        if isinstance(base, torch.Tensor):
            return base
        return self._put(base.astype(np.float32))

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
        back a *reap* closure that copies the slots back and decodes them:
        ``[S, max_len]`` int32 node paths, -1 padded. A staged caller
        passes the reap its :class:`~sdnmpi_tpu_torch.utils.tracing.Stages`
        (the collective's reap: ``wait``, then ``decode``)."""
        from sdnmpi_tpu_torch.oracle.batch import pad_flow_batch
        from sdnmpi_tpu_torch.oracle.dag import make_dst_nodes, route_collective

        li, lj = np.nonzero(t.host_adj() > 0)
        put = self._put
        if isinstance(base, torch.Tensor):
            # the plane's base: the per-link gather stays on the device
            util = base[put(li.astype(np.int64)), put(lj.astype(np.int64))]
        else:
            util = put(np.ascontiguousarray(base[li, lj], dtype=np.float32))
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
                dist_eff = [dist_eff[q * rp:(q + 1) * rp] if q in self._mesh.local
                            else None for q in range(self.mesh_devices)]
        else:
            adj_eff, dist_eff = t.adj, self._dist_d
        traffic = np.zeros((v_eff, v_eff), np.float32)
        np.add.at(traffic, (dst_idx, src_idx), sub_w)
        # the destination set restricts the balancing products and the
        # sampler's distance table; where its 128 pad floor reaches V it
        # would do more work than the full contraction, so skip it
        dn = make_dst_nodes(dst_idx)
        mesh = self._dag_mesh()
        if mesh is not None and v_eff % self.mesh_devices == 0:
            from sdnmpi_tpu_torch.shardplane import route_collective_sharded

            src_p, dst_p, _ = self._pad_flows(src_idx, dst_idx)
            use_dn = len(dn) < v_eff and len(dn) % self.mesh_devices == 0
            if self.ring_exchange:
                from sdnmpi_tpu_torch.kernels.ring import dist_wire_dtype

                exch_scope = self._shard_exchange_scope(
                    v_eff, v_eff, dist_wire_dtype(v_eff).itemsize
                )
            else:
                exch_scope = contextlib.nullcontext()
            with self._shard_dispatch_scope(len(src_p), len(src_idx)), exch_scope:
                slots_sh, maxc_d = route_collective_sharded(
                    adj_eff, put(li.astype(np.int32)), put(lj.astype(np.int32)),
                    util, put(traffic), put(src_p), put(dst_p), mesh,
                    levels=max_len - 1, rounds=rounds, max_len=max_len,
                    dist=dist_eff, dst_nodes=put(dn) if use_dn else None,
                    ring_exchange=self.ring_exchange, neigh=neigh_eff,
                )

            @self._shard_timed_reap
            def reap_sharded(stages: Stages = NULL_STAGES) -> np.ndarray:
                stages.stage("wait")
                self.last_fractional_congestion = float(maxc_d)
                _m_frac_congestion.set(self.last_fractional_congestion)
                slots = _host(slots_sh, mesh)[: len(src_idx)]
                stages.stage("decode")
                return self._decode(slots, src_idx, dst_idx)

            return reap_sharded

        if isinstance(dist_eff, list):
            dist_eff = self._dist_full()
        src_p, dst_p = pad_flow_batch(
            np.asarray(src_idx, np.int32), np.asarray(dst_idx, np.int32)
        )
        slots_d, maxc_d = route_collective(
            adj_eff, put(li.astype(np.int32)), put(lj.astype(np.int32)),
            util, put(traffic), put(src_p), put(dst_p),
            levels=max_len - 1, rounds=rounds, max_len=max_len,
            dist=dist_eff,  # cached at this topology version: no BFS
            dst_nodes=put(dn) if len(dn) < v_eff else None, neigh=neigh_eff,
        )

        def reap(stages: Stages = NULL_STAGES) -> np.ndarray:
            stages.stage("wait")
            slots = slots_d.cpu().numpy()
            # the balancer's FRACTIONAL max-link bound, kept beside the
            # discrete figure the caller computes from the sampled paths
            self.last_fractional_congestion = float(maxc_d)
            _m_frac_congestion.set(self.last_fractional_congestion)
            stages.stage("decode")
            return self._decode(slots[: len(src_idx)], src_idx, dst_idx)

        return reap

    def _decode(self, slots, src_idx, dst_idx):
        """Slot decode of the DAG path (C++ when built)."""
        from sdnmpi_tpu_torch import native

        return native.decode_slots(
            slots, self._order, src_idx, dst_idx, complete=True
        )

    def _note_congestion(
        self, discrete: float, dag: bool, phase: bool = False
    ) -> None:
        """Record a reaped pass's discrete max-congestion. When the DAG
        balancer routed this pass (``dag``), publish it beside the
        balancer's fractional bound with their ratio; any other pass (the
        greedy scanner, the shortest and adaptive policies) has no
        fractional bound, and clears the pair rather than leave a stale
        one beside its figure. A phased program's per-phase batch
        (``phase``) records nothing: its figures would pair a phase's max
        with the last flat pass's bound (the program's own figures are
        the Router's ``sched_program_*`` gauges)."""
        if phase:
            return
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

    @_timed_batch("routes_collective")
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
        the collective's :class:`~sdnmpi_tpu_torch.oracle.batch.CollectiveRoutes`
        or, with ``schedule=``, the
        :class:`~sdnmpi_tpu_torch.sched.program.PhasedFlowProgram` with
        every phase reaped."""
        if kwargs.get("schedule") is not None:
            program = self.routes_collective_dispatch(
                db, macs, src_idx, dst_idx, policy, **kwargs
            )
            program.reap_all()
            return program
        return self.routes_collective_dispatch(
            db, macs, src_idx, dst_idx, policy, **kwargs
        ).reap()

    @_timed_batch("routes_collective_dispatch")
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
        _phase_scan: Optional[_PhaseScans] = None,
        _phase: Optional[int] = None,
    ):
        """Route an entire collective given in compressed array form,
        split-phase: the device work is launched here and the returned
        :class:`~sdnmpi_tpu_torch.oracle.batch.RouteWindow`'s ``reap()``
        runs the host decode and fdb materialization.

        ``macs`` lists the N unique endpoints once; ``src_idx``/``dst_idx``
        are [F] int32 indices into it. Pairs aggregate to (edge, edge)
        groups, each split into up to ``ecmp_ways`` weighted sub-flows
        (one for ``"shortest"``) whose members are dealt by endpoint hash.
        ``policy`` routes the sub-flows: ``"shortest"`` by the device
        next-hop chase (``oracle/paths.batch_paths``), ``"adaptive"`` with
        the UGAL program, whose window completes its device work and
        decode here (only the materialization waits for ``reap()``), and
        ``"balanced"``, or any other name as in the reference, with the
        DAG balancer and kernel K2.

        ``schedule`` not None routes the collective as a phased flow
        program instead (:meth:`routes_collective_phased_dispatch`; 0 =
        auto phase count, K > 0 that many, rounded up to a power of two)
        and returns its
        :class:`~sdnmpi_tpu_torch.sched.program.PhasedFlowProgram`.
        ``_phase_scan`` and ``_phase`` are the phased dispatch's: the
        first, the program's :class:`_PhaseScans`, routes a balanced phase
        with the greedy scanner at its chunk width, members dealt
        round-robin by their rank in the group, and where the scanner
        takes the resident form it launches the phase together with the
        program's other phases after the last one is dispatched; the
        second, the phase's id, keeps the phase out of the flat
        congestion figures.

        With tracing live (a sink armed, or the profiler recording) the
        call is a ``collective`` span (``n_pairs``, ``policy``, and
        ``phase`` for a phase) of stages ``resolve``, ``group``,
        ``deal``, ``enqueue`` (the hop budget), ``base``, ``enqueue`` (the
        policy's device leg, uploads included), and its reap a
        ``collective_reap`` span of ``wait``, ``decode`` (the DAG leg),
        ``fdbs`` and ``congestion``."""
        from sdnmpi_tpu_torch import native
        from sdnmpi_tpu_torch.oracle.adaptive import link_loads
        from sdnmpi_tpu_torch.oracle.batch import CollectiveRoutes, RouteWindow

        if schedule is not None:
            return self.routes_collective_phased_dispatch(
                db, macs, src_idx, dst_idx, policy,
                n_phases=int(schedule), link_util=link_util, alpha=alpha,
                link_capacity=link_capacity, ecmp_ways=ecmp_ways,
                rounds=rounds, ugal_candidates=ugal_candidates,
                ugal_bias=ugal_bias,
            )

        fields = {"n_pairs": len(src_idx), "policy": policy}
        if _phase is not None:
            fields["phase"] = _phase
        with Stages(start_child_span("collective", **fields)) as st:
            st.stage("resolve")
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

            st.stage("group")
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

            st.stage("deal")
            # deal each group's members across its sub-flows by endpoint hash
            if _phase_scan is not None:
                # exact round-robin deal (phased leg only): the phase-grain
                # scanner balances each sub-flow as carrying exactly sub_w
                # members, so members are dealt by their rank in the group
                if fused is not None:
                    lookup = np.zeros(vv, np.int64)
                    lookup[uniq] = np.arange(len(uniq))
                    okm = key_all >= 0
                    all_ok = bool(okm.all())
                    inv_ok = lookup[key_all if all_ok else key_all[okm]]
                else:
                    okm = ok
                    inv_ok = inv
                order = np.argsort(inv_ok, kind="stable")
                starts = np.zeros(len(uniq), np.int64)
                np.cumsum(counts[:-1], out=starts[1:])
                g_ord = inv_ok[order]
                pos = np.arange(len(g_ord), dtype=np.int64) - starts[g_ord]
                dealt = np.empty(len(g_ord), np.int32)
                dealt[order] = (sub_base[g_ord] + pos % nsub[g_ord]).astype(np.int32)
                if all_ok:
                    pair_sub = dealt
                else:
                    pair_sub = np.full(f, -1, np.int32)
                    pair_sub[okm] = dealt
            elif fused is not None:
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

            st.stage("enqueue")
            max_len = self._batch_max_len(sub_src, sub_dst, multiple=1)
            if max_len == 0:
                return unrouted(n_sub, 1)

            st.stage("base")
            base = self._normalized_base(db, t, link_util, alpha, link_capacity, f)
            st.stage("enqueue")
            inter_h = None
            if policy == "balanced" and _phase_scan is not None:
                # phase-grain scanner leg (phased dispatch only): a phase is a
                # small near-matching, and the greedy scanner routes each
                # sub-flow against the load every earlier one placed, which
                # lands each phase within about one flow of its split
                from sdnmpi_tpu_torch.oracle.batch import pad_flow_batch
    
                src_p, dst_p = pad_flow_batch(
                    sub_src.astype(np.int32), sub_dst.astype(np.int32), pow2=True,
                )
                w_p = np.zeros(len(src_p), np.float32)
                w_p[:n_sub] = sub_w
                phase_nodes = _phase_scan.add(src_p, dst_p, w_p, max_len, base)

                def paths_reap(stages: Stages) -> np.ndarray:
                    stages.stage("wait")
                    return phase_nodes()[:n_sub]
            elif policy == "adaptive":
                from sdnmpi_tpu_torch.oracle.adaptive import stitch_paths

                inter_h, n1, n2 = self._adaptive_paths(
                    t, sub_src, sub_dst, sub_w, base, max_len, rounds,
                    ugal_candidates, ugal_bias,
                )
                stitched = stitch_paths(n1, n2, inter_h)

                def paths_reap(stages: Stages) -> np.ndarray:
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

                def paths_reap(stages: Stages) -> np.ndarray:
                    stages.stage("wait")
                    return nodes_d.cpu().numpy()[:n_sub]
            else:
                paths_reap = self._dag_paths_dispatch(
                    t, sub_src.astype(np.int32), sub_dst.astype(np.int32), sub_w,
                    base, max_len, rounds,
                )
            sub_dst32 = sub_dst.astype(np.int32)

            st.done()

            def reap():
                with Stages(start_child_span("collective_reap", **fields)) as rs:
                    paths = paths_reap(rs)
                    rs.stage("fdbs")
                    od, op, ln = native.materialize_fdbs(
                        paths, self._port, t.dpids, sub_dst32,
                        np.full(n_sub, -1, np.int32),  # final port is per pair
                    )
                    routes = CollectiveRoutes(
                        pair_sub, final_port, od, op, ln, endpoint_port=fport
                    )
                    rs.stage("congestion")
                    # routed members per sub-flow: shift ids by 1 so unresolved
                    # pairs (-1) land in bin 0, then zero unroutable sub-flows
                    counts_sub = np.bincount(
                        pair_sub.astype(np.int64) + 1, minlength=n_sub + 1
                    )[1:].astype(np.float32)
                    counts_sub[ln == 0] = 0.0
                    routes.max_congestion = float(
                        link_loads(paths, counts_sub, t.v).max(initial=0.0)
                    )
                    self._note_congestion(
                        routes.max_congestion, dag=policy == "balanced",
                        phase=_phase is not None or _phase_scan is not None,
                    )
                    if inter_h is not None:
                        routes.n_detours = int(counts_sub[inter_h >= 0].sum())
                    return routes

            return RouteWindow(reap)

    # -- phased collectives (sched/) -----------------------------------------

    @_timed_batch("routes_collective_phased")
    def routes_collective_phased(
        self,
        db: "TopologyDB",
        macs: list[str],
        src_idx: np.ndarray,
        dst_idx: np.ndarray,
        policy: str = "balanced",
        n_phases: int = 0,
        **kwargs,
    ):
        """Blocking twin of :meth:`routes_collective_phased_dispatch`:
        every phase reaped in order before the program returns."""
        program = self.routes_collective_phased_dispatch(
            db, macs, src_idx, dst_idx, policy, n_phases=n_phases, **kwargs
        )
        program.reap_all()
        return program

    @_timed_batch("routes_collective_phased_dispatch")
    def routes_collective_phased_dispatch(
        self,
        db: "TopologyDB",
        macs: list[str],
        src_idx: np.ndarray,
        dst_idx: np.ndarray,
        policy: str = "balanced",
        n_phases: int = 0,
        link_util=None,
        alpha: float = 1.0,
        link_capacity: float = 10e9,
        scan_chunk: int = 1,
        **kwargs,
    ):
        """Decompose a collective into phases and route each one.

        The collective's pairs aggregate into (edge switch, edge switch)
        traffic groups as the flat path groups them
        (``sched.phases.aggregate_groups``); the greedy link-load-aware
        packer (``sched.pack_phases``, on the oracle's device) puts the
        groups into ``n_phases`` phases (0 = auto,
        :func:`~sdnmpi_tpu_torch.sched.choose_n_phases`), seeded with the
        per-switch sums of the normalized base, so measured load steers
        the packing; each phase's pairs then dispatch through
        :meth:`routes_collective_dispatch` as their own batch, all of them
        before this returns. A balanced phase routes with the greedy
        scanner at ``scan_chunk`` (``_phase_scan``), its groups split
        toward weight-1 sub-flows under ``PHASE_SUBFLOW_BUDGET``; the
        phases whose scans take S1's resident form are launched together
        after the last phase's dispatch, a block a phase
        (:class:`_PhaseScans`). Shortest and adaptive phases route as
        their flat batches would.

        Returns a :class:`~sdnmpi_tpu_torch.sched.program.PhasedFlowProgram`;
        pairs whose endpoints do not resolve are in no phase
        (``pair_phase == -1``). With tracing live the call is a ``phased``
        span: a ``pack`` stage (refresh, resolve, grouping, the base's
        sums and the packer), each phase's ``collective``, and an
        ``enqueue`` stage where the phases' scans launch together."""
        from sdnmpi_tpu_torch.sched import choose_n_phases, pack_phases
        from sdnmpi_tpu_torch.sched.phases import (
            PHASE_SUBFLOW_BUDGET,
            aggregate_groups,
        )
        from sdnmpi_tpu_torch.sched.program import PhasedFlowProgram, PhasePlan

        phased = start_child_span("phased", n_pairs=len(src_idx), policy=policy)
        with Stages(phased) as st:
            st.stage("pack")
            t = self.refresh(db)
            src_idx = np.ascontiguousarray(src_idx, dtype=np.int32)
            dst_idx = np.ascontiguousarray(dst_idx, dtype=np.int32)
            f = src_idx.shape[0]
            edge, _ = self._resolve_endpoints_array(db, t, macs)
            src_sw = edge[src_idx]
            dst_sw = edge[dst_idx]
            ok = (src_sw >= 0) & (dst_sw >= 0)
            pair_phase = np.full(f, -1, np.int32)
            k = choose_n_phases(0, n_phases)
            group_phase = np.empty(0, np.int32)
            if ok.any():
                _, uniq, inv, _, g_src, g_dst, w_pack = aggregate_groups(
                    src_sw[ok], dst_sw[ok], t.v
                )
                k = choose_n_phases(len(uniq), n_phases)
                # per-switch background load from the same normalized base the
                # balancer scores with; a plane's base reduces on the device
                base = self._normalized_base(
                    db, t, link_util, alpha, link_capacity, max(1, f)
                )
                if isinstance(base, torch.Tensor):
                    util_out, util_in = base.sum(dim=1), base.sum(dim=0)
                else:
                    b = np.asarray(base, np.float32)
                    util_out = b.sum(axis=1, dtype=np.float32)
                    util_in = b.sum(axis=0, dtype=np.float32)
                group_phase = pack_phases(
                    g_src, g_dst, w_pack, k, t.v, util_out, util_in,
                    device=self.device,
                )
                pair_phase[ok] = group_phase[inv]

            st.done()
            phases: list = []
            scans = _PhaseScans(self, t, scan_chunk)
            for p in range(k):
                sel = np.nonzero(pair_phase == p)[0]
                if not len(sel):
                    continue  # the packer left this phase empty
                phase_kwargs = dict(kwargs)
                phase_kwargs["_phase"] = p
                if policy == "balanced":
                    n_groups = max(1, int((group_phase == p).sum()))
                    phase_kwargs["ecmp_ways"] = max(
                        phase_kwargs.get("ecmp_ways", 4),
                        -(-PHASE_SUBFLOW_BUDGET // n_groups),
                    )
                    phase_kwargs["_phase_scan"] = scans
                window = self.routes_collective_dispatch(
                    db, macs, src_idx[sel], dst_idx[sel], policy,
                    link_util=link_util, alpha=alpha,
                    link_capacity=link_capacity, **phase_kwargs,
                )
                phases.append(PhasePlan(p, sel, window))
            if scans.rows:
                st.stage("enqueue")
                scans.launch()
            return PhasedFlowProgram(k, pair_phase, phases)

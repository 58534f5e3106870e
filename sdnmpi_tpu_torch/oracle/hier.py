"""Hierarchical two-level path oracle: escaping the dense [V, V] ceiling.

Counterpart of ``sdnmpi_tpu/oracle/hier.py`` on a torch device. Every
other oracle path holds a dense ``[V, V]`` tensor: fine at V ~ 4k,
hopeless at datacenter scale (V = 65,536 is 16 GiB per f32 plane).
Regular fabrics compress, and this module exploits it:

**Level 1 — dense pod blocks.** The fabric's
:class:`~sdnmpi_tpu_torch.topogen.podmap.PodMap` (generator-emitted, or
the partitioner fallback) groups switches into pods; each pod's
``[S, S]`` intra-pod APSP runs as batched matmuls, stacked per size
bucket (``shardplane/hier.py``, split over the shard mesh when one
exists). Memory is ``O(pods * pod_size^2)``.

**Level 2 — the border skeleton.** Pod borders (switches with an
inter-pod link) form a skeleton graph: intra-pod edges weighted by the
pod block's border-to-border distances, inter-pod edges weighted 1.
Shortest distances on the skeleton equal those in the full graph, so the
hierarchy is EXACT: path lengths equal the dense oracle's (next-hop ties
may differ). Rows of the border-distance plane materialize lazily per
destination pod by vectorized pull-sweeps and are cached until the
delta log invalidates them.

**Composition.** For a query (s in pod A, d in pod B):

    dist(s, d) = min over (b1 in borders(A), b2 in borders(B)) of
                 dA(s, b1) + D(b1, b2) + dB(b2, d)

(same-pod pairs also consider the pure intra-pod path, which wins length
ties). Among equal-length border choices the least-loaded pair wins
(utilization steering never changes a length). Hops reconstruct by
chasing the pod blocks' next hops between borders and splicing inter-pod
link ports from the skeleton's candidate table.

**Churn.** The delta log repairs in place: an intra-pod link delta
recomputes ONE pod block (plus the cheap level-2 structure); an
inter-pod delta touches only level 2; host deltas touch nothing but the
endpoint memo. Structural mutations rebuild.

Selected by ``Config.hier_oracle`` via :class:`HierOracle`, a
:class:`~sdnmpi_tpu_torch.oracle.engine.RouteOracle` subclass answering
every TopologyDB seam in the same ``WindowRoutes``/``CollectiveRoutes``
contracts. The pod blocks are always computed on the oracle's device;
border rows sweep on the device with a mesh and on the host
(:func:`sweep_rows_host`) without one, as in the reference.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from sdnmpi_tpu_torch.oracle.batch import bucket_len, bucket_pow2
from sdnmpi_tpu_torch.oracle.engine import RouteOracle, _Phase, _timed_batch
from sdnmpi_tpu_torch.utils.metrics import REGISTRY
from sdnmpi_tpu_torch.utils.tracing import STATS

if TYPE_CHECKING:
    from sdnmpi_tpu_torch.core.topology_db import TopologyDB

log = logging.getLogger(__name__)

_m_pods = REGISTRY.gauge(
    "hier_pods", "pods of the hierarchical oracle's current PodMap"
)
_m_borders = REGISTRY.gauge(
    "hier_border_switches", "border switches in the level-2 skeleton"
)
_m_block_repairs = REGISTRY.counter(
    "hier_block_repairs_total",
    "intra-pod link deltas absorbed by single-pod block recomputes "
    "(instead of a full hierarchy rebuild)",
)
_m_l2_refreshes = REGISTRY.counter(
    "hier_l2_refreshes_total",
    "level-2 skeleton (border layer) rebuilds — inter-pod deltas pay "
    "only this, never the pod blocks",
)
_m_full_builds = REGISTRY.counter(
    "hier_full_builds_total", "full two-level hierarchy builds"
)
_m_rows = REGISTRY.counter(
    "hier_border_rows_total",
    "lazily materialized border-distance plane rows",
)
_m_row_hits = REGISTRY.counter(
    "hier_border_cache_hits_total",
    "destination pods served straight from the cached border-distance "
    "row plane (no sweep)",
)
_m_row_misses = REGISTRY.counter(
    "hier_border_cache_misses_total",
    "destination pods whose border-distance rows had to be swept in "
    "(cold or post-invalidation)",
)
_m_row_evictions = REGISTRY.counter(
    "hier_border_cache_evictions_total",
    "cached border-distance rows dropped by delta-log invalidation "
    "(level-2 rebuilds evict the whole plane — rows are global "
    "distances)",
)
_m_rows_cached = REGISTRY.gauge(
    "hier_border_rows_cached",
    "border-distance rows currently resident in the concatenated "
    "serving plane",
)
_m_warm_s = REGISTRY.gauge(
    "hier_warm_seconds",
    "wall seconds of the last hier warm_serving pass (refresh + "
    "serving-set rows + the pow2 program ladder)",
)
_m_snap_rejected = REGISTRY.counter(
    "hier_snapshot_rejected_total",
    "persisted border planes refused at restore (topology digest or "
    "version mismatch) — the oracle degrades to a cold build, never "
    "a crash",
)
_m_pod_imbalance = REGISTRY.gauge(
    "hier_pod_imbalance",
    "padded-over-real cells of the stacked pod blocks (sum of "
    "bucket-padded s^2 over sum of true pod-size^2): the size-bucket "
    "padding tax of the current PodMap — 1.0 = every pod exactly "
    "fills its bucket",
)


@dataclasses.dataclass
class _Bucket:
    """One pod-size bucket: every pod whose member count pads to the
    same ``s`` shares stacked ``[nP, s, s]`` block tensors (static jit
    shapes; shardplane/hier.py shards the pod axis over the mesh)."""

    pods: np.ndarray  # [nP] pod ids
    s: int
    adj: np.ndarray  # [nP, s, s] f32 host
    port: np.ndarray  # [nP, s, s] int32 host
    dist: Optional[np.ndarray] = None  # [nP, s, s] f32 host mirror
    nxt: Optional[np.ndarray] = None  # [nP, s, s] int32 host mirror
    #: device-resident twins: lists of per-shard blocks when a mesh
    #: exists (the arrays the per-shard device bytes account), else None
    dist_d: object = None
    nxt_d: object = None


class HierState:
    """The two-level oracle's state for one topology version.

    Duck-compatible with the slice of ``TopoTensors`` the shared
    RouteOracle plumbing reads (``index``/``dpids``/``v``/``n_real``),
    so endpoint resolution, the delta-narrowed entry point, and the
    collective group aggregation run unchanged on it.
    """

    def __init__(self) -> None:
        self.dpids: Optional[np.ndarray] = None  # [V] int64 sorted
        self.index: dict[int, int] = {}
        self.v: int = 0
        self.n_real: int = 0
        self.podmap = None
        self.n_pods: int = 0
        self.pod_of_g: Optional[np.ndarray] = None  # [V] int32
        self.local_of_g: Optional[np.ndarray] = None  # [V] int32
        self.pods_members: list[np.ndarray] = []  # per pod, sorted gidx
        self.buckets: list[_Bucket] = []
        self.pod_bucket: Optional[np.ndarray] = None  # [P] int32
        self.pod_slot: Optional[np.ndarray] = None  # [P] int32
        # borders (pod-major global numbering)
        self.n_borders: int = 0
        self.border_gidx: Optional[np.ndarray] = None  # [B] int32
        self.border_pod: Optional[np.ndarray] = None  # [B] int32
        self.border_local: Optional[np.ndarray] = None  # [B] int32
        self.pod_bstart: Optional[np.ndarray] = None  # [P+1] int64
        self.border_id_of_g: Optional[np.ndarray] = None  # [V] int32, -1
        # skeleton candidate CSR (forward out-edges of each border)
        self.cstart: Optional[np.ndarray] = None  # [B+1] int64
        self.ccand: Optional[np.ndarray] = None  # [nnz] int32 target
        self.cw: Optional[np.ndarray] = None  # [nnz] f32 weight
        self.cport: Optional[np.ndarray] = None  # [nnz] int32 (-1 intra)
        #: degree-bucketed UNIFORM candidate tables — the sweep
        #: executors' form of the CSR (one [nB, K] gather + reshape-min
        #: per bucket instead of a segmented reduce; ~10x on the
        #: reduction at datacenter scale). Per bucket: (border ids
        #: [nB], cand [nB, K] int32 — pads point at the border itself,
        #: weights [nB, K] f32 — pads inf).
        self.deg_buckets: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        #: per-degree-bucket out-port tables parallel to ``deg_buckets``
        #: (same [nB, K] layout, -1 = intra-pod candidate) plus the
        #: border -> (bucket, row) index — the batched hop walk's
        #: (oracle/hierpath.py) descent tables
        self.desc_ports: list[np.ndarray] = []
        self.desc_bucket: Optional[np.ndarray] = None  # [B] int32
        self.desc_pos: Optional[np.ndarray] = None  # [B] int64
        #: lazy border-distance plane: pod -> [b_pod, B] f32 rows, where
        #: row j is dist(every border -> pod border j). THE level-2
        #: serving tensor; O(active pods x B), never [B, B] unless
        #: every pod is queried. Rows are VIEWS into the concatenated
        #: ``plane_h`` buffer below.
        self.rows: dict[int, np.ndarray] = {}
        #: device twins of the row cache (sharded when a mesh exists)
        self.rows_d: dict[int, object] = {}
        #: the concatenated border-row serving plane: every
        #: materialized pod's rows stacked append-only into one
        #: ``[cap, B]`` f32 buffer (pow2 cap growth -> the fused
        #: composition kernel recompiles O(log B) times, never per
        #: shape), with ``plane_base[pod]`` the pod's row offset (-1 =
        #: absent) and a lazily uploaded device twin the composition
        #: gathers from without per-route copies.
        self.plane_h: Optional[np.ndarray] = None
        self.plane_base: Optional[np.ndarray] = None  # [P] int64
        self.plane_len: int = 0
        self.plane_d: object = None
        #: the mesh (and ring flag) the device executors run on; set at
        #: build so lazy row materialization lands on the same devices
        self.mesh = None
        self.ring: bool = False
        #: the oracle's torch device: the pod blocks, the row sweeps and
        #: the composition plane live there
        self.device = torch.device("cpu")

    # -- memory accounting -------------------------------------------------

    def oracle_bytes(self) -> int:
        """Total bytes of the hierarchy's serving tensors (blocks +
        candidate table + materialized rows) — the quantity that stays
        O(pods * pod_size^2 + B_active * B) where the dense oracle
        pays O(V^2)."""
        total = 0
        for b in self.buckets:
            for a in (b.adj, b.port, b.dist, b.nxt):
                if a is not None:
                    total += a.nbytes
        for a in (self.ccand, self.cw, self.cport):
            if a is not None:
                total += a.nbytes
        if self.plane_h is not None:
            total += self.plane_h.nbytes
        else:
            for r in self.rows.values():
                total += r.nbytes
        return total

    def device_bytes(self) -> int:
        """Bytes of the device-resident tensors (the sharded pod stacks
        + row planes); per shard is this over the shard count (row/pod
        axes shard evenly, ``shardplane.hier.hier_device_bytes``)."""
        total = 0
        for b in self.buckets:
            for a in (b.dist_d, b.nxt_d):
                for x in (a if isinstance(a, list) else [a]):
                    if x is not None:
                        total += x.numel() * x.element_size()
        for r in self.rows_d.values():
            total += r.numel() * r.element_size()
        if self.plane_d is not None:
            total += self.plane_d.numel() * self.plane_d.element_size()
        return total

    # -- level 2: lazy border-distance rows --------------------------------

    def _plane_append(self, p: int, block: np.ndarray) -> None:
        """Append one pod's border-distance rows to the concatenated
        serving plane (pow2 capacity growth; the device twin drops and
        re-uploads lazily on the next fused composition)."""
        bp = block.shape[0]
        need = self.plane_len + bp
        if self.plane_h is None or self.plane_h.shape[0] < need:
            cap = 32
            while cap < need:
                cap *= 2
            fresh = np.full((cap, self.n_borders), np.inf, np.float32)
            if self.plane_len:
                fresh[: self.plane_len] = self.plane_h[: self.plane_len]
            self.plane_h = fresh
            # the rows dict holds views into the old buffer: re-point
            for q in list(self.rows):
                b0 = int(self.plane_base[q])
                if b0 >= 0:
                    bq = int(
                        self.pod_bstart[q + 1] - self.pod_bstart[q]
                    )
                    self.rows[q] = self.plane_h[b0:b0 + bq]
        base = self.plane_len
        self.plane_h[base:base + bp] = block
        self.plane_base[p] = base
        self.plane_len = need
        self.rows[p] = self.plane_h[base:base + bp]
        self.plane_d = None

    def plane_device(self):
        """The twin of the concatenated row plane, a tensor on the
        oracle's device — uploaded once per materialization event
        (append invalidates), NOT per route; the fused composition
        gathers from it with zero per-call copies."""
        if self.plane_d is None and self.plane_h is not None:
            self.plane_d = torch.as_tensor(self.plane_h).to(self.device)
        return self.plane_d

    def ensure_rows(self, pods) -> None:
        """Materialize the border-distance plane rows for ``pods``
        (dist from EVERY border to each pod's borders) if missing —
        one batched pull-sweep for all missing pods together, on the
        mesh's devices when one exists."""
        wanted = sorted(
            p for p in {int(q) for q in pods}
            if self.pod_bstart[p + 1] > self.pod_bstart[p]
        )
        missing = [p for p in wanted if p not in self.rows]
        if len(wanted) > len(missing):
            _m_row_hits.inc(len(wanted) - len(missing))
        if not missing:
            return
        _m_row_misses.inc(len(missing))
        targets = np.concatenate([
            np.arange(self.pod_bstart[p], self.pod_bstart[p + 1])
            for p in missing
        ]).astype(np.int64)
        with STATS.timed("hier_rows", n_rows=len(targets)):
            if self.mesh is not None:
                from sdnmpi_tpu_torch.shardplane.hier import sweep_rows_sharded

                rows, rows_d = sweep_rows_sharded(
                    self.deg_buckets, self.n_borders, targets, self.mesh,
                )
            else:
                rows = sweep_rows_host(
                    self.deg_buckets, self.n_borders, targets
                )
                rows_d = None
        off = 0
        for p in missing:
            bp = int(self.pod_bstart[p + 1] - self.pod_bstart[p])
            self._plane_append(p, rows[off:off + bp])
            if rows_d is not None:
                self.rows_d[p] = rows_d[off:off + bp]
            off += bp
        _m_rows.inc(len(targets))
        _m_rows_cached.set(self.plane_len)


def sweep_rows_host(
    deg_buckets,
    n_borders: int,
    targets: np.ndarray,
    row_chunk: int = 128,
) -> np.ndarray:
    """Border-distance rows by vectorized pull-sweeps (host executor).

    ``R[j, u] = dist(border u -> border targets[j])`` over the
    skeleton's degree-bucketed candidate tables: each Jacobi sweep
    relaxes every border ``u`` against all its out-candidates
    (``R[j, u] <- min(R[j, u], w(u, c) + R[j, c])``) with one
    ``[rows, nB, K]`` gather + reshape-min per bucket, repeating until
    a fixpoint — the sweep count is the max *segment* count of any
    border-to-border shortest path, never B. Row-chunked so the
    gathered intermediates stay bounded.

    The device executor (shardplane/hier.py ``sweep_rows_sharded``) is
    the same Jacobi schedule sharded over the row axis; a differential
    test pins them bit-equal (tests/test_torch_hier.py).
    """
    t = len(targets)
    out = np.full((t, n_borders), np.inf, np.float32)
    out[np.arange(t), targets] = 0.0
    if not deg_buckets:
        return out
    for lo in range(0, t, row_chunk):
        r = out[lo:lo + row_chunk]
        while True:
            rn = r.copy()
            for ids, cand, w in deg_buckets:
                vals = r[:, cand.reshape(-1)].reshape(
                    r.shape[0], *cand.shape
                ) + w
                rn[:, ids] = np.minimum(rn[:, ids], vals.min(axis=2))
            if np.array_equal(rn, r):
                break
            r[:] = rn
    return out


def _collect_edges(db: "TopologyDB", index: dict[int, int]):
    """One walk over the link dictionaries -> (src_gidx, dst_gidx,
    src_port) int32 arrays (the only O(E) host pass of a build)."""
    src, dst, prt = [], [], []
    for s, dst_map in db.links.items():
        si = index[s]
        for d, link in dst_map.items():
            src.append(si)
            dst.append(index[d])
            prt.append(link.src.port_no)
    return (
        np.array(src, np.int32), np.array(dst, np.int32),
        np.array(prt, np.int32),
    )


def build_state(
    db: "TopologyDB",
    podmap,
    mesh=None,
    ring: bool = False,
    only_pods: Optional[set] = None,
    prev: Optional[HierState] = None,
    device="cuda",
) -> HierState:
    """Build (or block-repair) the two-level state from ``db``; the pod
    blocks run on ``device`` (the mesh's when there is one).

    ``only_pods`` + ``prev`` is the repair path: only the named pods'
    blocks recompute (the refresh classifier guarantees membership is
    unchanged), untouched pod blocks carry over, and level 2 — the
    cheap layer — rebuilds unconditionally.
    """
    from sdnmpi_tpu_torch.shardplane.hier import (
        _host_stack,
        pod_stack_apsp,
        pod_stack_apsp_async,
        shard_pod_stack,
    )

    state = HierState()
    state.podmap = podmap
    state.mesh = mesh
    state.ring = bool(ring)
    state.device = mesh.device if mesh is not None else torch.device(device)

    # node set: every dpid mentioned anywhere, like tensorize()
    dpid_set = set(db.switches)
    for s, dst_map in db.links.items():
        dpid_set.add(s)
        dpid_set.update(dst_map)
    for host in db.hosts.values():
        dpid_set.add(host.port.dpid)
    dpids = np.array(sorted(dpid_set), np.int64)
    state.dpids = dpids
    state.index = {int(d): i for i, d in enumerate(dpids)}
    state.v = state.n_real = len(dpids)
    state.n_pods = podmap.n_pods

    pod_of_g = np.full(state.v, -1, np.int32)
    for dpid, pod in podmap.pod_of.items():
        i = state.index.get(dpid)
        if i is not None:
            pod_of_g[i] = pod
    if state.v and (pod_of_g < 0).any():
        raise ValueError("PodMap does not cover the live dpid set")
    state.pod_of_g = pod_of_g
    local_of_g = np.zeros(state.v, np.int32)
    members: list[np.ndarray] = []
    for p in range(state.n_pods):
        m = np.nonzero(pod_of_g == p)[0].astype(np.int32)  # sorted
        members.append(m)
        local_of_g[m] = np.arange(len(m), dtype=np.int32)
    state.local_of_g = local_of_g
    state.pods_members = members

    src_g, dst_g, port_g = _collect_edges(db, state.index)
    if len(src_g):
        intra = pod_of_g[src_g] == pod_of_g[dst_g]
    else:
        intra = np.zeros(0, bool)

    # -- buckets: stacked [nP, s, s] blocks per padded pod size ----------
    sizes = np.array([len(m) for m in members], np.int64)
    state.pod_bucket = np.full(state.n_pods, -1, np.int32)
    state.pod_slot = np.full(state.n_pods, -1, np.int32)
    by_s: dict[int, list[int]] = {}
    for p in range(state.n_pods):
        if sizes[p]:
            by_s.setdefault(bucket_len(int(sizes[p]), 8), []).append(p)
    prev_slot: dict[int, tuple[int, int]] = {}
    if prev is not None:
        for bi, b in enumerate(prev.buckets):
            for sl, p in enumerate(b.pods):
                prev_slot[int(p)] = (bi, sl)
    for s in sorted(by_s):
        pods_b = np.array(by_s[s], np.int32)
        nP = len(pods_b)
        bi = len(state.buckets)
        state.pod_bucket[pods_b] = bi
        state.pod_slot[pods_b] = np.arange(nP, dtype=np.int32)
        state.buckets.append(_Bucket(
            pods_b, s,
            np.zeros((nP, s, s), np.float32),
            np.full((nP, s, s), -1, np.int32),
        ))
    # scatter intra-pod edges into their bucket stacks (vectorized)
    if intra.any():
        ei = np.nonzero(intra)[0]
        pods_e = pod_of_g[src_g[ei]]
        b_e = state.pod_bucket[pods_e]
        sl_e = state.pod_slot[pods_e]
        ls = local_of_g[src_g[ei]]
        ld = local_of_g[dst_g[ei]]
        pe = port_g[ei]
        for bi, b in enumerate(state.buckets):
            m = b_e == bi
            if m.any():
                b.adj[sl_e[m], ls[m], ld[m]] = 1.0
                b.port[sl_e[m], ls[m], ld[m]] = pe[m]

    # -- level 1: per-bucket stacked APSP (dense kernels, vmapped) -------
    # overlap: every bucket's APSP is enqueued on the device first; the
    # level-2 border/structure derivation (which needs only adjacency +
    # membership) runs while the device grinds; the host mirrors
    # materialize after, and the distance-dependent level-2 finish
    # consumes them. Same numbers, less serialized wall.
    pend: list[tuple[_Bucket, object, object, int, bool]] = []
    for b in state.buckets:
        carried = False
        if prev is not None and only_pods is not None:
            # carry untouched blocks when the bucket layout is
            # unchanged (repair path: membership is identical)
            pbi = [prev_slot.get(int(p)) for p in b.pods]
            same = (
                all(x is not None for x in pbi)
                and len({x[0] for x in pbi}) == 1
                and prev.buckets[pbi[0][0]].s == b.s
                and [x[1] for x in pbi] == list(range(len(b.pods)))
                and np.array_equal(prev.buckets[pbi[0][0]].pods, b.pods)
                and prev.buckets[pbi[0][0]].dist is not None
            )
            if same:
                pb = prev.buckets[pbi[0][0]]
                dirty = [
                    i for i, p in enumerate(b.pods) if int(p) in only_pods
                ]
                b.dist = pb.dist if not dirty else pb.dist.copy()
                b.nxt = pb.nxt if not dirty else pb.nxt.copy()
                if dirty:
                    d2, n2 = pod_stack_apsp(
                        b.adj[dirty], mesh=None, device=state.device
                    )
                    b.dist[dirty] = d2
                    b.nxt[dirty] = n2
                    _m_block_repairs.inc(len(dirty))
                if dirty and pb.dist_d is not None and mesh is not None:
                    # the device twins feed the ring-exchanged border
                    # plane — carrying them stale would rebuild level 2
                    # from pre-delta distances; re-shard the repaired
                    # pods' blocks (in the process that holds them)
                    b.dist_d = _repair_twin(pb.dist_d, b.dist, dirty, mesh)
                    b.nxt_d = _repair_twin(pb.nxt_d, b.nxt, dirty, mesh)
                else:
                    b.dist_d, b.nxt_d = pb.dist_d, pb.nxt_d
                carried = True
        if not carried:
            dd, nd, nn, sharded = pod_stack_apsp_async(
                b.adj, mesh, state.device
            )
            pend.append((b, dd, nd, nn, sharded))

    # -- level 2 structure: overlaps the in-flight APSP dispatches -------
    pre = _derive_borders(state, src_g, dst_g, intra)

    for b, dd, nd, nn, sharded in pend:
        b.dist = _host_stack(dd, mesh)[:nn]
        b.nxt = _host_stack(nd, mesh)[:nn]
        if mesh is not None:
            if sharded:
                # the padded device output already carries the
                # shard_pod_stack layout — keep it as the resident twin
                # (pad-slot content differs from zero-fill, but no
                # consumer reads pad rows: the ring exchange gathers
                # only the nP real rows)
                b.dist_d, b.nxt_d = dd, nd
            else:
                b.dist_d = shard_pod_stack(b.dist, mesh)
                b.nxt_d = shard_pod_stack(b.nxt, mesh)

    # -- level 2 finish: the distance-dependent skeleton weights ---------
    _finish_level2(state, src_g, dst_g, port_g, intra, pre)
    _m_pods.set(state.n_pods)
    _m_borders.set(state.n_borders)
    real_cells = int((sizes * sizes).sum())
    if real_cells:
        padded_cells = sum(
            len(b.pods) * b.s * b.s for b in state.buckets
        )
        _m_pod_imbalance.set(padded_cells / real_cells)
    return state


def _repair_twin(twin: list, host: np.ndarray, dirty: list, mesh) -> list:
    """A pod-sharded device twin after a block repair: the blocks of
    this process's shards that hold a repaired pod (slots ``dirty``) are
    uploaded again from the repaired ``host`` stack (the
    :func:`~sdnmpi_tpu_torch.shardplane.hier.shard_pod_stack` layout),
    every other block carries over."""
    per = twin[mesh.local[0]].shape[0]
    out = list(twin)
    for q in sorted({i // per for i in dirty} & set(mesh.local)):
        blk = np.zeros((per, *host.shape[1:]), host.dtype)
        part = host[q * per:(q + 1) * per]
        blk[:len(part)] = part
        out[q] = torch.as_tensor(blk).to(mesh.devices[q])
    return out


def _derive_borders(state: HierState, src_g, dst_g, intra):
    """The distance-independent half of level 2: derive the border
    arrays and numbering from adjacency + membership alone (vectorized
    — at 65k switches the old per-border Python loop was a measurable
    slice of refresh). Split out so ``build_state`` can run it while
    the pod-block APSP dispatches are still in flight on the devices.
    Returns the inter-edge index array ``_finish_level2`` consumes."""
    v = state.v
    inter_idx = (
        np.nonzero(~intra)[0] if len(intra) else np.zeros(0, np.int64)
    )
    border_mask = np.zeros(max(v, 1), bool)
    if len(inter_idx):
        border_mask[src_g[inter_idx]] = True
        border_mask[dst_g[inter_idx]] = True

    border_id_of_g = np.full(max(v, 1), -1, np.int32)
    gb = np.nonzero(border_mask[:v])[0] if v else np.zeros(0, np.int64)
    pods_b = (
        state.pod_of_g[gb] if len(gb) else np.zeros(0, np.int32)
    )
    # pod-major, members ascending within each pod — gb is ascending
    # and the stable sort preserves it, matching the old loop's order
    order = np.argsort(pods_b, kind="stable")
    gb, pods_b = gb[order], pods_b[order]
    bid = len(gb)
    border_id_of_g[gb] = np.arange(bid, dtype=np.int32)
    pod_bstart = np.zeros(state.n_pods + 1, np.int64)
    np.cumsum(
        np.bincount(pods_b, minlength=state.n_pods), out=pod_bstart[1:]
    )
    state.n_borders = bid
    state.border_gidx = gb.astype(np.int32)
    state.border_pod = pods_b.astype(np.int32)
    state.border_local = (
        state.local_of_g[gb].astype(np.int32)
        if len(gb) else np.zeros(0, np.int32)
    )
    state.pod_bstart = pod_bstart
    state.border_id_of_g = border_id_of_g
    return inter_idx


def _finish_level2(
    state: HierState, src_g, dst_g, port_g, intra, inter_idx
) -> None:
    """The distance-dependent half of level 2: skeleton candidate CSR
    (intra edges weighted by the pod blocks' border-to-border
    distances, inter edges weight 1), degree-bucketed candidate
    tables, and the row-cache reset. Cheap relative to the pod blocks:
    O(E_inter + the sum of border-set squares). Under ``state.ring``
    the intra-pod border-distance blocks arrive over the ring exchange
    (kernel K3) from the pod-sharded device stacks instead of a host
    gather (bit-identical)."""
    pod_bstart = state.pod_bstart
    border_id_of_g = state.border_id_of_g
    bid = state.n_borders

    # intra border->border distance blocks: over the ring when armed,
    # a host slice of the pod blocks otherwise — bit-identical
    planes = None
    if state.ring and state.mesh is not None and bid:
        from sdnmpi_tpu_torch.shardplane.hier import ring_exchange_border_plane

        planes = ring_exchange_border_plane(state)

    srcs, tgts, ws, prts = [], [], [], []
    for p in range(state.n_pods):
        lo, hi = int(pod_bstart[p]), int(pod_bstart[p + 1])
        bp = hi - lo
        if bp < 2:
            continue
        bi = int(state.pod_bucket[p])
        sl = int(state.pod_slot[p])
        bl = state.border_local[lo:hi]
        if planes is not None:
            block = planes[bi][sl, :bp][:, bl]
        else:
            block = state.buckets[bi].dist[sl][np.ix_(bl, bl)]
        i, j = np.nonzero(np.isfinite(block) & ~np.eye(bp, dtype=bool))
        if len(i):
            srcs.append(lo + i.astype(np.int64))
            tgts.append(lo + j.astype(np.int64))
            ws.append(block[i, j].astype(np.float32))
            prts.append(np.full(len(i), -1, np.int32))
    if len(inter_idx):
        u = border_id_of_g[src_g[inter_idx]].astype(np.int64)
        w_ = border_id_of_g[dst_g[inter_idx]].astype(np.int64)
        pp = port_g[inter_idx]
        # dedupe parallel cables per (u, w): keep the lowest port
        order = np.lexsort((pp, w_, u))
        u, w_, pp = u[order], w_[order], pp[order]
        keep = np.ones(len(u), bool)
        keep[1:] = (u[1:] != u[:-1]) | (w_[1:] != w_[:-1])
        srcs.append(u[keep])
        tgts.append(w_[keep])
        ws.append(np.ones(int(keep.sum()), np.float32))
        prts.append(pp[keep])

    if srcs:
        csrc = np.concatenate(srcs)
        ccand = np.concatenate(tgts).astype(np.int32)
        cw = np.concatenate(ws).astype(np.float32)
        cport = np.concatenate(prts).astype(np.int32)
        order = np.lexsort((ccand, csrc))
        csrc, ccand = csrc[order], ccand[order]
        cw, cport = cw[order], cport[order]
        cstart = np.zeros(state.n_borders + 1, np.int64)
        np.cumsum(
            np.bincount(csrc, minlength=state.n_borders), out=cstart[1:]
        )
    else:
        ccand = np.zeros(0, np.int32)
        cw = np.zeros(0, np.float32)
        cport = np.zeros(0, np.int32)
        cstart = np.zeros(state.n_borders + 1, np.int64)
    state.cstart, state.ccand, state.cw, state.cport = (
        cstart, ccand, cw, cport,
    )
    (
        state.deg_buckets, state.desc_ports,
        state.desc_bucket, state.desc_pos,
    ) = _degree_buckets(cstart, ccand, cw, cport, state.n_borders)
    state.rows = {}
    state.rows_d = {}
    state.plane_h = None
    state.plane_base = np.full(max(state.n_pods, 1), -1, np.int64)
    state.plane_len = 0
    state.plane_d = None
    _m_rows_cached.set(0)
    _m_l2_refreshes.inc()


def _build_level2(
    state: HierState, src_g, dst_g, port_g, intra
) -> None:
    """Borders + skeleton in one pass (the non-overlapped form — see
    ``build_state`` for the split that hides the structure derivation
    behind the in-flight APSP dispatches)."""
    inter_idx = _derive_borders(state, src_g, dst_g, intra)
    _finish_level2(state, src_g, dst_g, port_g, intra, inter_idx)


def _degree_buckets(cstart, ccand, cw, cport, n_borders: int):
    """Uniform candidate tables per out-degree bucket (pow2, floor 8):
    the sweep executors gather ``[rows, nB, K]`` and reduce with one
    reshape-min per bucket — ~10x the segmented reduce at datacenter
    scale, at <= 2x the gathered bytes. Pad slots point at the border
    itself with inf weight (self-relaxation is a no-op). Table rows
    preserve CSR (candidate-ascending) order, reals before pads, so an
    argmin over a row picks the same first-minimum winner as a scalar
    argmin over the CSR slice — the batched descent (hierpath) relies
    on it.

    Returns ``(buckets, port_tables, border_bucket, border_pos)``:
    ``port_tables[i]`` mirrors ``buckets[i]``'s [nB, K] layout with the
    out-ports (-1 = intra-pod edge, pads -1), and border u lives at row
    ``border_pos[u]`` of bucket ``border_bucket[u]``."""
    counts = np.diff(cstart)
    buckets: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    ports: list[np.ndarray] = []
    border_bucket = np.full(max(n_borders, 1), -1, np.int32)
    border_pos = np.zeros(max(n_borders, 1), np.int64)
    if not n_borders or not len(ccand):
        return buckets, ports, border_bucket, border_pos
    k_of = np.maximum(counts, 1)
    k_of = 2 ** np.ceil(np.log2(np.maximum(k_of, 8))).astype(np.int64)
    for k in np.unique(k_of):
        ids = np.nonzero(k_of == k)[0].astype(np.int64)
        nb = len(ids)
        cand = np.repeat(ids.astype(np.int32)[:, None], k, axis=1)
        w = np.full((nb, int(k)), np.inf, np.float32)
        prt = np.full((nb, int(k)), -1, np.int32)
        cnt = counts[ids]
        if cnt.sum():
            rowrep = np.repeat(np.arange(nb), cnt)
            colidx = np.arange(int(cnt.sum())) - np.repeat(
                np.cumsum(cnt) - cnt, cnt
            )
            srcpos = colidx + np.repeat(cstart[ids], cnt)
            cand[rowrep, colidx] = ccand[srcpos]
            w[rowrep, colidx] = cw[srcpos]
            prt[rowrep, colidx] = cport[srcpos]
        bi = len(buckets)
        border_bucket[ids] = bi
        border_pos[ids] = np.arange(nb)
        buckets.append((ids, cand, w))
        ports.append(prt)
    return buckets, ports, border_bucket, border_pos


# -- query composition ----------------------------------------------------


class _Composer:
    """Vectorized hierarchy composition for one resolved query batch."""

    def __init__(
        self, state: HierState, steer: Optional[np.ndarray],
        fused: bool = False,
    ):
        self.st = state
        #: per-switch utilization score (the pod-aggregated view of
        #: the Monitor samples); breaks ties among equal-length border
        #: choices ONLY — lengths are steering-invariant
        self.steer = steer
        #: route the composition through the fused device kernel
        #: (kernels/hiercompose.py) over the concatenated row plane
        #: instead of the per-pod host gather chain — bit-identical
        #: (fenced), pow2-bucketed operands, warm-ladder pre-run
        self.fused = bool(fused)

    # -- vectorized block reads -------------------------------------------

    def _pod_dist(self, pods, a_locals, b_locals) -> np.ndarray:
        st = self.st
        out = np.full(len(pods), np.inf, np.float32)
        bkt = st.pod_bucket[pods]
        for bi, b in enumerate(st.buckets):
            m = bkt == bi
            if m.any():
                out[m] = b.dist[
                    st.pod_slot[pods[m]], a_locals[m], b_locals[m]
                ]
        return out

    def _border_dists(self, pods, locals_, to_border: bool):
        """[n, bmax] dist between each (pod, local) and its pod's
        borders (inf-padded): member->border when ``to_border`` else
        border->member."""
        st = self.st
        counts = (
            st.pod_bstart[pods + 1] - st.pod_bstart[pods]
        ).astype(np.int64)
        bmax = int(counts.max(initial=0))
        out = np.full((len(pods), bmax), np.inf, np.float32)
        if bmax == 0:
            return out, counts
        bkt = st.pod_bucket[pods]
        cols = np.arange(bmax)
        for bi, b in enumerate(st.buckets):
            m = np.nonzero(bkt == bi)[0]
            if not len(m):
                continue
            p = pods[m]
            valid = cols[None, :] < counts[m][:, None]
            # pad slots gather local index 0 (always inside this
            # bucket's block) and mask to inf below — clamping to a
            # neighboring pod's border id would resolve to ANOTHER
            # bucket's local index and can exceed this block's s (a
            # zero-border severed pod)
            bl = np.where(
                valid,
                st.border_local[np.where(
                    valid, st.pod_bstart[p][:, None] + cols[None, :], 0
                )],
                0,
            )
            sl = st.pod_slot[p][:, None]
            if to_border:
                vals = b.dist[sl, locals_[m][:, None], bl]
            else:
                vals = b.dist[sl, bl, locals_[m][:, None]]
            out[m] = np.where(valid, vals, np.inf)
        return out, counts

    # -- the two-level length + border choice ------------------------------

    def compose(self, si, di):
        """For [n] source/dest global switch indices: ``(total [n] f32
        — inf = unreachable, b1 [n], b2 [n] border ids — -1 = pure
        intra-pod route)``."""
        st = self.st
        n = len(si)
        pod_s = st.pod_of_g[si]
        pod_d = st.pod_of_g[di]
        ls = st.local_of_g[si]
        ld = st.local_of_g[di]
        total = np.full(n, np.inf, np.float32)
        b1 = np.full(n, -1, np.int64)
        b2 = np.full(n, -1, np.int64)

        same = pod_s == pod_d
        if same.any():
            total[same] = self._pod_dist(pod_s[same], ls[same], ld[same])

        st.ensure_rows(np.unique(pod_d).tolist())
        dsb, cntA = self._border_dists(pod_s, ls, to_border=True)
        dbd, cntB = self._border_dists(pod_d, ld, to_border=False)
        bA, bB = dsb.shape[1], dbd.shape[1]
        if bA == 0 or bB == 0:
            return total, b1, b2

        colsA = np.arange(bA)
        colsB = np.arange(bB)
        fused = (
            self.fused and st.plane_h is not None and st.n_borders > 0
        )
        plane_dev = st.plane_device() if fused else None
        chunk = max(1, (1 << 22) // max(1, bA * bB))
        for lo in range(0, n, chunk):
            sl_ = slice(lo, min(n, lo + chunk))
            ps, pd = pod_s[sl_], pod_d[sl_]
            m = len(ps)
            gidA = np.minimum(
                st.pod_bstart[ps][:, None] + colsA[None, :],
                st.pod_bstart[ps + 1][:, None] - 1,
            )  # [m, bA] border ids of src pods (clamped pads)
            if fused:
                self._compose_chunk_fused(
                    plane_dev, sl_, lo, ps, pd, gidA,
                    dsb[sl_], dbd[sl_], cntA[sl_], cntB[sl_],
                    colsA, colsB, total, b1, b2, pod_s, pod_d,
                )
                continue
            cross = np.full((m, bA, bB), np.inf, np.float32)
            for p in np.unique(pd):
                rows_p = st.rows.get(int(p))
                pmask = pd == p
                if rows_p is None or not rows_p.size:
                    continue
                bp = rows_p.shape[0]
                g = gidA[pmask]  # [mp, bA]
                # rows_p[j, u] = dist(border u -> border j of pod p)
                cross[pmask, :, :bp] = rows_p[
                    np.arange(bp)[None, None, :], g[:, :, None],
                ]
            validA = colsA[None, :] < cntA[sl_][:, None]
            validB = colsB[None, :] < cntB[sl_][:, None]
            cross = cross + dsb[sl_][:, :, None] + dbd[sl_][:, None, :]
            cross = np.where(
                validA[:, :, None] & validB[:, None, :], cross, np.inf
            )
            flat = cross.reshape(m, -1)
            best = flat.min(axis=1)
            use = best < total[sl_]  # strict: intra wins length ties
            if not use.any():
                continue
            rsel = np.nonzero(use)[0]
            fsel = flat[rsel]
            bsel = best[rsel]
            is_best = fsel == bsel[:, None]
            if self.steer is not None:
                loadA = np.where(
                    validA[rsel],
                    self.steer[st.border_gidx[gidA[rsel]]], np.inf,
                )
                gidB = np.minimum(
                    st.pod_bstart[pd[rsel]][:, None] + colsB[None, :],
                    st.pod_bstart[pd[rsel] + 1][:, None] - 1,
                )
                loadB = np.where(
                    validB[rsel],
                    self.steer[st.border_gidx[gidB]], np.inf,
                )
                score = np.where(
                    is_best,
                    (loadA[:, :, None] + loadB[:, None, :]).reshape(
                        len(rsel), -1
                    ),
                    np.inf,
                )
                pick = np.argmax(
                    is_best & (score == score.min(axis=1)[:, None]),
                    axis=1,
                )
            else:
                pick = np.argmax(is_best, axis=1)
            gl = rsel + lo
            total[gl] = bsel
            b1[gl] = st.pod_bstart[pod_s[gl]] + pick // bB
            b2[gl] = st.pod_bstart[pod_d[gl]] + pick % bB
        return total, b1, b2

    def _compose_chunk_fused(
        self, plane_dev, sl_, lo, ps, pd, gidA, dsb_c, dbd_c,
        cntA_c, cntB_c, colsA, colsB, total, b1, b2, pod_s, pod_d,
    ) -> None:
        """One chunk through the fused device kernel. Operands pad to
        pow2 buckets (rows, src borders, dest borders) so the whole
        serving trace space is the O(log) ladder ``warm_serving``
        precompiles; pads carry inf distances (masked exactly like the
        host path's validA/validB) and index 0 (harmless gathers). The
        tie-break decode runs against the PADDED bB — argmax over the
        padded row-major flat picks the same lexicographic-first
        (b1, b2) as the host path because within-row column order and
        row order are both preserved."""
        st = self.st
        m, bA = gidA.shape
        bB = len(colsB)
        mp = bucket_pow2(m, 8)
        bAp = bucket_pow2(bA, 8)
        bBp = bucket_pow2(bB, 8)
        validA = colsA[None, :] < cntA_c[:, None]
        validB = colsB[None, :] < cntB_c[:, None]
        dsbm = np.full((mp, bAp), np.inf, np.float32)
        dsbm[:m, :bA] = np.where(validA, dsb_c, np.inf)
        dbdm = np.full((mp, bBp), np.inf, np.float32)
        dbdm[:m, :bB] = np.where(validB, dbd_c, np.inf)
        gA = np.zeros((mp, bAp), np.int32)
        gA[:m, :bA] = gidA
        ridx = np.zeros((mp, bBp), np.int32)
        base = st.plane_base[pd].astype(np.int64)
        # absent-plane pods (base -1: borderless dest, masked inf by
        # dbdm) clamp into the buffer like every other pad
        ridx[:m, :bB] = np.clip(
            base[:, None] + colsB[None, :],
            0, st.plane_h.shape[0] - 1,
        ).astype(np.int32)
        if self.steer is not None:
            lA = np.full((mp, bAp), np.inf, np.float32)
            lA[:m, :bA] = np.where(
                validA, self.steer[st.border_gidx[gidA]], np.inf
            )
            gidB = np.minimum(
                st.pod_bstart[pd][:, None] + colsB[None, :],
                st.pod_bstart[pd + 1][:, None] - 1,
            )
            lB = np.full((mp, bBp), np.inf, np.float32)
            lB[:m, :bB] = np.where(
                validB, self.steer[st.border_gidx[gidB]], np.inf
            )
        else:
            # zero load planes collapse the steered pick to
            # argmax(is_best) exactly — one kernel serves both modes
            lA = np.zeros((mp, bAp), np.float32)
            lB = np.zeros((mp, bBp), np.float32)
        from sdnmpi_tpu_torch.kernels.hiercompose import compose_fused

        best_f, pick_f = compose_fused(
            plane_dev, ridx, gA, dsbm, dbdm, lA, lB
        )
        best = best_f[:m]
        use = best < total[sl_]  # strict: intra wins length ties
        if not use.any():
            return
        rsel = np.nonzero(use)[0]
        gl = rsel + lo
        total[gl] = best[rsel]
        pk = pick_f[:m][rsel].astype(np.int64)
        b1[gl] = st.pod_bstart[pod_s[gl]] + pk // bBp
        b2[gl] = st.pod_bstart[pod_d[gl]] + pk % bBp

    # -- path materialization ---------------------------------------------

    def _chase(self, pod: int, a: int, b: int, out: list) -> None:
        """Append intra-pod hops from local ``a`` up to (excluding)
        local ``b``: (global dpid, out-port) per hop."""
        st = self.st
        bk = st.buckets[st.pod_bucket[pod]]
        sl = int(st.pod_slot[pod])
        nxt = bk.nxt[sl]
        prt = bk.port[sl]
        mem = st.pods_members[pod]
        dpids = st.dpids
        cur = int(a)
        guard = 0
        while cur != b:
            nx = int(nxt[cur, b])
            assert nx >= 0, "intra-pod chase hit an unreachable hop"
            out.append((int(dpids[mem[cur]]), int(prt[cur, nx])))
            cur = nx
            guard += 1
            assert guard <= bk.s, "intra-pod chase did not terminate"

    def _descend(self, b1: int, b2: int, out: list) -> None:
        """Append the border-to-border hops from ``b1`` to (excluding)
        ``b2``: greedy descent on the destination pod's row plane —
        each step picks the lowest-id candidate on a shortest
        continuation, so the walk is deterministic."""
        st = self.st
        pod_d = int(st.border_pod[b2])
        j2 = int(b2 - st.pod_bstart[pod_d])
        row = st.rows[pod_d][j2]  # [B]: dist(x -> b2)
        cur = int(b1)
        guard = 0
        while cur != b2:
            lo, hi = int(st.cstart[cur]), int(st.cstart[cur + 1])
            assert hi > lo, "border with no skeleton candidates"
            cand = st.ccand[lo:hi]
            tot = st.cw[lo:hi] + row[cand]
            k = int(np.argmin(tot))  # first min = lowest candidate id
            nxt = int(cand[k])
            port = int(st.cport[lo + k])
            if port >= 0:  # inter-pod hop: one physical link
                out.append((int(st.dpids[st.border_gidx[cur]]), port))
            else:  # intra-pod segment: chase the pod block
                self._chase(
                    int(st.border_pod[cur]),
                    int(st.border_local[cur]),
                    int(st.border_local[nxt]),
                    out,
                )
            cur = nxt
            guard += 1
            assert guard <= st.n_borders + 1, "border descent looped"

    def fdb(self, si: int, di: int, fport: int, total, b1, b2):
        """One pair's full fdb ``[(dpid, out_port), ...]`` ([] when
        unreachable): intra chase to the chosen source border, border
        descent, intra chase to the destination, final attachment hop."""
        st = self.st
        if not np.isfinite(total):
            return []
        di_dpid = int(st.dpids[di])
        if si == di:
            return [(di_dpid, int(fport))]
        hops: list[tuple[int, int]] = []
        if b1 < 0:  # pure intra-pod
            self._chase(
                int(st.pod_of_g[si]), int(st.local_of_g[si]),
                int(st.local_of_g[di]), hops,
            )
        else:
            self._chase(
                int(st.pod_of_g[si]), int(st.local_of_g[si]),
                int(st.border_local[b1]), hops,
            )
            self._descend(int(b1), int(b2), hops)
            self._chase(
                int(st.pod_of_g[di]), int(st.border_local[b2]),
                int(st.local_of_g[di]), hops,
            )
        hops.append((di_dpid, int(fport)))
        assert len(hops) == int(total) + 1, (
            "hierarchical path length drifted from its composed "
            f"distance ({len(hops) - 1} hops vs {int(total)})"
        )
        return hops


def window_congestion(hop_dpid: np.ndarray) -> float:
    """Max discrete link load of a window's hop arrays (each pair adds
    1 to every (dpid, next dpid) link of its path) — the hier twin of
    the dense path's ``link_loads`` figure."""
    if hop_dpid.size == 0 or hop_dpid.shape[1] < 2:
        return 0.0
    a = hop_dpid[:, :-1].ravel()
    b = hop_dpid[:, 1:].ravel()
    ok = (a >= 0) & (b >= 0)
    if not ok.any():
        return 0.0
    key = a[ok].astype(np.int64) * (hop_dpid.max() + 2) + b[ok]
    _, counts = np.unique(key, return_counts=True)
    return float(counts.max())


def _pack_rows(r: np.ndarray) -> dict:
    """Wire form of one pod's border-distance rows: base64 uint16 when
    every finite value is an integral hop count < 65535 (exact f32
    round-trip; 65535 encodes inf), raw f32 bytes otherwise."""
    import base64

    finite = np.isfinite(r)
    vals = r[finite]
    if vals.size == 0 or (
        (vals < 65535).all() and (vals == np.floor(vals)).all()
    ):
        u = np.where(finite, r, 65535.0).astype(np.uint16)
        return {
            "enc": "u16", "shape": [int(s) for s in r.shape],
            "data": base64.b64encode(u.tobytes()).decode("ascii"),
        }
    return {
        "enc": "f32", "shape": [int(s) for s in r.shape],
        "data": base64.b64encode(
            np.ascontiguousarray(r, np.float32).tobytes()
        ).decode("ascii"),
    }


def _unpack_rows(d: dict) -> np.ndarray:
    import base64

    raw = base64.b64decode(d["data"])
    shape = tuple(int(s) for s in d["shape"])
    if d["enc"] == "u16":
        u = np.frombuffer(raw, np.uint16).reshape(shape)
        out = u.astype(np.float32)
        out[u == 65535] = np.inf
        return out
    if d["enc"] != "f32":
        raise ValueError(f"unknown border-row encoding {d['enc']!r}")
    return np.frombuffer(raw, np.float32).reshape(shape).copy()


# -- the oracle -----------------------------------------------------------


class HierOracle(RouteOracle):
    """RouteOracle twin that answers every query seam through the
    two-level hierarchy. Policies map as:

    - ``shortest``: exact hierarchical shortest paths (the fence
      contract — lengths bit-identical to dense).
    - ``balanced`` / ``adaptive`` / collectives: the same shortest
      composition with the (b1, b2) border choice utilization-steered
      through the pod-aggregated view — load spreads across equal-cost
      borders without ever lengthening a path. (The dense DAG balancer
      and UGAL detours need the [V, V] planes this oracle exists to
      avoid; their knobs are accepted and the detour count reports 0.)

    ``max_diameter`` has no hierarchical twin (it is a safety cap, not
    a semantic) and is ignored with a warning. ``mesh_devices`` shards
    the pod-block stacks and the lazy row planes over the device mesh;
    ``ring_exchange`` moves the border-distance plane over the ring
    (kernel K3) instead of a gather. The pod blocks, the row sweeps and
    the composition run on ``device``."""

    def __init__(
        self,
        pad_multiple: int = 8,
        max_diameter: int = 0,
        mesh_devices: int = 0,
        shard_oracle: bool = False,
        ring_exchange: bool = False,
        pod_target: int = 0,
        fused: bool = True,
        hier_warm: bool = True,
        device="cuda",
    ) -> None:
        hier_ring = bool(ring_exchange and mesh_devices)
        super().__init__(
            pad_multiple=pad_multiple, max_diameter=0,
            mesh_devices=mesh_devices, shard_oracle=False,
            ring_exchange=False, device=device,
        )
        if max_diameter:
            log.warning(
                "hier_oracle has no capped-BFS twin; max_diameter=%d "
                "ignored", max_diameter,
            )
        self.pod_target = int(pod_target)
        self.hier_ring = hier_ring and self.mesh_devices > 0
        #: serve through the fused composition + batched hop walk.
        #: Default ON — the scalar chain is the
        #: bit-identical escape hatch (``Config.hier_fused``).
        self.fused = bool(fused)
        #: precompile the pow2 program ladder in warm_serving
        #: (``Config.hier_warm``); off = the pre-ladder warm behavior
        self.hier_warm = bool(hier_warm)
        self._hier: Optional[HierState] = None

    # -- refresh / repair --------------------------------------------------

    def _classify_deltas(self, state: HierState, deltas):
        """(dirty_pods, memo_only) when the gap is repairable in place,
        None when it needs a full rebuild. Intra-pod link deltas name
        their pod (one block recompute); inter-pod link deltas name
        nothing (level 2 rebuilds regardless); host deltas on known
        switches are memo-only; anything structural — a new switch, an
        unknown dpid, a broken log — rebuilds."""
        dirty: set[int] = set()
        saw_link = False
        for entry in deltas:
            kind = entry[1]
            if kind in ("link+", "link-"):
                a = state.index.get(entry[2])
                b = state.index.get(entry[3])
                if a is None or b is None:
                    return None  # node set changed
                saw_link = True
                pa, pb = state.pod_of_g[a], state.pod_of_g[b]
                if pa == pb:
                    dirty.add(int(pa))
            elif kind == "host":
                if entry[2] not in state.index:
                    return None  # a new attachment switch
            elif kind == "switch_upsert":
                continue
            else:
                return None
        return dirty, not saw_link

    def refresh(self, db: "TopologyDB") -> HierState:
        if self._version == db.version and self._hier is not None:
            return self._hier
        with STATS.timed("hier_refresh", version=db.version):
            mesh = self._dag_mesh()
            state = None
            if self._hier is not None and self._version is not None:
                deltas_since = getattr(db, "deltas_since", None)
                deltas = (
                    deltas_since(self._version) if deltas_since else None
                )
                if (
                    deltas is not None
                    and len(deltas) == db.version - self._version
                ):
                    plan = self._classify_deltas(self._hier, deltas)
                    if plan is not None:
                        dirty, memo_only = plan
                        if memo_only:
                            # host-only churn: the routed graph is
                            # untouched — keep both levels
                            state = self._hier
                        else:
                            state = build_state(
                                db, self._hier.podmap, mesh,
                                self.hier_ring, only_pods=dirty,
                                prev=self._hier, device=self.device,
                            )
                            self.repair_count += sum(
                                1 for e in deltas
                                if e[1] in ("link+", "link-")
                            )
            if state is None:
                from sdnmpi_tpu_torch.topogen.podmap import podmap_for_db

                podmap = podmap_for_db(db, self.pod_target)
                if podmap is None:
                    state = HierState()  # empty fabric
                    state.pod_bstart = np.zeros(1, np.int64)
                    state.cstart = np.zeros(1, np.int64)
                    state.ccand = np.zeros(0, np.int32)
                    state.cw = np.zeros(0, np.float32)
                    state.cport = np.zeros(0, np.int32)
                else:
                    state = build_state(
                        db, podmap, mesh, self.hier_ring,
                        device=self.device,
                    )
                _m_full_builds.inc()
                self.full_refresh_count += 1
            if (
                state is not self._hier
                and self._hier is not None
                and self._hier.plane_len
            ):
                # the delta log invalidated level 2: every cached
                # border row of the outgoing state is gone
                _m_row_evictions.inc(self._hier.plane_len)
            self._hier = state
            self._endpoint_memo = {}
            self._version = db.version
        return self._hier

    # -- steering ----------------------------------------------------------

    @staticmethod
    def _steer_from(link_util, state: HierState):
        """Per-switch load scores from the Monitor's host sample dict
        (the pod-aggregated UtilPlane view the border choice steers
        through). A device UtilPlane is a dense [V, V] tensor — the
        very thing the hierarchy escapes — so the TopologyManager
        hands the hier oracle the host dict instead (its
        ``routing_util``); any other input steers as idle."""
        if not isinstance(link_util, dict) or not link_util:
            return None
        steer = np.zeros(max(state.v, 1), np.float32)
        for (dpid, _port), bps in link_util.items():
            i = state.index.get(dpid)
            if i is not None:
                steer[i] += float(bps)
        return steer

    @staticmethod
    def pod_util(state: HierState, steer: Optional[np.ndarray]):
        """[P] pod-aggregated utilization — the coarse view telemetry
        reports."""
        out = np.zeros(max(state.n_pods, 1), np.float32)
        if steer is not None and state.pod_of_g is not None:
            np.add.at(out, state.pod_of_g, steer[: state.v])
        return out

    # -- window production -------------------------------------------------

    def _window_from_rows(
        self, state: HierState, rows, n_pairs: int, results,
        steer=None,
    ):
        from sdnmpi_tpu_torch.oracle.batch import WindowRoutes

        if rows:
            comp = _Composer(state, steer, fused=self.fused)
            si = np.array([r[1] for r in rows], np.int64)
            di = np.array([r[2] for r in rows], np.int64)
            total, b1, b2 = comp.compose(si, di)
            if comp.fused:
                # batched path materialization (oracle/hierpath.py) —
                # bit-identical to the scalar walk below (fenced)
                from sdnmpi_tpu_torch.oracle.hierpath import build_hop_arrays

                fports = np.array([r[3] for r in rows], np.int32)
                hd, hp, hl = build_hop_arrays(
                    state, si, di, fports, total, b1, b2
                )
                ks = np.array([r[0] for r in rows], np.int64)
                length = hd.shape[1]
                hop_dpid = np.full((n_pairs, length), -1, np.int64)
                hop_port = np.full((n_pairs, length), -1, np.int32)
                hop_len = np.zeros(n_pairs, np.int32)
                hop_dpid[ks] = hd
                hop_port[ks] = hp
                hop_len[ks] = hl
                return WindowRoutes(hop_dpid, hop_port, hop_len)
            for x, (k, _si, _di, fport) in enumerate(rows):
                results[k] = comp.fdb(
                    int(si[x]), int(di[x]), fport,
                    total[x], int(b1[x]), int(b2[x]),
                )
        return WindowRoutes.from_fdbs(results)

    @_timed_batch("routes_batch_dispatch")
    def routes_batch_dispatch(
        self, db: "TopologyDB", pairs, _dirty=None, _steer=None,
    ):
        from sdnmpi_tpu_torch.oracle.batch import RouteWindow

        state = self.refresh(db)
        results: list[list[tuple[int, int]]] = [[] for _ in pairs]
        rows = self._resolve_rows(db, pairs, state, results)
        wr = self._window_from_rows(
            state, rows, len(pairs), results, steer=_steer
        )
        if _dirty is not None:
            wr.touched = self._host_touched(wr.hop_dpid, _dirty[1])
        return RouteWindow(result=wr)

    @_timed_batch("routes_batch_balanced_dispatch")
    def routes_batch_balanced_dispatch(
        self, db: "TopologyDB", pairs,
        link_util=None, alpha: float = 1.0, chunk: int = 4096,
        link_capacity: float = 10e9, ecmp_ways: int = 4,
        rounds: int = 2, dag_threshold: Optional[int] = None,
    ):
        from sdnmpi_tpu_torch.oracle.batch import RouteWindow

        state = self.refresh(db)
        results: list[list[tuple[int, int]]] = [[] for _ in pairs]
        rows = self._resolve_rows(db, pairs, state, results)
        wr = self._window_from_rows(
            state, rows, len(pairs), results,
            steer=self._steer_from(link_util, state),
        )
        wr.max_congestion = window_congestion(wr.hop_dpid)
        self._note_congestion(wr.max_congestion, dag=False)
        return RouteWindow(result=wr)

    @_timed_batch("routes_batch_adaptive")
    def routes_batch_adaptive(
        self, db: "TopologyDB", pairs,
        link_util=None, ugal_candidates: int = 4,
        ugal_bias: float = 1.0, rounds: int = 2, alpha: float = 1.0,
        link_capacity: float = 10e9, ecmp_ways: int = 4,
    ):
        window = self.routes_batch_balanced_dispatch(
            db, pairs, link_util=link_util, alpha=alpha,
            link_capacity=link_capacity, ecmp_ways=ecmp_ways,
            rounds=rounds,
        )
        wr = window.reap()
        return wr.fdbs(), 0, wr.max_congestion

    # -- collectives -------------------------------------------------------

    def _dispatch_batch(self, db: "TopologyDB", macs, src_idx, dst_idx, policy: str,
                        link_util, phase: Optional[_Phase], **_flat_opts):
        """One collective batch, each pair its own composed route; the flat
        path's other options (``alpha``, ``ecmp_ways``, ...) do not apply.
        ``phase`` is set for a phased program's phase."""
        from sdnmpi_tpu_torch.oracle.batch import CollectiveRoutes, RouteWindow

        state = self.refresh(db)
        src_idx = np.ascontiguousarray(src_idx, dtype=np.int32)
        dst_idx = np.ascontiguousarray(dst_idx, dtype=np.int32)
        f = src_idx.shape[0]
        edge, fport = self._resolve_endpoints_array(db, state, macs)
        final_port = fport[dst_idx] if f else np.zeros(0, np.int32)
        si = edge[src_idx] if f else np.zeros(0, np.int32)
        di = edge[dst_idx] if f else np.zeros(0, np.int32)
        ok = (si >= 0) & (di >= 0)
        steer = (
            None if policy == "shortest"
            else self._steer_from(link_util, state)
        )
        fdbs: list[list[tuple[int, int]]] = [[] for _ in range(f)]
        hop_arrays = None
        if ok.any():
            comp = _Composer(state, steer, fused=self.fused)
            oki = np.nonzero(ok)[0]
            total, b1, b2 = comp.compose(
                si[oki].astype(np.int64), di[oki].astype(np.int64)
            )
            if comp.fused:
                from sdnmpi_tpu_torch.oracle.hierpath import build_hop_arrays

                hop_arrays = (oki,) + build_hop_arrays(
                    state, si[oki].astype(np.int64),
                    di[oki].astype(np.int64),
                    final_port[oki], total, b1, b2,
                )
            else:
                for x, k in enumerate(oki):
                    fdbs[k] = comp.fdb(
                        int(si[k]), int(di[k]), int(final_port[k]),
                        total[x], int(b1[x]), int(b2[x]),
                    )
        pair_sub = np.arange(f, dtype=np.int32)
        pair_sub[~ok] = -1
        if hop_arrays is not None:
            oki, hd, hp, hl = hop_arrays
            max_l = hd.shape[1]
            hop_dpid = np.full((f, max_l), -1, np.int64)
            hop_port = np.full((f, max_l), -1, np.int32)
            hop_len = np.zeros(f, np.int32)
            hop_dpid[oki] = hd
            hop_port[oki] = hp
            hop_len[oki] = hl
            routed = oki[hl > 0]
            # the final switch's out-port is per PAIR (final_port);
            # the sub-flow slot keeps the placeholder, like the
            # scalar assembly below
            hop_port[routed, hop_len[routed] - 1] = -1
        else:
            max_l = max((len(fdb) for fdb in fdbs), default=1) or 1
            hop_dpid = np.full((f, max_l), -1, np.int64)
            hop_port = np.full((f, max_l), -1, np.int32)
            hop_len = np.zeros(f, np.int32)
            for k, fdb in enumerate(fdbs):
                if not fdb:
                    continue
                hop_len[k] = len(fdb)
                for h, (dpid, port) in enumerate(fdb):
                    hop_dpid[k, h] = dpid
                    hop_port[k, h] = port
                hop_port[k, len(fdb) - 1] = -1  # per-pair placeholder
        maxc = window_congestion(hop_dpid)
        self._note_congestion(maxc, dag=False, phase=phase is not None)
        return RouteWindow(result=CollectiveRoutes(
            pair_sub, final_port, hop_dpid, hop_port, hop_len,
            max_congestion=maxc, endpoint_port=fport,
        ))

    @_timed_batch("routes_collective_phased_dispatch")
    def routes_collective_phased_dispatch(
        self, db: "TopologyDB", macs, src_idx, dst_idx,
        policy: str = "balanced", n_phases: int = 0, link_util=None,
        **_flat_opts,
    ):
        """Phased programs under the hierarchy: the shared phase plan
        (``sched.plan_phases``, the packer's host twin) decomposes the pair
        set exactly like the py backend's differential leg, and each phase
        routes through the hierarchical collective path. The packer's
        background-utilization terms are idle — the [V, V] base the
        dense packer reduces is the plane this oracle exists to avoid;
        per-phase border steering still spreads load inside phases."""
        from sdnmpi_tpu_torch.sched import plan_phases
        from sdnmpi_tpu_torch.sched.program import PhasedFlowProgram, PhasePlan

        state = self.refresh(db)
        src_idx = np.ascontiguousarray(src_idx, dtype=np.int32)
        dst_idx = np.ascontiguousarray(dst_idx, dtype=np.int32)
        edge, _ = self._resolve_endpoints_array(db, state, macs)
        k, pair_phase, _ = plan_phases(edge[src_idx], edge[dst_idx], max(state.v, 1),
                                       n_phases)
        phases: list[PhasePlan] = []
        for p in range(k):
            sel = np.nonzero(pair_phase == p)[0]
            if not len(sel):
                continue
            window = self.routes_collective_dispatch(
                db, macs, src_idx[sel], dst_idx[sel], policy,
                link_util=link_util, schedule=_Phase(p, None))
            phases.append(PhasePlan(p, sel, window))
        return PhasedFlowProgram(k, pair_phase, phases)

    # -- scalar / host APIs ------------------------------------------------

    def shortest_route(
        self, db: "TopologyDB", src_dpid: int, dst_dpid: int
    ) -> list[int]:
        if src_dpid == dst_dpid:
            return [src_dpid]
        state = self.refresh(db)
        si = state.index.get(src_dpid)
        di = state.index.get(dst_dpid)
        if si is None or di is None:
            return []
        comp = _Composer(state, None, fused=self.fused)
        total, b1, b2 = comp.compose(
            np.array([si], np.int64), np.array([di], np.int64)
        )
        hops = comp.fdb(si, di, 0, total[0], int(b1[0]), int(b2[0]))
        if not hops:
            return []
        return [dpid for dpid, _ in hops]

    def all_shortest_routes(
        self, db: "TopologyDB", src_dpid: int, dst_dpid: int,
        max_paths: Optional[int] = None,
    ):
        # equal-cost enumeration across the hierarchy would have to
        # merge per-level DAGs; the host BFS enumerator is exact and
        # this API is the rare FindAllRoutes path, never a hot one
        from sdnmpi_tpu_torch.core.topology_db import _py_all_shortest_routes

        return _py_all_shortest_routes(db, src_dpid, dst_dpid, max_paths)

    def warm_serving(self, db: "TopologyDB", shapes=(8, 256)) -> dict:
        """Warm the hier serving path: refresh (the pod-stack APSP
        buckets), materialize the serving set's border rows, and — under
        ``hier_warm`` — run the full pow2 program ladder once (row-sweep
        rungs + composition buckets), so the caching allocator holds
        every bucket's buffers before the first request. The batched
        hop walk is host numpy."""
        import time as _time

        t0 = _time.perf_counter()
        if not getattr(db, "switches", None):
            return {"warm_s": 0.0, "shapes": [], "max_len": 0}
        state = self.refresh(db)
        # the serving set: pods hosting attached endpoints — their
        # border-distance rows are what first requests would fault in
        pods = {
            int(state.pod_of_g[state.index[h.port.dpid]])
            for h in db.hosts.values() if h.port.dpid in state.index
        }
        state.ensure_rows(pods)
        compiled = 0
        if self.hier_warm:
            compiled = self._warm_ladder(state, shapes)
        max_len = 0
        for r in state.rows.values():
            finite = r[np.isfinite(r)]
            if finite.size:
                max_len = max(max_len, int(finite.max()))
        out = {
            "warm_s": _time.perf_counter() - t0,
            "shapes": sorted({int(s) for s in shapes if s > 0}),
            "max_len": max_len,
            "compiled": compiled,
        }
        _m_warm_s.set(out["warm_s"])
        return out

    def _warm_ladder(self, state: HierState, shapes) -> int:
        """Walk the pow2 bucket ladder the serving path dispatches
        through: one row-sweep rung per pow2 quanta count up to the
        materialized plane, and one fused-composition program per
        (m bucket) x (src border bucket) x (dest border bucket) combo
        that can actually occur — bA/bB are always SOME pod's true
        border count (a chunk max), so only buckets present in
        ``pod_bstart``'s count set can appear. Returns the program
        count warmed (compile or compile-cache hit each)."""
        compiled = 0
        if state.n_borders == 0:
            return compiled
        if (
            state.mesh is not None and state.deg_buckets
            and state.plane_len
        ):
            from sdnmpi_tpu_torch.shardplane.hier import warm_sweep_ladder

            compiled += len(warm_sweep_ladder(
                state.deg_buckets, state.n_borders, state.mesh,
                state.plane_len,
            ))
        if not self.fused or state.plane_h is None:
            return compiled
        from sdnmpi_tpu_torch.kernels.hiercompose import warm_compose

        plane = state.plane_device()
        counts = np.diff(state.pod_bstart)
        present = sorted({
            bucket_pow2(int(c), 8) for c in counts if c > 0
        })
        for a in present:
            for b in present:
                # compose chunks at (1 << 22) // (bA * bB) pairs, so a
                # window's TAIL chunk can bucket to any pow2 from 8 up
                # to bucket_pow2(chunk) — warm the whole rung ladder
                # (O(log) programs per bucket pair), nothing else can
                # be dispatched
                c0 = bucket_pow2(max(1, (1 << 22) // (a * b)), 8)
                m = 8
                while True:
                    warm_compose(plane, m, a, b)
                    compiled += 1
                    if m >= c0:
                        break
                    m *= 2
        return compiled

    # -- the persistent border plane ----------------------------------------

    def border_snapshot(self, db: "TopologyDB") -> Optional[dict]:
        """Serializable snapshot of the materialized border-distance
        row plane, topology-digest guarded like the route-cache memo.
        None when there is nothing to persist (no state, stale state,
        or no materialized rows)."""
        from sdnmpi_tpu_torch.oracle.routecache import RouteCache

        state = self._hier
        if (
            state is None or self._version != db.version
            or not state.plane_len
        ):
            return None
        return {
            "version": 1,
            "digest": RouteCache.topology_digest(db),
            "n_borders": int(state.n_borders),
            "pods": {
                str(p): _pack_rows(r)
                for p, r in sorted(state.rows.items())
            },
        }

    def restore_border_rows(self, snap, db: "TopologyDB") -> int:
        """Seed the border-row plane from :meth:`border_snapshot`.
        The state rebuilds cold first (``refresh``), so a digest or
        shape mismatch just leaves the lazy path in charge — counted
        ``hier_snapshot_rejected_total``, never a crash. Restored rows
        are bit-identical to a cold sweep (the u16 wire is exact for
        hop counts), so every downstream fence holds. Returns the
        restored row count."""
        from sdnmpi_tpu_torch.oracle.routecache import RouteCache

        if not isinstance(snap, dict) or snap.get("version") != 1:
            if snap is not None:
                _m_snap_rejected.inc()
            return 0
        state = self.refresh(db)
        if (
            snap.get("digest") != RouteCache.topology_digest(db)
            or int(snap.get("n_borders", -1)) != state.n_borders
        ):
            _m_snap_rejected.inc()
            return 0
        restored = 0
        for key, packed in snap.get("pods", {}).items():
            try:
                p = int(key)
                rows = _unpack_rows(packed)
            except (ValueError, KeyError, TypeError):
                _m_snap_rejected.inc()
                return restored
            if p < 0 or p >= state.n_pods or p in state.rows:
                continue
            bp = int(state.pod_bstart[p + 1] - state.pod_bstart[p])
            if rows.shape != (bp, state.n_borders):
                _m_snap_rejected.inc()
                continue
            state._plane_append(p, rows)
            restored += bp
        _m_rows_cached.set(state.plane_len)
        return restored

    def matrices(self, db: "TopologyDB"):
        raise NotImplementedError(
            "the hierarchical oracle never materializes dense [V, V] "
            "matrices — that ceiling is what it exists to escape"
        )

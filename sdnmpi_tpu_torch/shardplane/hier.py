"""Shardplane executors of the hierarchical oracle, as torch ops.

Counterpart of ``sdnmpi_tpu/shardplane/hier.py``. The mesh holds one
pod-block shard per logical shard: the stacked ``[nP, S, S]`` intra-pod
tensors and the border-distance row planes split over the pod/row axis,
so a shard holds O(pods * pod_size^2 / shards) where the dense oracle's
``[V, V]`` plane is a wall. A sharded tensor is the port's list of
per-shard blocks (``shardplane/mesh.py``); every shard of a port mesh is
on one device. Three executors, the reference's three jitted programs:

- :func:`pod_stack_apsp` (``_stack_apsp_core``) — level 1: BFS distances
  as batched f32 matmuls (one ``[n, s, s] @ [n, s, s]`` per hop, one host
  read per hop for the fixpoint), then the masked argmin next hops per
  destination-column chunk (:func:`_col_chunk` caps the ``[n, s, s, cb]``
  broadcast at 64M floats), lowest index on ties. With a mesh and at
  least as many pods as shards, each shard's pods run as their own
  program; pods converge independently, so the result is bit-equal.
- :func:`sweep_rows_sharded` (``_sweep_core``) — level 2: the
  border-skeleton Jacobi pull-sweeps of ``oracle.hier.sweep_rows_host``
  (every bucket gathers from the previous sweep's rows, min into the new
  ones) with the row axis split over the shards, one host read per sweep
  for the fixpoint. Rows are independent, so any row chunking is
  bit-equal; each chunk's rows are sized so that its gathered
  ``[rows, nB, K]`` intermediates stay under :data:`_SWEEP_GATHER_FLOATS`
  (2 GiB of f32: at config 15, ~3.1M gathered floats a row, 172 rows a
  chunk, well inside a card's memory beside the 545 MB plane and its
  host-bound copy).
- :func:`ring_exchange_border_plane` — the per-pod border-distance plane
  replicated from the pod-sharded block stacks over kernel K3
  (``kernels/ring.py``, bf16/int16 wire, bit-exact for hop counts); the
  level-2 build consumes those bytes.

The composition (``_compose_core``) is ``kernels/hiercompose.py``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sdnmpi_tpu_torch.shardplane.mesh import later, mesh_shards
from sdnmpi_tpu_torch.utils.metrics import REGISTRY

# the border-plane exchange is the one blocking ring leg of the hier
# refresh (the level-2 build cannot proceed without the replicated
# bytes), so its host-blocked wall is the refresh's exchange stall
_m_ring_stall = REGISTRY.gauge(
    "ring_exchange_stall_seconds",
    "host-blocked wall of the last blocking ring exchange (the hier "
    "border plane; window/refresh exchanges overlap compute and "
    "attribute through the shard_exchange span instead)",
)
_m_exchange_s = REGISTRY.histogram(
    "shard_exchange_seconds",
    help="blocking shardplane exchange wall seconds (ring or gather)",
)

#: shard-row quantum of the sweep executors: row counts pad to a pow2
#: number of (shards x this) quanta, the reference's program ladder
_SWEEP_ROW_CHUNK = 32

#: most f32 values one row chunk of the sweep gathers per bucket pass
_SWEEP_GATHER_FLOATS = 1 << 29

_INF = float("inf")


def _col_chunk(n: int, s: int) -> int:
    """Largest divisor of ``s`` keeping the next-hop argmin broadcast
    ([nP, s, s, cb]) under ~64M floats."""
    cb = s
    while cb > 1 and n * s * s * cb > (1 << 26):
        nxt = cb - 1
        while nxt > 1 and s % nxt:
            nxt -= 1
        cb = nxt
    return max(1, cb)


def _stack_apsp_core(adj: torch.Tensor, cb: int):
    """Distances + next hops for a stacked ``[n, s, s]`` pod bucket on
    ``adj``'s device: BFS frontier expansion as batched f32 matmuls
    (clamped to {0, 1}), then the masked argmin per destination-column
    chunk, lowest index on ties."""
    n, s, _ = adj.shape
    dev = adj.device
    a = (adj > 0).to(torch.float32)
    reached = torch.eye(s, dtype=torch.float32, device=dev).expand(n, s, s).contiguous()
    dist = torch.where(reached > 0, 0.0, _INF)
    t = 1
    while t <= s:
        grown = torch.clamp_max(torch.bmm(reached, a) + reached, 1.0)
        newly = (grown > 0) & torch.isinf(dist)
        dist = torch.where(newly, float(t), dist)
        reached = grown
        t += 1
        if not bool(newly.any()):
            break

    adj_mask = a > 0

    def per(dist_cols):  # [n, s, cb] distances to cb destinations
        scores = torch.where(adj_mask[:, :, :, None], dist_cols[:, None, :, :], _INF)
        return scores.argmin(dim=2).to(torch.int32)

    if cb == s:
        nxt = per(dist)
    else:
        nxt = torch.cat([per(dist[:, :, c:c + cb]) for c in range(0, s, cb)], dim=2)
    idx = torch.arange(s, dtype=torch.int32, device=dev)
    nxt = torch.where(torch.isinf(dist), -1, nxt)
    diag = idx[:, None] == idx[None, :]
    nxt = torch.where(diag, idx[:, None].expand(s, s), nxt)
    return dist, nxt


def _host_stack(x) -> np.ndarray:
    """Host numpy of a device stack: a tensor, or a list of per-shard
    blocks concatenated in shard order."""
    if isinstance(x, list):
        return np.concatenate([b.cpu().numpy() for b in x], axis=0)
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def pod_stack_apsp_async(adj, mesh=None, device="cuda"):
    """Run the stacked-bucket APSP on the device and return ``(dist_dev,
    nxt_dev, n, sharded)`` without reading them back: ``n`` is the real
    pod count; with a mesh and at least as many pods as shards the
    outputs are lists of per-shard blocks, padded to the shard quantum
    (``sharded`` True, the :func:`shard_pod_stack` layout, kept as the
    resident twin), else single tensors on ``device`` (the mesh's
    device when there is one)."""
    from sdnmpi_tpu_torch.convert import shard_rows

    adj = np.ascontiguousarray(adj, np.float32)
    n, s, _ = adj.shape
    if n == 0:
        return (
            np.zeros((0, s, s), np.float32),
            np.zeros((0, s, s), np.int32),
            0,
            False,
        )
    if mesh is not None:
        later("the hier oracle's pod blocks", mesh)
        shards = mesh_shards(mesh)
        if shards > 1 and n >= shards:
            pad = (-n) % shards
            if pad:
                adj = np.concatenate([adj, np.zeros((pad, s, s), np.float32)])
            cb = _col_chunk(adj.shape[0] // shards, s)
            outs = [_stack_apsp_core(blk, cb) for blk in shard_rows(adj, mesh)]
            return [d for d, _ in outs], [x for _, x in outs], n, True
        device = mesh.devices[0]
    cb = _col_chunk(n, s)
    dist, nxt = _stack_apsp_core(torch.as_tensor(adj).to(device), cb)
    return dist, nxt, n, False


def pod_stack_apsp(adj, mesh=None, device="cuda"):
    """(dist [nP, s, s] f32, next [nP, s, s] int32) for a stacked pod
    bucket, as host arrays (see :func:`pod_stack_apsp_async`)."""
    dist, nxt, n, _ = pod_stack_apsp_async(adj, mesh, device)
    return _host_stack(dist)[:n], _host_stack(nxt)[:n]


def shard_pod_stack(arr: np.ndarray, mesh) -> list:
    """Device-resident twin of a pod-stacked array: padded along the pod
    axis to the shard count, one equal block per shard."""
    from sdnmpi_tpu_torch.convert import shard_rows

    pad = (-arr.shape[0]) % mesh_shards(mesh)
    if pad:
        arr = np.concatenate([arr, np.zeros((pad, *arr.shape[1:]), arr.dtype)])
    return shard_rows(arr, mesh)


# -- level 2: sharded border-row sweeps -----------------------------------


def _device_buckets(deg_buckets, dev):
    """The degree buckets on ``dev``: (ids, flat candidates, weights, nb, k)."""
    out = []
    for ids, cand, w in deg_buckets:
        nb, k = cand.shape
        out.append((
            torch.as_tensor(np.asarray(ids, np.int64)).to(dev),
            torch.as_tensor(np.asarray(cand, np.int64).reshape(-1)).to(dev),
            torch.as_tensor(np.ascontiguousarray(w, np.float32)).to(dev),
            nb, k,
        ))
    return out


def _sweep_core(out: torch.Tensor, tloc: torch.Tensor, buckets, rc: int) -> int:
    """Jacobi pull-sweeps of one shard's row block, in place: row j of
    ``out`` becomes dist(every border -> border tloc[j]) (-1 pads stay
    all-inf and touch no other row). Row chunks of ``rc`` iterate to
    their own fixpoint, one host read per sweep. Returns the row-sweeps
    run (each chunk's rows times its sweeps, summed over the chunks)."""
    tl = tloc.shape[0]
    row_sweeps = 0
    out.fill_(_INF)
    real = torch.nonzero(tloc >= 0).reshape(-1)
    out[real, tloc[real]] = 0.0
    for lo in range(0, tl, rc):
        r = out[lo:lo + rc]
        rows = r.shape[0]
        while True:
            row_sweeps += rows
            rn = r.clone()
            for ids, cand, w, nb, k in buckets:
                vals = r.index_select(1, cand).reshape(rows, nb, k) + w
                rn.index_copy_(1, ids, torch.minimum(rn.index_select(1, ids),
                                                     vals.amin(dim=2)))
            if not bool((rn < r).any()):
                break
            r.copy_(rn)
    return row_sweeps


def _row_chunk(deg_buckets) -> int:
    per_row = max((int(np.asarray(c).size) for _, c, _ in deg_buckets), default=1)
    return max(1, _SWEEP_GATHER_FLOATS // max(1, per_row))


def _sweep_padded(deg_buckets, n_borders: int, tloc: np.ndarray, shards: int, dev):
    """Sweep the padded target list ``tloc`` (length a multiple of
    ``shards``), one row block per shard; returns the ``[len, B]`` plane
    whose block q is shard q's."""
    buckets = _device_buckets(deg_buckets, dev)
    rc = _row_chunk(deg_buckets)
    t_all = torch.as_tensor(tloc.astype(np.int64)).to(dev)
    out = torch.empty((len(tloc), n_borders), dtype=torch.float32, device=dev)
    tl = len(tloc) // shards
    for q in range(shards):
        _sweep_core(out[q * tl:(q + 1) * tl], t_all[q * tl:(q + 1) * tl], buckets, rc)
    return out


def _ladder(n_targets: int, shards: int) -> int:
    """Padded row count: a pow2 number of (shards x row-chunk) quanta."""
    quantum = max(1, shards) * _SWEEP_ROW_CHUNK
    nq = 1
    while nq * quantum < n_targets:
        nq *= 2
    return nq * quantum


def sweep_rows_sharded(deg_buckets, n_borders, targets, mesh):
    """Border-distance rows (see ``oracle.hier.sweep_rows_host``, the
    bit-equal host executor) with the row axis split over the mesh's
    shards. Returns (host rows [T, B] f32, the device plane [T_pad, B]
    whose row blocks are the shards', padding rows included).

    The row count pads to a pow2 number of quanta, the reference's
    program ladder; pad rows are -1 targets, all-inf rows that converge
    in one sweep and touch no real row."""
    later("the hier oracle's row sweep", mesh)
    t = len(targets)
    if t == 0 or n_borders == 0:
        return np.zeros((t, n_borders), np.float32), None
    shards = mesh_shards(mesh)
    total = _ladder(t, shards)
    tloc = np.concatenate([
        np.asarray(targets, np.int32), np.full(total - t, -1, np.int32)
    ])
    rows_d = _sweep_padded(deg_buckets, int(n_borders), tloc, shards, mesh.devices[0])
    return rows_d[:t].cpu().numpy(), rows_d


def warm_sweep_ladder(deg_buckets, n_borders, mesh, max_rows) -> list[int]:
    """Run the row-sweep ladder once: one all-pad (-1) block per rung of
    :func:`_ladder` up to the rung covering ``max_rows`` (each converges
    in a single sweep). Returns the row counts run."""
    if n_borders == 0 or max_rows <= 0 or not deg_buckets:
        return []
    shards = mesh_shards(mesh)
    warmed = [_ladder(1, shards)]
    while warmed[-1] < max_rows:
        warmed.append(2 * warmed[-1])
    for rows in warmed:
        _sweep_padded(deg_buckets, int(n_borders), np.full(rows, -1, np.int32),
                      shards, mesh.devices[0])
    return warmed


# -- the ring-exchanged border-distance plane -----------------------------


def border_plane_blocks(state, b):
    """One bucket's wire blocks for the ring: shard q's ``[k_q, bmax*s]``
    rows of its own real pods' border->member slices, packed (the pods
    of shard q are ``[q*per, (q+1)*per)`` of the padded stack). Returns
    (blocks, per-pod border counts, bmax); no blocks when no pod of the
    bucket has a border."""
    from sdnmpi_tpu_torch.kernels.ring import pack_dist_wire

    nP = len(b.pods)
    counts = (state.pod_bstart[b.pods + 1] - state.pod_bstart[b.pods]).astype(np.int64)
    bmax = int(counts.max(initial=0))
    if bmax == 0:
        return [], counts, 0
    bl = np.zeros((nP, bmax), np.int64)
    for i, p in enumerate(b.pods):
        lo = int(state.pod_bstart[p])
        c = int(counts[i])
        bl[i, :c] = state.border_local[lo:lo + c]
    src = b.dist_d if b.dist_d is not None else shard_pod_stack(b.dist, state.mesh)
    per = src[0].shape[0]
    blocks = []
    for q, blk in enumerate(src):
        k = max(0, min(per, nP - q * per))
        idx = torch.as_tensor(bl[q * per:q * per + k]).to(blk.device)
        pl = blk[torch.arange(k, device=blk.device)[:, None], idx, :]
        blocks.append(pack_dist_wire(pl.reshape(k, bmax * b.s), v=b.s))
    return blocks, counts, bmax


def ring_exchange_border_plane(state) -> dict[int, np.ndarray]:
    """Replicate each bucket's per-pod border-distance plane (the
    ``[nP, bmax, s]`` border->member slices of the pod-sharded distance
    stacks) over kernel K3 on the packed wire: shard q gathers the rows of
    its own pods (:func:`border_plane_blocks`), the all-gather hands every
    shard all ``nP`` rows, and the host reads shard 0's copy. The level-2
    build consumes exactly these bytes for its intra-pod skeleton
    weights (bit-equal to the host slice; hop counts are bounded by the
    pod size, so the wire is exact)."""
    from sdnmpi_tpu_torch.kernels.ring import ring_all_gather, unpack_dist_wire

    later("the hier border plane", state.mesh)
    t0 = time.perf_counter()
    out: dict[int, np.ndarray] = {}
    for bi, b in enumerate(state.buckets):
        blocks, counts, bmax = border_plane_blocks(state, b)
        if bmax == 0:
            out[bi] = np.full((len(b.pods), 0, b.s), np.inf, np.float32)
            continue
        rep = ring_all_gather(blocks, state.mesh)
        plane = unpack_dist_wire(rep[0]).cpu().numpy().reshape(len(b.pods), bmax, b.s)
        # pad slots (gathered from border 0) -> inf so no consumer can
        # mistake them for real border rows
        plane[np.arange(bmax)[None, :] >= counts[:, None]] = np.inf
        out[bi] = plane
    wall = time.perf_counter() - t0
    _m_ring_stall.set(wall)
    _m_exchange_s.observe(wall)
    return out


def hier_device_bytes(state, mesh=None) -> int:
    """Peak per-shard bytes of the hierarchy's device-resident serving
    tensors: the pod-axis/row-axis shards split evenly, so per shard is
    the total over the shard count."""
    total = state.device_bytes()
    if mesh is None:
        return total
    return -(-total // mesh_shards(mesh))

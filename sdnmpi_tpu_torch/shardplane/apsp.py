"""Row-sharded APSP: distances and next hops over the shard mesh.

Counterpart of ``sdnmpi_tpu/shardplane/apsp.py``. The row axis (BFS
sources, next-hop rows) splits across the mesh's shards; each shard runs
the single-device oracle's own helpers (``oracle/apsp.py``: ``_bfs_rows``,
``_fit_block``, ``_degree_compact_block``) on its row block, so every
result is bit-identical to the single-device matrices. These are torch
ops, as they were XLA in the reference, not Pallas.

The next-hop argmin needs every node's distances: in gather mode
(``apsp_next_hops_rowsharded``) the f32 blocks are replicated by the ring
all-gather (kernel K3, where the reference left an implicit XLA
all-gather); in ring mode (``apsp_next_hops_ringed``) destination-column
slices of the blocks ride the ring as 2-byte wire words, one gather per
slice, and the argmin runs on each slice once it is unpacked.
"""

from __future__ import annotations

import torch

from sdnmpi_tpu_torch.kernels.ring import (
    pack_dist_wire,
    ring_all_gather,
    unpack_dist_wire,
)
from sdnmpi_tpu_torch.oracle.apsp import (
    INF,
    _bfs_rows,
    _degree_compact_block,
    _fit_block,
)
from sdnmpi_tpu_torch.shardplane.mesh import ShardMesh, mesh_shards


def _bfs_block(adj: torch.Tensor, row0: int, n_rows: int, device) -> torch.Tensor:
    """Unbounded BFS of source rows ``[row0, row0 + n_rows)`` on ``device``."""
    v = adj.shape[0]
    a = (adj > 0).to(torch.float32).to(device)
    reached0 = torch.eye(v, dtype=torch.float32, device=device)[row0:row0 + n_rows]
    dist0 = torch.where(reached0 > 0, 0.0, INF)
    return _bfs_rows(a, reached0, dist0, v)


def apsp_distances_sharded(adj: torch.Tensor, mesh: ShardMesh) -> list:
    """Distances row-sharded over the mesh's "v" axis only (the
    mesh-only refresh): returns ``mesh.shape["v"]`` row blocks, block j
    on the device of shard j."""
    v = adj.shape[0]
    nv = mesh.shape["v"]
    if v % nv:
        raise ValueError(f"V={v} must divide by v-axis size {nv}")
    rp = v // nv
    return [_bfs_block(adj, j * rp, rp, mesh.devices[j]) for j in range(nv)]


def apsp_distances_rowsharded(adj: torch.Tensor, mesh: ShardMesh) -> list:
    """Distances with BFS sources split over every shard: one ``[V/s, V]``
    block per shard, bit-identical to ``oracle.apsp.apsp_distances``."""
    v = adj.shape[0]
    s = mesh_shards(mesh)
    if v % s:
        raise ValueError(f"V={v} must divide by {s} mesh shards")
    rp = v // s
    return [_bfs_block(adj, q * rp, rp, dev) for q, dev in enumerate(mesh.devices)]


def _finish(core: torch.Tensor, dist_mine: torch.Tensor, row0: int) -> torch.Tensor:
    """The reference's tail: analytic columns past the occupied bucket,
    -1 where unreachable, each row's own index on the diagonal."""
    rp, v = dist_mine.shape
    dev = dist_mine.device
    nxt = torch.zeros((rp, v), dtype=torch.int32, device=dev)
    nxt[:, : core.shape[1]] = core
    nxt = torch.where(torch.isinf(dist_mine), -1, nxt)
    rows = torch.arange(row0, row0 + rp, dtype=torch.int32, device=dev)
    cols = torch.arange(v, dtype=torch.int32, device=dev)
    return torch.where(rows[:, None] == cols[None, :], rows[:, None], nxt)


def _tables(adj, mesh, max_degree):
    """Each shard's rows of the sorted-neighbour table (valid, safe)."""
    from sdnmpi_tpu_torch.oracle.dag import neighbor_table

    v = adj.shape[0]
    s = mesh_shards(mesh)
    if v % s:
        raise ValueError(f"V={v} must divide by {s} mesh shards")
    rp = v // s
    _, valid, safe = neighbor_table(adj, max_degree)
    return rp, [
        (valid[q * rp:(q + 1) * rp].to(dev), safe[q * rp:(q + 1) * rp].to(dev))
        for q, dev in enumerate(mesh.devices)
    ]


def apsp_next_hops_rowsharded(
    adj: torch.Tensor, dist: list, mesh: ShardMesh, max_degree: int,
    n_occ: int = 0,
) -> list:
    """Next hops row-sharded over every shard, from row-sharded ``dist``:
    the same lowest-index degree-compact argmin per row as
    ``oracle.apsp.apsp_next_hops(max_degree=...)``, destination columns
    in the same blocks. ``n_occ`` > 0 computes the occupied columns only
    (the rest are analytic)."""
    v = adj.shape[0]
    rp, tables = _tables(adj, mesh, max_degree)
    n_cols = v if n_occ <= 0 else min(v, n_occ)
    block = _fit_block(n_cols, rp * min(max_degree, v))
    full = ring_all_gather(dist, mesh)  # K3: the f32 replication
    out = []
    for q, (valid_b, safe_b) in enumerate(tables):
        core = torch.cat([
            _degree_compact_block(valid_b, safe_b, full[q][:, c:c + block])
            for c in range(0, n_cols, block)
        ], dim=1)
        out.append(_finish(core, dist[q], q * rp))
    return out


def apsp_next_hops_ringed(
    adj: torch.Tensor, dist: list, mesh: ShardMesh, max_degree: int,
    n_occ: int = 0,
) -> list:
    """Ring-exchanged twin of :func:`apsp_next_hops_rowsharded`, the same
    result: each destination-column block of every shard's distances is
    packed to the wire, gathered by one K3 launch (the column slices are
    made contiguous first) and unpacked to the block's replicated f32
    columns, then the argmin runs on them. The column split follows
    ``apsp.py:215-220``: at least two blocks where the width allows, so
    a later slice can overlap block c+1's exchange with block c's
    argmin."""
    v = adj.shape[0]
    rp, tables = _tables(adj, mesh, max_degree)
    n_cols = v if n_occ <= 0 else min(v, n_occ)
    block = _fit_block(n_cols, rp * min(max_degree, v))
    if block == n_cols and n_cols % 2 == 0 and n_cols >= 16:
        block = n_cols // 2
    # hop counts are bounded by the FULL matrix's V, not the slice
    wire = [pack_dist_wire(d[:, :n_cols], v) for d in dist]
    cores: list[list] = [[] for _ in tables]
    for c in range(0, n_cols, block):
        cols = ring_all_gather([w[:, c:c + block] for w in wire], mesh)
        for q, (valid_b, safe_b) in enumerate(tables):
            cores[q].append(_degree_compact_block(
                valid_b, safe_b, unpack_dist_wire(cols[q])
            ))
    return [
        _finish(torch.cat(cores[q], dim=1), dist[q], q * rp)
        for q in range(len(tables))
    ]

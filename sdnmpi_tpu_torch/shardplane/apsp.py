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
slices of the blocks ride the ring as 2-byte wire words, one exchange per
slice on the exchange stream (K3's step form), and the argmin of one
slice runs while the next slice is in flight.

On a mesh over several processes each process computes its own
shards' blocks (``None`` at the others'), and the exchanges store into
every process's views (``kernels/ring.py``).
"""

from __future__ import annotations

import torch

from sdnmpi_tpu_torch.kernels.ring import (
    RingExchange,
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
from sdnmpi_tpu_torch.shardplane.mesh import ShardMesh, later, mesh_shards


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
    later("the v-axis refresh", mesh)
    v = adj.shape[0]
    nv = mesh.shape["v"]
    if v % nv:
        raise ValueError(f"V={v} must divide by v-axis size {nv}")
    rp = v // nv
    return [_bfs_block(adj, j * rp, rp, mesh.devices[j]) for j in range(nv)]


def apsp_distances_rowsharded(adj: torch.Tensor, mesh: ShardMesh) -> list:
    """Distances with BFS sources split over every shard: one ``[V/s, V]``
    block per shard of this process, bit-identical to
    ``oracle.apsp.apsp_distances``."""
    v = adj.shape[0]
    s = mesh_shards(mesh)
    if v % s:
        raise ValueError(f"V={v} must divide by {s} mesh shards")
    rp = v // s
    return [_bfs_block(adj, q * rp, rp, mesh.devices[q]) if q in mesh.local else None
            for q in range(s)]


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
    """Each shard's rows of the sorted-neighbour table (valid, safe);
    ``None`` at another process's shards."""
    from sdnmpi_tpu_torch.oracle.dag import neighbor_table

    v = adj.shape[0]
    s = mesh_shards(mesh)
    if v % s:
        raise ValueError(f"V={v} must divide by {s} mesh shards")
    rp = v // s
    _, valid, safe = neighbor_table(adj, max_degree)
    return rp, [
        (valid[q * rp:(q + 1) * rp].to(dev), safe[q * rp:(q + 1) * rp].to(dev))
        if q in mesh.local else None
        for q, dev in enumerate(mesh.devices)
    ]


def _column_block(n_cols: int, rp: int, max_degree: int, v: int,
                  ringed: bool) -> int:
    """Destination columns per argmin block (``_fit_block``); the ring
    form splits a single block in two where the width allows, so that
    there is a next exchange to hide behind the argmin
    (``apsp.py:215-220``)."""
    block = _fit_block(n_cols, rp * min(max_degree, v))
    if ringed and block == n_cols and n_cols % 2 == 0 and n_cols >= 16:
        block = n_cols // 2
    return block


def next_hops_from_columns(tables: list, dist: list, rp: int, n_cols: int,
                           block: int, columns) -> list:
    """The argmin over replicated distance columns: ``columns(c)`` gives
    each shard's f32 ``[V, block]`` columns ``c..c+block`` (called once
    per block, in order); then :func:`_finish`'s tail on every shard
    (those with a table: this process's)."""
    cores: list[list] = [[] for _ in tables]
    mine = [q for q, tb in enumerate(tables) if tb is not None]
    for c in range(0, n_cols, block):
        cols = columns(c)
        for q in mine:
            cores[q].append(_degree_compact_block(*tables[q], cols[q]))
    return [
        _finish(torch.cat(cores[q], dim=1), dist[q], q * rp) if q in mine else None
        for q in range(len(tables))
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
    block = _column_block(n_cols, rp, max_degree, v, ringed=False)
    full = ring_all_gather(dist, mesh)  # K3: the f32 replication
    return next_hops_from_columns(
        tables, dist, rp, n_cols, block,
        lambda c: [None if f is None else f[:, c:c + block] for f in full],
    )


def column_exchanges(dist: list, n_cols: int, block: int, mesh: ShardMesh | None = None):
    """The ring form's exchanges, one per destination-column block: the
    distances packed to the wire once (on the current stream; hop counts
    are bounded by the FULL matrix's V, not the slice), and a function
    that starts block c's exchange (:class:`RingExchange`) of the column
    slices, made contiguous first (across the processes of ``mesh`` when
    it spans several)."""
    v = next(d for d in dist if d is not None).shape[1]
    wire = [None if d is None else pack_dist_wire(d[:, :n_cols], v) for d in dist]
    return lambda c: RingExchange(
        [None if w is None else w[:, c:c + block].contiguous() for w in wire], mesh)


def apsp_next_hops_ringed(
    adj: torch.Tensor, dist: list, mesh: ShardMesh, max_degree: int,
    n_occ: int = 0,
) -> list:
    """Ring-exchanged twin of :func:`apsp_next_hops_rowsharded`, the same
    result, as the reference's software pipeline (``apsp.py:250-262``):
    each destination-column block of every shard's distances rides the
    ring as wire words on the exchange stream (:func:`column_exchanges`);
    block c+1's exchange is started before block c's argmin, which waits
    only for block c's exchange and runs on the unpacked columns while
    block c+1 is in flight. The column split follows ``apsp.py:215-220``.
    The current stream is joined to the exchange on return."""
    v = adj.shape[0]
    rp, tables = _tables(adj, mesh, max_degree)
    n_cols = v if n_occ <= 0 else min(v, n_occ)
    block = _column_block(n_cols, rp, max_degree, v, ringed=True)
    start = column_exchanges(dist, n_cols, block, mesh)
    pending = {0: start(0)}

    def columns(c):
        ex = pending.pop(c)
        if c + block < n_cols:  # block c+1 in flight behind c's argmin
            pending[c + block] = start(c + block)
        ex.wait(ex.last)
        pending["last"] = ex
        return [unpack_dist_wire(ex.view(q)) if q in mesh.local else None
                for q in range(ex.s)]

    out = next_hops_from_columns(tables, dist, rp, n_cols, block, columns)
    pending["last"].join()
    return out

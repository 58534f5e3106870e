"""All-pairs shortest paths and next-hop matrices as torch ops.

Counterpart of ``sdnmpi_tpu/oracle/apsp.py``:

- **Distances** via multi-source BFS expressed as 0/1 matrix products:
  the reached set ``R`` (one row per source) grows with ``R @ A`` each
  step, until no new vertex is reached. The products are f32 sums of
  0/1 values, exact; the loop checks convergence on the host once per
  level.
- **Next hops** via a masked argmin over each row's neighbours: for
  every (i, j), the lowest-indexed out-neighbour ``n`` of ``i``
  minimizing ``dist[n, j]`` (``torch.argmin`` returns the first minimum,
  the reference's sorted-dpid tie-break). :func:`nexthop_cols` redoes
  the argmin for a set of destination columns only (the incremental
  repair's, ``oracle/incremental.py``).
"""

from __future__ import annotations

import numpy as np
import torch

INF = float("inf")


def occ_bucket(n_real: int, v: int, multiple: int = 128) -> int:
    """Occupied-row bucket of a padded ``[V, V]`` fabric: ``n_real``
    rounded up to ``multiple``, capped at V. Returns V when the bucket
    would not shrink the computed block."""
    if n_real <= 0 or multiple <= 0:
        return v
    b = ((n_real + multiple - 1) // multiple) * multiple
    return v if b >= v else b


def _bfs_rows(a, reached, dist, bound: int):
    """BFS frontier expansion for a block of source rows: one
    ``[R, V] @ [V, V]`` product per step, clamped to {0, 1}, while
    something new is reached and the step count is within ``bound``."""
    t = 1
    while t <= bound:
        grown = torch.clamp(reached @ a + reached, max=1.0)
        newly = (grown > 0) & torch.isinf(dist)
        dist = torch.where(newly, float(t), dist)
        reached = grown
        t += 1
        if not bool(newly.any()):
            break
    return dist


def apsp_distances(
    adj: torch.Tensor, max_diameter: int = 0, n_occ: int = 0
) -> torch.Tensor:
    """Hop-count distance matrix ``[V, V]`` (f32, inf = unreachable).

    ``adj[i, j]`` nonzero iff a directed link i -> j exists; rows are
    sources. ``max_diameter`` > 0 caps the number of steps (longer paths
    read unreachable). ``n_occ`` > 0 runs the BFS for the first
    ``n_occ`` source rows only; the padding rows past it are analytic
    (0 to self, inf elsewhere), as the full BFS would compute them."""
    v = adj.shape[0]
    bound = min(v, max_diameter) if max_diameter > 0 else v
    n_rows = v if n_occ <= 0 else min(v, n_occ)
    a = (adj > 0).to(torch.float32)
    eye = torch.eye(v, dtype=torch.float32, device=adj.device)
    reached0 = eye[:n_rows]
    dist0 = torch.where(reached0 > 0, 0.0, INF)
    dist = _bfs_rows(a, reached0, dist0, bound)
    if n_rows == v:
        return dist
    pad = torch.where(eye[n_rows:] > 0, 0.0, INF)
    return torch.cat([dist, pad], dim=0)


def _fit_block(v: int, per_col_floats: int) -> int:
    """Widest destination-column block dividing V whose broadcast
    intermediate stays under ~256 MB (64M f32)."""
    block = max(1, min(v, (1 << 26) // max(1, per_col_floats)))
    while v % block:
        block -= 1
    return block


def _nexthop_block(adj_mask: torch.Tensor, dist_block: torch.Tensor) -> torch.Tensor:
    """Dense next hops for a ``[V, B]`` block of destination columns."""
    scores = torch.where(adj_mask[:, :, None], dist_block[None, :, :], INF)
    return torch.argmin(scores, dim=1).to(torch.int32)


def _degree_compact_block(
    valid: torch.Tensor, safe: torch.Tensor, dist_block: torch.Tensor
) -> torch.Tensor:
    """Degree-compact next hops for a ``[V, B]`` block of destination
    columns: gather each node's sorted-neighbour distances, argmin."""
    cand = dist_block[safe.long()]  # [V, D, B]
    cand = torch.where(valid[:, :, None], cand, INF)
    k = torch.argmin(cand, dim=1)  # [V, B] position in the sorted table
    return torch.gather(safe, 1, k.to(torch.int64))


def apsp_next_hops(
    adj: torch.Tensor, dist: torch.Tensor, block: int = 0, max_degree: int = 0,
    n_occ: int = 0,
) -> torch.Tensor:
    """Next-hop matrix ``[V, V]`` int32: ``next_hop[i, j]`` is the first
    switch after ``i`` on the chosen shortest path to ``j``; ``i`` on the
    diagonal; -1 when ``j`` is unreachable from ``i``.

    ``max_degree`` > 0 gathers candidates through the sorted-neighbour
    table (``O(V^2 D)``); 0 runs the dense masked argmin (``O(V^3)``).
    Both break ties to the lowest neighbour index. Destination columns
    go in blocks that bound the broadcast intermediate at ~256 MB.
    ``n_occ`` > 0 computes the occupied ``[n_occ, n_occ]`` corner only
    on the degree-compact path; padding comes out of the final masking."""
    from sdnmpi_tpu_torch.oracle.dag import neighbor_table

    v = adj.shape[0]
    adj_mask = adj > 0
    n_rows = n_cols = v

    if max_degree > 0:
        if n_occ > 0:
            n_rows = n_cols = min(v, n_occ)
        d = min(max_degree, v)
        _, valid, safe = neighbor_table(adj, max_degree)
        valid, safe = valid[:n_rows], safe[:n_rows]

        def per_block(db):  # db: [B, V], rows = destinations
            return _degree_compact_block(valid, safe, db.T)

        per_col_floats = n_rows * d
    else:

        def per_block(db):
            return _nexthop_block(adj_mask, db.T)

        per_col_floats = v * v

    cols = dist.T[:n_cols]  # [n_cols, V], rows = occupied destinations
    if block == 0:
        block = _fit_block(n_cols, per_col_floats)
    nxt = torch.cat(
        [per_block(cols[c:c + block]) for c in range(0, n_cols, block)], dim=1
    ).to(torch.int32)
    if n_rows < v or n_cols < v:
        full = torch.zeros((v, v), dtype=torch.int32, device=adj.device)
        full[:n_rows, :n_cols] = nxt
        nxt = full

    idx = torch.arange(v, dtype=torch.int32, device=adj.device)
    nxt = torch.where(torch.isinf(dist), -1, nxt)
    return torch.where(idx[:, None] == idx[None, :], idx[:, None], nxt)


def nexthop_cols(
    adj: torch.Tensor,
    dist: torch.Tensor,
    nxt: torch.Tensor,
    cols: np.ndarray,
    max_degree: int,
    valid: torch.Tensor | None = None,
    safe: torch.Tensor | None = None,
) -> torch.Tensor:
    """Recompute ``next_hop[:, cols]`` against ``dist`` and write the
    repaired columns into ``nxt`` in place (everything else untouched);
    returns ``nxt``.

    The column-restricted twin of :func:`apsp_next_hops`'s degree-compact
    path: the same neighbour table, the same argmin
    (:func:`_degree_compact_block`) and the same masking order, so the
    lowest-index tie-break cannot drift from the full recompute. ``cols``
    (int32, host) is bucket-padded with entries >= V at its end
    (``kernels/tiling.bucket_pad``): the gathers clamp them and only the
    real columns are written. ``valid``/``safe`` optionally give the
    ``[V, D]`` sorted-neighbour table (the incremental repair keeps it
    current row by row); without them it is built from ``adj``."""
    v = adj.shape[0]
    d = min(max_degree, v)
    if valid is None or safe is None:
        from sdnmpi_tpu_torch.oracle.dag import neighbor_table

        _, valid, safe = neighbor_table(adj, max_degree)
    n_real = int((cols < v).sum())
    if n_real == 0:
        return nxt
    cols_d = torch.as_tensor(cols.astype(np.int64)).to(adj.device)
    colsg = torch.clamp(cols_d, max=v - 1)  # gather-safe
    rows = torch.arange(v, dtype=torch.int32, device=adj.device)[:, None]

    def per_block(cols_b):  # [B] destination column indices
        db = dist[:, cols_b]  # [V, B]
        new = _degree_compact_block(valid, safe, db).to(torch.int32)
        new = torch.where(torch.isinf(db), -1, new)
        return torch.where(rows == cols_b[None, :].to(torch.int32), rows, new)

    c = colsg.shape[0]
    block = _fit_block(c, v * d)
    new = torch.cat(
        [per_block(colsg[b:b + block]) for b in range(0, c, block)], dim=1
    )
    # the pads sit at the end: only the real columns are written
    nxt[:, cols_d[:n_real]] = new[:, :n_real]
    return nxt

"""Incremental APSP repair: distances and next hops kept current across
link deltas without a full recompute.

Counterpart of ``sdnmpi_tpu/oracle/incremental.py`` as torch ops on the
oracle's device. A link flap used to cost the whole refresh (tensorize,
the BFS distances, the next-hop argmin); the delta log of the
TopologyDB (``core/topology_db.deltas_since``) lets the oracle redo only
what a delta can change:

- **Link add (u, v)**: a unit-weight edge can improve a pair only by
  being used once, so ``dist' = min(dist, dist[:, u] + 1 + dist[v, :])``
  is exact in one ``[V, V]`` broadcast. Next hops are redone for the
  destination columns that strictly improved, and for row ``u``, whose
  neighbour set grew.
- **Link remove (u, v)**: only the destination columns whose canonical
  next-hop tree rides the edge (``next[u, j] == v``) can change; every
  other column keeps a shortest path that avoids it. Those columns are
  recomputed by a reverse BFS over ``[V, C]`` one-hot frontiers, the
  ``[V, V] @ [V, C]`` product of ``apsp_distances`` restricted to C
  columns (f32 sums of 0/1 values, exact). The loop ends when a level
  reaches nothing new, which reads one flag on the host per level, some
  six levels on a fat-tree. Next hops are redone for the columns whose
  distances changed, and for row ``u``.
- **Link rewire** (same edge, new source port): only the port matrices
  change.

Every repaired tensor is bit-equal to a full recompute: distances are
integers, and the next hops go through ``apsp.nexthop_cols``, the same
degree-compact argmin as ``apsp_next_hops``.

What the port keeps per topology version beside the reference's tensors
is repaired here too: the compact neighbour table ``TopoTensors.neigh``
(which K1, K2 and the greedy scanner walk) gets row ``u`` from the same
sorted ``order`` row the next-hop repair reads, and the oracle drops
its gathered distance copy. Dirty column sets are bucket-padded
(``kernels/tiling.bucket_pad``); the pads clamp at the gathers and are
sliced away before every scatter.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from sdnmpi_tpu_torch.oracle.apsp import INF, nexthop_cols

if TYPE_CHECKING:
    from sdnmpi_tpu_torch.core.topology_db import TopologyDB
    from sdnmpi_tpu_torch.oracle.engine import TopoTensors


# -- repair steps ----------------------------------------------------------


def _set_link(adj, port, u: int, v: int, a_val: float, p_val: int) -> None:
    """Point update of the device adjacency and port matrices."""
    adj[u, v] = a_val
    port[u, v] = p_val


def _relax_add(dist, u: int, v: int):
    """One-pivot relaxation for a unit-weight edge add ``u -> v``.

    Returns ``(dist', improved)``: the relaxed distances and the ``[V]``
    bool mask of destination columns some pair strictly improved in,
    the columns whose next hops need repair."""
    cand = dist[:, u, None] + 1.0 + dist[v, :][None, :]
    better = cand < dist
    return torch.where(better, cand, dist), better.any(dim=0)


def _suspect_cols(nxt, u: int, v: int):
    """``[V]`` bool: the destination columns whose canonical next-hop
    tree rides edge ``u -> v``, the only ones a removal can change."""
    return nxt[u, :] == v


def _remove_repair(adj, dist, cols: np.ndarray):
    """Recompute the affected destination columns after an edge removal.

    ``adj`` is the post-removal adjacency, ``dist`` the pre-removal
    distances, ``cols`` the ``[C]`` int32 columns bucket-padded with
    entries >= V at the end. Returns ``(dist', changed)``: the distances
    with the real columns rewritten, and the ``[C]`` bool flags of the
    columns whose values changed (the pads' flags are meaningless)."""
    v = adj.shape[0]
    dev = adj.device
    a = (adj > 0).to(torch.float32)
    n_real = int((cols < v).sum())
    cols_d = torch.as_tensor(cols.astype(np.int64)).to(dev)
    colsg = torch.clamp(cols_d, max=v - 1)  # gather-safe
    f = (torch.arange(v, device=dev)[:, None] == colsg[None, :]).to(torch.float32)
    d = torch.where(f > 0, 0.0, INF)
    t = 1
    while True:
        grown = torch.clamp(a @ f + f, max=1.0)
        newly = (grown > 0) & torch.isinf(d)
        d = torch.where(newly, float(t), d)
        f = grown
        t += 1
        if not bool(newly.any()):  # one host read per level
            break
    changed = (d != dist[:, colsg]).any(dim=0)
    dist = dist.clone()
    dist[:, cols_d[:n_real]] = d[:, :n_real]  # the pads are never written
    return dist, changed


def _nexthop_row(dist, nxt, row: int, valid, safe):
    """Recompute ``next_hop[row, :]`` (the row whose neighbour set a link
    delta changed) through the sorted-neighbour table: the argmin and
    masking order of ``apsp_next_hops``, for one row. Writes ``nxt`` in
    place and returns it."""
    v = dist.shape[0]
    nu = safe[row].long()  # [D] sorted neighbours of the row
    cand = torch.where(valid[row][:, None], dist[nu, :], INF)  # [D, V]
    new = nu[torch.argmin(cand, dim=0)].to(torch.int32)  # first minimum
    new = torch.where(torch.isinf(dist[row, :]), -1, new)
    new[row] = row
    nxt[row, :] = new
    return nxt


# -- delta planning --------------------------------------------------------


@dataclasses.dataclass
class RepairPlan:
    """Validated, tensor-index-resolved form of a delta-log slice."""

    #: ("add" | "remove" | "rewire", row index u, col index v, port)
    edges: list[tuple[str, int, int, int]]
    #: a switch/host membership delta occurred: the endpoint memo clears
    clear_memo: bool = False


def plan_repair(
    tensors: "TopoTensors", db: "TopologyDB", deltas: list[tuple]
) -> Optional[RepairPlan]:
    """Resolve a delta-log slice against the cached tensors, or None when
    a delta falls outside what in-place repair can express: an endpoint
    the tensors never indexed (the node set would change), an add that
    would push a row past the compact neighbour table's width, or a
    delta kind this module does not know.

    No-op deltas (removing an absent edge) validate to nothing; the plan
    may be empty."""
    index = tensors.index
    adj = tensors.host_adj()
    cap = min(tensors.max_degree, tensors.v)
    deg = (adj > 0).sum(axis=1).astype(np.int64)
    edge_state: dict[tuple[int, int], bool] = {}
    edges: list[tuple[str, int, int, int]] = []
    clear_memo = False

    for entry in deltas:
        kind = entry[1]
        if kind == "switch_upsert":
            continue  # port-set refresh of a known switch: graph untouched
        if kind in ("switch_new", "host"):
            if entry[2] not in index:
                return None  # node set grew: needs a retensorize
            clear_memo = True  # switches/hosts changed membership
            continue
        if kind == "link+":
            _, _, a, b, port_no = entry
            ia, ib = index.get(a), index.get(b)
            if ia is None or ib is None:
                return None
            present = edge_state.get((ia, ib), adj[ia, ib] > 0)
            if present:
                edges.append(("rewire", ia, ib, port_no))
            else:
                if deg[ia] + 1 > cap:
                    return None  # would overflow the neighbour table
                deg[ia] += 1
                edge_state[(ia, ib)] = True
                edges.append(("add", ia, ib, port_no))
        elif kind == "link-":
            _, _, a, b = entry
            ia, ib = index.get(a), index.get(b)
            if ia is None or ib is None:
                return None
            if not edge_state.get((ia, ib), adj[ia, ib] > 0):
                continue  # removing an absent edge: no-op
            deg[ia] -= 1
            edge_state[(ia, ib)] = False
            edges.append(("remove", ia, ib, -1))
        else:  # unknown delta kind
            return None
    return RepairPlan(edges, clear_memo)


# -- application -----------------------------------------------------------


def _pad_cols(cols: np.ndarray, v: int) -> np.ndarray:
    """Bucket-pad a dirty-column index vector with V (clamped at the
    gathers, sliced away before the scatters)."""
    from sdnmpi_tpu_torch.kernels.tiling import bucket_pad

    return bucket_pad(cols, v, v)[0]


def _owned_twins(tensors: "TopoTensors") -> tuple[np.ndarray, np.ndarray]:
    """The tensors' stored host adjacency and port twins, made owned
    arrays first when they were never materialized, so the in-place
    patches land in the twin every later reader sees (never in a
    temporary copy, never in a view of the device tensor)."""
    if tensors.adj_host is None:
        tensors.adj_host = tensors.adj.cpu().numpy().copy()
    if tensors.port_host is None:
        tensors.port_host = tensors.port.cpu().numpy().copy()
    return tensors.adj_host, tensors.port_host


def apply_repairs(
    tensors: "TopoTensors",
    dist,
    nxt,
    order: Optional[np.ndarray],
    edges: list[tuple[str, int, int, int]],
    dist_host: Optional[np.ndarray] = None,
    next_host: Optional[np.ndarray] = None,
):
    """Apply a validated plan's edge repairs in order.

    Mutates, in place: the tensors' device ``adj``/``port``, their host
    twins, the compact neighbour table ``neigh`` (row ``u`` of each
    delta), the sorted-neighbour cache ``order`` (row ``u``), and the
    materialized host twins ``dist_host``/``next_host`` (only the dirty
    destination columns and row ``u``, so they stay bit-equal to a
    fresh download). Returns the repaired ``(dist, next_hop)`` device
    tensors."""
    from sdnmpi_tpu_torch import native

    v = tensors.v
    adj_h, port_h = _owned_twins(tensors)
    d = min(tensors.max_degree, v)
    if order is None:
        order = native.neighbor_order(adj_h)
    nxt = nxt.clone()

    for kind, ia, ib, port_no in edges:
        if kind == "rewire":
            port_h[ia, ib] = port_no
            _set_link(tensors.adj, tensors.port, ia, ib, 1.0, port_no)
            continue
        if kind == "add":
            adj_h[ia, ib] = 1.0
            port_h[ia, ib] = port_no
            if tensors.n_links >= 0:
                tensors.n_links += 1
            _set_link(tensors.adj, tensors.port, ia, ib, 1.0, port_no)
            dist, improved = _relax_add(dist, ia, ib)
            dirty = np.flatnonzero(improved.cpu().numpy())
        else:  # remove
            adj_h[ia, ib] = 0.0
            port_h[ia, ib] = -1
            if tensors.n_links >= 0:
                tensors.n_links -= 1
            _set_link(tensors.adj, tensors.port, ia, ib, 0.0, -1)
            suspect = np.flatnonzero(_suspect_cols(nxt, ia, ib).cpu().numpy())
            if len(suspect):
                dist, changed = _remove_repair(
                    tensors.adj, dist, _pad_cols(suspect, v)
                )
                dirty = suspect[changed.cpu().numpy()[: len(suspect)]]
            else:
                dirty = suspect  # empty
        # the mutated row of the sorted-neighbour cache, then the same
        # row of the device table K1, K2 and the scanner walk
        row = np.where(adj_h[ia] > 0, np.arange(v, dtype=np.int32), v).astype(np.int32)
        row.sort()
        order[ia] = row
        tensors.neigh[ia] = torch.as_tensor(row[:d]).to(tensors.neigh.device)
        valid = tensors.neigh < v
        safe = torch.clamp(tensors.neigh, max=v - 1)
        if len(dirty):
            nxt = nexthop_cols(
                tensors.adj, dist, nxt, _pad_cols(dirty, v),
                tensors.max_degree, valid, safe,
            )
        # the delta's own row always repairs: its neighbour set changed
        nxt = _nexthop_row(dist, nxt, ia, valid, safe)

        # patch the materialized host twins with exactly what this delta
        # changed: the dirty destination columns and row u of next hops
        if len(dirty):
            cols_d = torch.as_tensor(dirty.astype(np.int64)).to(dist.device)
            if dist_host is not None:
                dist_host[:, dirty] = dist[:, cols_d].cpu().numpy()
            if next_host is not None:
                next_host[:, dirty] = nxt[:, cols_d].cpu().numpy()
        if next_host is not None:
            next_host[ia, :] = nxt[ia, :].cpu().numpy()
    return dist, nxt

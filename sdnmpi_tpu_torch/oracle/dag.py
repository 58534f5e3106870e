"""Load-balanced collective routing over the shortest-path DAG.

Counterpart of ``sdnmpi_tpu/oracle/dag.py``. A whole collective's
traffic is a dense matrix ``F[t, i]`` (mass injected at switch ``i``
destined to switch ``t``). Shortest-path-DAG propagation goes level by
level: mass at distance ``l`` from its destination moves to distance
``l - 1`` each step, which for all destinations at once is three
products per level (normalizer, advance, link load). Congestion
awareness is iterative: after each round the link weights are rescaled
by the load the previous round produced, ``W = A / (1 + cost / mean)``.
Discrete per-flow paths are then sampled from the converged split
weights (kernel K2, ``kernels/sampler.py``); distances come from the
cache or from kernel K1 (``kernels/bfs.py``).

The balancer's products run in full f32: the level masks are exact
0/1 values and the split weights feed a bf16 log whose rounding decides
sampled paths, so TF32 must stay off for them (:func:`_full_f32`).
"""

from __future__ import annotations

import numpy as np
import torch

from sdnmpi_tpu_torch.kernels.bfs import bfs_distances, neighbor_rows, neighbor_rows_of
from sdnmpi_tpu_torch.kernels.sampler import (
    _hash_u32,
    _mul32,
    sample_paths_dense,
    sample_slots,
    sampler_tables,
)

__all__ = [
    "balance_rounds",
    "congestion_weights",
    "decode_slots_device",
    "make_dst_nodes",
    "neighbor_table",
    "propagate_levels",
    "restrict_dst",
    "restrict_dst_traffic",
    "route_collective",
    "sample_paths",
    "sample_paths_dense",
    "sampled_hops",
    "slots_to_nodes",
]

INF = float("inf")


def _full_f32() -> None:
    """Keep the balancer's f32 products out of TF32 on the card (TF32
    keeps ~10 mantissa bits: the split weights would drift from the
    reference's and flip bf16 log-weight roundings)."""
    torch.backends.cuda.matmul.allow_tf32 = False


def propagate_levels(
    weights: torch.Tensor,  # [V, V] f32 congestion-weighted adjacency
    dist_t: torch.Tensor,  # [T, V] f32: dist_t[t, i] = hop count i -> t
    traffic: torch.Tensor,  # [T, V] f32: mass injected at i destined t
    levels: int,
) -> torch.Tensor:
    """Push all traffic down the shortest-path DAG; return ``[V, V]``
    link load. Mass splits at each node across its one-step-closer
    neighbours in proportion to ``weights``; pairs farther than
    ``levels`` never move."""
    load = torch.zeros_like(weights)
    g = traffic
    for l in range(levels, 0, -1):
        m_cur = (dist_t == float(l)).to(torch.float32)
        m_nxt = (dist_t == float(l - 1)).to(torch.float32)
        cur = g * m_cur
        z = m_nxt @ weights.T  # [T, V]: candidate weight sum per (t, i)
        out = torch.where(z > 0.0, cur / torch.clamp(z, min=1e-30), 0.0)
        g = g * (1.0 - m_cur) + (out @ weights) * m_nxt
        load = load + weights * (out.T @ m_nxt)
    return load


def congestion_weights(adj_f: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """Scale-free inverse-cost link weights: ``A / (1 + cost / mean)``,
    the mean taken over real links."""
    n_links = torch.clamp(adj_f.sum(), min=1.0)
    c0 = (cost * adj_f).sum() / n_links
    return adj_f / (1.0 + cost / torch.clamp(c0, min=1e-30))


def restrict_dst_traffic(
    traffic: torch.Tensor, dst_nodes: torch.Tensor
) -> torch.Tensor:
    """Destination-restricted ``[T, V]`` traffic rows (-1 pads are 0)."""
    valid = (dst_nodes >= 0)[:, None]
    return torch.where(valid, traffic[dst_nodes.long().clamp(min=0)], 0.0)


def restrict_dst(
    dist: torch.Tensor,  # [V, V] f32, dist[i, t]
    traffic: torch.Tensor,  # [V, V] f32, traffic[t, i]
    dst_nodes: torch.Tensor,  # [T] int32 destination set (-1 pad)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``[T, V]`` rows of ``dist.T`` and ``traffic`` of the
    destination set; pad rows get inf distance and zero traffic."""
    valid = (dst_nodes >= 0)[:, None]
    rows = dst_nodes.long().clamp(min=0)
    dist_t = torch.where(valid, dist.T[rows], INF)
    return dist_t, restrict_dst_traffic(traffic, dst_nodes)


def balance_rounds(
    adj: torch.Tensor,  # [V, V] 0/1
    dist: torch.Tensor,  # [V, V] f32, dist[i, t]
    base_cost: torch.Tensor,  # [V, V] f32 measured utilization
    traffic: torch.Tensor,  # [V, V] f32, traffic[t, i]
    levels: int,
    rounds: int,
    dst_nodes: torch.Tensor | None = None,  # [T] int32 destination set (-1 pad)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Iteratively reweighted DAG routing: returns ``(weights [V, V],
    load [V, V], max_congestion)`` of the final round. Round 1 splits by
    base cost only; each later round folds the previous round's load
    into the cost. ``dst_nodes`` restricts the destination axis to the
    rows that carry traffic (same result)."""
    _full_f32()
    adj_f = (adj > 0).to(torch.float32)
    if dst_nodes is None:
        dist_t = dist.T
    else:
        dist_t, traffic = restrict_dst(dist, traffic, dst_nodes)
    weights = congestion_weights(adj_f, base_cost)
    load = propagate_levels(weights, dist_t, traffic, levels)
    for _ in range(rounds - 1):
        weights = congestion_weights(adj_f, base_cost + load)
        load = propagate_levels(weights, dist_t, traffic, levels)
    return weights, load, load.max()


def neighbor_table(
    adj_or_weights: torch.Tensor, max_degree: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact per-node out-neighbour table ``(neigh, valid, safe)``,
    each ``[V, min(max_degree, V)]``: sorted neighbour indices (V past
    the degree), a validity mask, and indices clamped to a safe gather
    range. ``max_degree`` must be >= the true out-degree. Built without
    a sort (``kernels.bfs.neighbor_rows``)."""
    v = adj_or_weights.shape[0]
    neigh = neighbor_rows(adj_or_weights > 0, min(max_degree, v))
    return neigh, neigh < v, torch.clamp(neigh, max=v - 1)


def sample_paths(
    weights: torch.Tensor,  # [V, V] f32 split weights (0 = no link)
    dist: torch.Tensor,  # [V, V] f32
    src: torch.Tensor,  # [F] int32 (-1 = padding)
    dst: torch.Tensor,  # [F] int32
    max_len: int,
    max_degree: int,
    salt: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather formulation: each hop draws a hash threshold into the
    candidates' cumulative weights. Returns ``(nodes [F, max_len] int32,
    slots [F, max_len] int8)``, -1 past the path end."""
    v = weights.shape[0]
    _, neigh_valid, neigh_safe = neighbor_table(weights, max_degree)
    neigh_safe = neigh_safe.long()
    dist_flat = dist.reshape(-1)
    w_flat = weights.reshape(-1)
    f = src.shape[0]
    src = src.long()
    dst = dst.long()
    fid = torch.arange(f, dtype=torch.int64, device=weights.device)
    safe_dst = dst.clamp(min=0)
    alive = (src >= 0) & (dst >= 0)
    alive &= torch.isfinite(dist_flat[src.clamp(min=0) * v + safe_dst])
    node = torch.where(alive, src, -1)
    nodes, slots = [], []
    for h in range(max_len):
        safe_node = node.clamp(min=0)
        moving = (node >= 0) & (node != dst)
        nbrs = neigh_safe[safe_node]  # [F, D]
        nval = neigh_valid[safe_node]
        dcur = dist_flat[safe_node * v + safe_dst]
        dn = dist_flat[nbrs * v + safe_dst[:, None]]
        wc = torch.where(
            nval & (dn == dcur[:, None] - 1.0),
            w_flat[safe_node[:, None] * v + nbrs], 0.0,
        )
        cum = torch.cumsum(wc, dim=1)
        total = cum[:, -1]
        r = _hash_u32(
            (_mul32(fid, 2654435761) + h * 0x9E3779B1 + salt) & 0xFFFFFFFF
        )
        thresh = (r.to(torch.float32) / 4294967296.0) * total
        slot = torch.argmax((cum > thresh[:, None]).to(torch.int8), dim=1)
        nxt = torch.gather(nbrs, 1, slot[:, None])[:, 0]
        ok = moving & (total > 0.0)
        nodes.append(node)
        slots.append(torch.where(ok, slot, -1))
        node = torch.where(ok, nxt, -1)
    return (
        torch.stack(nodes, dim=1).to(torch.int32),
        torch.stack(slots, dim=1).to(torch.int8),
    )


def make_dst_nodes(dst, pad_to: int = 128) -> np.ndarray:
    """Destination-set array for ``route_collective(dst_nodes=...)``:
    sorted unique destinations, -1 padded to a multiple of ``pad_to``."""
    edges = np.unique(np.asarray(dst))
    edges = edges[edges >= 0].astype(np.int32)
    t_pad = max(pad_to, ((len(edges) + pad_to - 1) // pad_to) * pad_to)
    out = np.full(t_pad, -1, np.int32)
    out[: len(edges)] = edges
    return out


def sampled_hops(max_len: int) -> int:
    """Slot-stream width ``route_collective`` samples: the hop into the
    destination is forced, so ``max_len - 2`` decisions cover every free
    choice of every flow; the decoder re-adds the forced final hop."""
    return max(1, max_len - 2)


def slots_to_nodes(adj, src, slots, dst=None, complete=False):
    """Host-side decode of the compact slot form back to switch indices
    (numpy in, numpy out). ``complete=True`` (the ``route_collective``
    readback contract) appends the forced final hop: output
    ``[F, H + 2]``. ``dst`` distinguishes a src == dst flow from an
    unreachable one."""
    src = np.asarray(src, np.int32)
    if complete and dst is None:
        raise ValueError("slots_to_nodes(complete=True) requires dst")
    if dst is not None:
        from sdnmpi_tpu_torch import native

        return native.decode_slots(
            np.asarray(slots, np.int8), native.neighbor_order(adj),
            src, np.asarray(dst, np.int32), complete=complete,
        )
    a = np.asarray(adj) > 0
    v = a.shape[0]
    order = np.where(a, np.arange(v)[None, :], v)
    order.sort(axis=1)
    slots = np.asarray(slots, np.int32)
    f, l = slots.shape
    valid = (slots[:, 0] >= 0) | (src >= 0)
    nodes = np.full((f, l), -1, np.int32)
    node = np.where(valid, src, -1)
    for h in range(l):
        nodes[:, h] = node
        s = slots[:, h]
        ok = (s >= 0) & (node >= 0)
        node = np.where(ok, order[np.maximum(node, 0), np.maximum(s, 0)], -1)
    return nodes


def decode_slots_device(
    adj: torch.Tensor,  # [V, V] 0/1 (weights also accepted: > 0 = link)
    slots: torch.Tensor,  # [F, H] int8 sampled slot streams
    src: torch.Tensor,  # [F] int32 (-1 pad)
    dst: torch.Tensor,  # [F] int32
) -> torch.Tensor:
    """On-device ``slots -> nodes`` decode, same semantics as
    ``native.decode_slots(..., complete=True)``: walk the sorted-neighbour
    table for H slots, then append the final node and the forced last
    hop; a walk that ends neither at dst nor next to it is all -1.
    Returns ``[F, H + 2]`` int32."""
    v = adj.shape[0]
    neigh, _, _ = neighbor_table(adj, v)
    neigh = neigh.long()
    s32 = slots.long()
    src = src.long()
    dst = dst.long()
    valid = (s32[:, 0] >= 0) | (src == dst)
    node = torch.where(valid & (src >= 0), src, -1)
    emitted = []
    for h in range(s32.shape[1]):
        s = s32[:, h]
        ok = (s >= 0) & (node >= 0) & (s < v)
        nxt = neigh[node.clamp(min=0), s.clamp(0, v - 1)]
        emitted.append(node)
        node = torch.where(ok & (nxt < v), nxt, -1)
    last = node
    nodes = (
        torch.stack(emitted, dim=1) if emitted
        else torch.empty((src.shape[0], 0), dtype=torch.int64, device=adj.device)
    )
    need = (last >= 0) & (last != dst)
    adjacent = (
        (adj[last.clamp(min=0), dst.clamp(min=0)] > 0) & (last >= 0) & (dst >= 0)
    )
    forced = torch.where(need & adjacent, dst, -1)
    dead = need & ~adjacent
    nodes = torch.where(dead[:, None], -1, nodes)
    last = torch.where(dead, -1, last)
    return torch.cat([nodes, last[:, None], forced[:, None]], dim=1).to(torch.int32)


def route_collective(
    adj: torch.Tensor,  # [V, V] 0/1
    link_src: torch.Tensor,  # [E] int32 row index of each real link
    link_dst: torch.Tensor,  # [E] int32 col index
    link_util: torch.Tensor,  # [E] f32 measured utilization per link
    traffic: torch.Tensor,  # [V, V] f32 traffic[t, i]
    src: torch.Tensor,  # [F] int32 flow sources (-1 pad)
    dst: torch.Tensor,  # [F] int32 flow destinations
    levels: int,
    rounds: int,
    max_len: int,
    salt: int = 0,
    dist: torch.Tensor | None = None,
    dst_nodes: torch.Tensor | None = None,  # [T] int32 destination set (-1 pad)
    neigh: torch.Tensor | None = None,  # [V, D] int32 topology neighbour table
) -> tuple[torch.Tensor, torch.Tensor]:
    """End-to-end collective routing on the tensors' device.

    Scatters the per-link utilization into the ``[V, V]`` cost matrix,
    computes the distances with kernel K1 (``levels`` steps) unless the
    caller passes the ``dist`` cached at this topology version, balances
    the collective over the DAG, and samples every flow's path with
    kernel K2. Returns ``(slots [F, sampled_hops(max_len)] int8,
    max_congestion f32 scalar)``; decode the slots with
    ``slots_to_nodes(..., complete=True)``.

    ``dst_nodes`` (every flow's ``dst`` and every nonzero ``traffic``
    row must be in it) restricts the balancing products and the
    sampler's distance table to the destination set, with the same
    result. ``levels`` must bound the diameter: without a cached
    ``dist``, pairs farther apart read unreachable. ``neigh`` is the
    compact sorted neighbour table of ``adj`` that the oracle builds once
    per topology version (``TopoTensors.neigh``); without it one is built
    here. It takes the place of the reference's ``max_degree``."""
    v = adj.shape[0]
    base = torch.zeros((v, v), dtype=torch.float32, device=adj.device)
    base[link_src.long(), link_dst.long()] = link_util.to(torch.float32)
    if neigh is None:
        neigh = neighbor_rows_of(adj)
    if dist is None:
        dist = bfs_distances(adj, levels, neigh=neigh)
    weights, _, maxc = balance_rounds(
        adj, dist, base, traffic, levels=levels, rounds=rounds,
        dst_nodes=dst_nodes,
    )
    tables = sampler_tables(weights, dist, dst_nodes, neigh=neigh)
    slots = sample_slots(
        weights, dist, src, dst, sampled_hops(max_len), salt=salt,
        dst_nodes=dst_nodes, tables=tables,
    )
    return slots, maxc

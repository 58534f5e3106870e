"""UGAL adaptive min/non-min routing (bench config 5).

Counterpart of ``sdnmpi_tpu/oracle/adaptive.py``. Low-diameter
topologies like dragonfly have cheap minimal paths that collapse onto
few global links under adversarial traffic; Valiant routing through a
random intermediate doubles the hop count but spreads load. UGAL picks
per flow: minimal when the minimal path is cheap, a detour through an
intermediate when measured congestion makes the longer path cheaper.

- :func:`dag_weighted_costs`: cheapest congestion cost among hop-minimal
  paths, the quantity UGAL compares on both sides of its decision.
  (:func:`weighted_apsp`, the unrestricted Bellman-Ford variant, is a
  differential-testing oracle only: its costs satisfy the triangle
  inequality, so detours could never win against them.)
- :func:`ugal_choose`: every flow hash-samples K candidate intermediates
  and compares ``cost(s -> m) + cost(m -> t)`` with the minimal cost.
- :func:`route_adaptive`: end to end on the tensors' device: distances
  (kernel K1 unless cached), the UGAL choice, both segments of every flow
  balanced over the shortest-path DAG (``oracle/dag.balance_rounds``) and
  sampled to discrete paths by kernel K2, whose per-call set-up is built
  once and shared by the two segment launches.
- :func:`decode_segments`, :func:`stitch_paths`, :func:`link_loads`: the
  host side.

The hash keeps uint32 values in int64 (``kernels/sampler._hash_u32``);
the traffic matrix accumulates in float64 and is cast once, so repeated
(destination, source) entries sum exactly in any order.

Where the reference takes ``max_degree``, ``dag_weighted_costs`` and
``route_adaptive`` take ``neigh``, the topology's compact sorted
neighbour table (``TopoTensors.neigh``), and build one when it is
absent (``weighted_apsp`` always builds its own).
"""

from __future__ import annotations

import numpy as np
import torch

from sdnmpi_tpu_torch.kernels.bfs import neighbor_rows_of
from sdnmpi_tpu_torch.kernels.sampler import (
    _MASK,
    _hash_u32,
    _mul32,
    sample_slots,
    sampler_tables,
)
from sdnmpi_tpu_torch.oracle.dag import (
    balance_rounds,
    decode_slots_device,
    sampled_hops,
    uncached_distances,
)

INF = float("inf")


def _table(adj: torch.Tensor, neigh: torch.Tensor | None):
    """``(valid [V, D] bool, safe [V, D] int64)`` of the neighbour table."""
    v = adj.shape[0]
    if neigh is None:
        neigh = neighbor_rows_of(adj)
    return neigh < v, neigh.long().clamp(max=v - 1)


def weighted_apsp(
    adj: torch.Tensor,  # [V, V] 0/1 directed adjacency
    cost: torch.Tensor,  # [V, V] f32 per-link cost (ignored where adj == 0)
    max_iters: int = 0,
) -> torch.Tensor:
    """All-pairs shortest *weighted* path costs ``[V, V]`` (inf =
    unreachable).

    Bellman-Ford over the compact neighbour table: each sweep relaxes
    ``d[i, t] = min(d[i, t], min_k w[i, n_k] + d[n_k, t])`` for every
    source row at once, a ``[V, D, V]`` gather and min. Sweeps stop when
    nothing improves (one host sync per sweep) or after ``max_iters``
    (> 0) sweeps. A validation oracle: the UGAL pipeline uses
    :func:`dag_weighted_costs`."""
    v = adj.shape[0]
    nval, nsafe = _table(adj, None)
    idx = torch.arange(v, device=adj.device)
    wn = torch.where(nval, cost[idx[:, None], nsafe], INF)  # [V, D] slot costs
    d = torch.where(idx[:, None] == idx[None, :], 0.0, INF)
    bound = max_iters if max_iters > 0 else v
    for _ in range(bound):
        relaxed = torch.where(
            nval[:, :, None], wn[:, :, None] + d[nsafe], INF
        ).min(dim=1).values
        nd = torch.minimum(d, relaxed)
        changed = bool((nd < d).any())
        d = nd
        if not changed:
            break
    return d


def dag_weighted_costs(
    adj: torch.Tensor,  # [V, V] 0/1
    dist: torch.Tensor,  # [V, V] f32 hop counts
    cost: torch.Tensor,  # [V, V] f32 per-link cost (ignored where adj == 0)
    levels: int,
    neigh: torch.Tensor | None = None,  # [V, D] int32 topology neighbour table
) -> torch.Tensor:
    """Cheapest congestion cost among *hop-minimal* paths, ``[V, V]``.

    Relaxation is restricted to shortest-path-DAG edges: ``d[i, t]``
    improves only through neighbours one hop closer to ``t``, so a
    Valiant detour can beat the minimal route when the minimal DAG's
    links are hot. The DAG has depth <= ``levels``, so ``levels`` sweeps
    converge exactly. Holds one ``[V, D, V]`` mask across the sweeps and
    one ``[V, D, V]`` gather within each."""
    v = adj.shape[0]
    nval, nsafe = _table(adj, neigh)
    idx = torch.arange(v, device=adj.device)
    wn = torch.where(nval, cost[idx[:, None], nsafe], INF)  # [V, D]
    dag_edge = nval[:, :, None] & (dist[nsafe] == dist[:, None, :] - 1.0)
    d = torch.where(idx[:, None] == idx[None, :], 0.0, INF)
    for _ in range(levels):
        relaxed = torch.where(
            dag_edge, wn[:, :, None] + d[nsafe], INF
        ).min(dim=1).values
        d = torch.minimum(d, relaxed)
    return d


def congestion_cost(adj: torch.Tensor, util: torch.Tensor) -> torch.Tensor:
    """Per-link cost blending hop count with normalized utilization:
    ``1 + util / mean(util over real links)``; an idle fabric is pure hop
    count."""
    adj_f = (adj > 0).to(torch.float32)
    n_links = torch.clamp(adj_f.sum(), min=1.0)
    mean = (util * adj_f).sum() / n_links
    return 1.0 + torch.where(mean > 0.0, util / mean, 0.0)


def ugal_choose(
    dw: torch.Tensor,  # [V, V] f32 weighted all-pairs costs
    src: torch.Tensor,  # [F] int32 (-1 pad)
    dst: torch.Tensor,  # [F] int32
    n_valid: int,  # intermediates are drawn from [0, n_valid)
    n_candidates: int = 4,
    bias: float = 1.0,
    salt: int = 0,
    fid_base: int = 0,  # global index of flow 0 (sharded callers)
) -> torch.Tensor:
    """Per-flow UGAL-G decision: ``[F]`` int32 intermediate node, or -1
    to route minimally.

    Each flow hash-samples ``n_candidates`` intermediates m and takes the
    cheapest ``dw[s, m] + dw[m, t]`` (first index among equals); the
    detour wins only if it beats the minimal cost ``dw[s, t]`` by more
    than ``bias``. Candidates equal to s or t, padding rows and
    unreachable candidates are discarded."""
    v = dw.shape[0]
    f = src.shape[0]
    dev = dw.device
    fid = (torch.arange(f, dtype=torch.int64, device=dev) + fid_base) & _MASK
    ks = torch.arange(n_candidates, dtype=torch.int64, device=dev)
    r = _hash_u32(
        _mul32(fid, 2654435761)[:, None]
        ^ _mul32(ks, 0x85EBCA77)[None, :]
        ^ (salt & _MASK)
    )
    m = r % max(int(n_valid) & _MASK, 1)  # [F, K]
    src = src.long()
    dst = dst.long()
    safe_src = src.clamp(min=0)
    safe_dst = dst.clamp(min=0)
    dw_flat = dw.reshape(-1)
    c_min = dw_flat[safe_src * v + safe_dst]  # [F]
    c_val = dw_flat[safe_src[:, None] * v + m] + dw_flat[m * v + safe_dst[:, None]]
    # a degenerate intermediate (an endpoint) is no detour
    degenerate = (m == src[:, None]) | (m == dst[:, None])
    c_val = torch.where(degenerate, INF, c_val)
    best = torch.argmin(c_val, dim=1, keepdim=True)  # first minimum
    best_cost = c_val.gather(1, best)[:, 0]
    # float32 + a Python scalar adds in float32, as the reference does
    take = (src >= 0) & (dst >= 0) & (best_cost + float(bias) < c_min)
    return torch.where(take, m.gather(1, best)[:, 0], -1).to(torch.int32)


def route_adaptive(
    adj: torch.Tensor,  # [V, V] 0/1
    util: torch.Tensor,  # [V, V] f32 measured per-link utilization
    src: torch.Tensor,  # [F] int32 flow sources (-1 pad)
    dst: torch.Tensor,  # [F] int32 flow destinations
    weight: torch.Tensor,  # [F] f32 flow weights (0 pad)
    n_valid: int,  # real (unpadded) switch count
    levels: int,
    rounds: int = 2,
    max_len: int = 8,
    n_candidates: int = 4,
    bias: float = 1.0,
    salt: int = 0,
    dist: torch.Tensor | None = None,  # cached distances, else uncached_distances
    packed: bool = False,
    neigh: torch.Tensor | None = None,  # [V, D] int32 topology neighbour table
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """UGAL + load-balanced DAG routing for a whole flow batch.

    Distances (:func:`~sdnmpi_tpu_torch.oracle.dag.uncached_distances`
    unless ``dist`` is given) -> DAG-restricted weighted costs ->
    per-flow UGAL choice -> every flow becomes two segment flows (s -> m, m -> t; minimal flows use
    m = t and a dead second segment) -> both segment sets are balanced
    together over the shortest-path DAG and sampled to discrete paths by
    kernel K2, the two launches sharing one set-up (salts ``salt`` and
    ``salt ^ 0x5BD1E995``).

    Returns ``(inter [F] int32, nodes1 [F, max_len], nodes2 [F,
    max_len], load [V, V])``; stitch the segments with
    :func:`stitch_paths`. ``load`` is the balanced assignment's
    fractional link load. With ``packed=True`` the segments come back as
    K2's int8 slot streams ``(inter, slots1, slots2, load)``; decode them
    on the host with :func:`decode_segments`.

    Without ``dist``, the card runs kernel K1 for ``levels`` steps and
    reads pairs farther apart as unreachable, as the reference's Pallas
    path does; the CPU computes exact distances, as the reference does
    off the TPU."""
    v = adj.shape[0]
    if neigh is None:
        neigh = neighbor_rows_of(adj)
    if dist is None:
        dist = uncached_distances(adj, levels, neigh)
    cost = congestion_cost(adj, util)
    dmin = dag_weighted_costs(adj, dist, cost, levels, neigh=neigh)
    inter = ugal_choose(
        dmin, src, dst, n_valid, n_candidates=n_candidates, bias=bias, salt=salt
    )

    src = src.long()
    dst = dst.long()
    detour = inter >= 0
    mid = torch.where(detour, inter.long(), dst)
    # segment 1: s -> mid for every live flow; segment 2 only for detours
    s2 = torch.where(detour, mid, -1)
    d2 = torch.where(detour, dst, -1)

    # both segment sets in one [T, V] traffic matrix for the balancer
    w_live = torch.where((src >= 0) & (dst >= 0), weight.to(torch.float64), 0.0)
    traffic = torch.zeros(v * v, dtype=torch.float64, device=adj.device)
    traffic.index_add_(
        0, mid.clamp(min=0) * v + src.clamp(min=0),
        torch.where(src >= 0, w_live, 0.0))
    traffic.index_add_(
        0, d2.clamp(min=0) * v + s2.clamp(min=0), torch.where(detour, w_live, 0.0))
    traffic = traffic.to(torch.float32).reshape(v, v)

    weights, load, _ = balance_rounds(
        adj, dist, util, traffic, levels=levels, rounds=rounds
    )
    hops = sampled_hops(max_len)
    tables = sampler_tables(weights, dist, None, neigh=neigh)
    src32, mid32 = src.to(torch.int32), mid.to(torch.int32)
    s2_32, d2_32 = s2.to(torch.int32), d2.to(torch.int32)
    slots1 = sample_slots(weights, dist, src32, mid32, hops, salt=salt, tables=tables)
    slots2 = sample_slots(
        weights, dist, s2_32, d2_32, hops, salt=salt ^ 0x5BD1E995, tables=tables
    )
    if packed:
        return inter, slots1, slots2, load
    nodes1 = decode_slots_device(adj, slots1, src32, mid32)[:, :max_len]
    nodes2 = decode_slots_device(adj, slots2, s2_32, d2_32)[:, :max_len]
    return inter, nodes1, nodes2, load


def decode_segments(
    adj_host, src, dst, inter, slots1, slots2, max_len: int,
    order: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side decode of ``route_adaptive(packed=True)`` results.

    Rebuilds each flow's segment endpoints from ``inter`` as the device
    program derives them and decodes the int8 slot streams through
    ``native.decode_slots``: segment 1 of every flow, segment 2 of the
    detour flows (a minimal flow's is all -1). Returns ``(nodes1,
    nodes2)`` ``[F, max_len]`` int32, equal to the unpacked return.
    ``order`` is the cached sorted-neighbour table
    (``native.neighbor_order(adj_host)``)."""
    from sdnmpi_tpu_torch import native

    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    inter = np.asarray(inter, np.int32)
    slots2 = np.asarray(slots2, np.int8)
    if order is None:
        order = native.neighbor_order(adj_host)
    n1 = native.decode_slots(np.asarray(slots1, np.int8), order, src,
                             np.where(inter >= 0, inter, dst), complete=True)
    # segment 2 exists on detour rows only (inter -> dst); a dead row's
    # endpoints are -1, which decodes to all -1
    idx = np.flatnonzero(inter >= 0)
    n2 = np.full((len(inter), slots2.shape[1] + 2), -1, np.int32)
    n2[idx] = native.decode_slots(np.take(slots2, idx, axis=0), order,
                                  inter[idx], dst[idx], complete=True)
    return n1[:, :max_len], n2[:, :max_len]


def stitch_paths(nodes1, nodes2, inter) -> np.ndarray:
    """Host-side concatenation of the two segment paths per flow.

    ``nodes1``/``nodes2`` ``[F, L]`` int32 (-1 padded), ``inter`` ``[F]``
    int32. Returns ``[F, 2L - 1]`` int32: minimal flows keep segment 1;
    detour flows append segment 2 minus its first node (the intermediate
    appears once). Segment rows are decoder outputs, so valid nodes form
    a prefix of each row."""
    n1 = np.asarray(nodes1, np.int32)
    n2 = np.asarray(nodes2, np.int32)
    inter = np.asarray(inter, np.int32)
    f, l = n1.shape
    out = np.full((f, 2 * l - 1), -1, np.int32)
    out[:, :l] = n1
    # only detour rows get a tail, so the row lengths and the splice
    # touch those rows alone
    idx = np.flatnonzero(inter >= 0)
    d2 = n2[idx]
    # valid-node counts as a product with ones: numpy's sum(axis=1) pays
    # a per-row cost on rows this short
    ones = np.ones(l, np.int32)
    len1 = (n1[idx] >= 0) @ ones
    len2 = (d2 >= 0) @ ones
    j = np.arange(l - 1)
    # rows with a real tail: n2[i, 1:len2[i]] to columns len1[i]..
    mask = j[None, :] < (len2 - 1)[:, None]
    rows, k = np.nonzero(mask)
    out[idx[rows], len1[rows] + k] = d2[:, 1:][mask]
    return out


def link_loads(paths: np.ndarray, weight: np.ndarray, v: int) -> np.ndarray:
    """Discrete ``[V, V]`` link loads of node paths (host-side; the
    native C++ scatter-add when built, numpy otherwise)."""
    from sdnmpi_tpu_torch import native

    return native.link_loads(paths, weight, v)

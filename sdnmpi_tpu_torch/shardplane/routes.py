"""The sharded collective: the DAG balancer and sampler over the mesh.

Counterpart of ``sdnmpi_tpu/shardplane/routes.py``'s
``route_collective_sharded`` (``_dag_step`` and ``_dag_step_ringed``).
Each shard propagates the traffic of its block of destinations and
samples its slice of the flows; the per-link loads are summed over the
shards in shard order (the reference's ``psum``), so every shard
reweights on the same global load. Distances reach every shard through
the ring all-gather (kernel K3): in gather mode as f32 rows, in ring
mode packed to the 2-byte wire (``exchange_distances``). Either way the
slots are those of ``oracle/dag.route_collective`` on the same inputs
where the loads sum alike. The sampler's set-up (kernel K2's tables) is
built once per device and shared by the shards' launches there.

The reference's other sharded legs (``batch_fdb_sharded/ringed``,
``route_flows_sharded``, ``route_adaptive_sharded``,
``multichip_route_step``) are not ported yet and raise.
"""

from __future__ import annotations

import torch

from sdnmpi_tpu_torch.kernels.ring import exchange_distances, ring_all_gather
from sdnmpi_tpu_torch.kernels.bfs import neighbor_rows_of
from sdnmpi_tpu_torch.kernels.sampler import sample_slots, sampler_tables
from sdnmpi_tpu_torch.shardplane.apsp import apsp_distances_rowsharded
from sdnmpi_tpu_torch.shardplane.mesh import ShardMesh, mesh_shards

INF = float("inf")


def _row_blocks(x, mesh: ShardMesh) -> list:
    """Row-sharded form of ``x``: a list passes through; a replicated
    tensor is cut into each shard's rows (views, on its device)."""
    if isinstance(x, (list, tuple)):
        return list(x)
    rp = x.shape[0] // mesh_shards(mesh)
    return [x[q * rp:(q + 1) * rp].to(d) for q, d in enumerate(mesh.devices)]


def _replicated(x, mesh: ShardMesh) -> list:
    """Every shard's full copy of ``x``: a row-sharded list is gathered
    by kernel K3 (on a card); a replicated tensor is read in place."""
    if isinstance(x, (list, tuple)):
        return ring_all_gather(list(x), mesh)
    return [x.to(d) for d in mesh.devices]


def _sum_over_shards(parts: list) -> torch.Tensor:
    """The ``psum``: shard 0's part plus the others, in shard order."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def route_collective_sharded(
    adj: torch.Tensor,  # [V, V] 0/1 (replicated)
    link_src: torch.Tensor,  # [E] int32 row index of each real link
    link_dst: torch.Tensor,  # [E] int32 col index
    link_util: torch.Tensor,  # [E] f32 measured utilization per link
    traffic: torch.Tensor,  # [V, V] f32 traffic[t, i] (replicated)
    src: torch.Tensor,  # [F] int32 flow sources (-1 pad)
    dst: torch.Tensor,  # [F] int32 flow destinations
    mesh: ShardMesh,
    levels: int,
    rounds: int,
    max_len: int,
    salt: int = 0,
    dist=None,  # cached distances: [V, V] tensor or row-sharded list
    dst_nodes: torch.Tensor | None = None,  # [T] int32 destination set (-1 pad)
    ring_exchange: bool = False,
    neigh: torch.Tensor | None = None,  # [V, D] int32 topology neighbour table
) -> tuple[list, torch.Tensor]:
    """``oracle.dag.route_collective`` sharded over every shard of the
    mesh. Shard q propagates the traffic of destination block q (of the
    V destinations, or of the ``dst_nodes`` set) and samples flows
    ``[q*F/s, (q+1)*F/s)`` with ``fid_base = q*F/s``, so every flow draws
    the noise of its global id.

    ``dist`` is the cached distance matrix, replicated or row-sharded;
    without it the distances are computed row-sharded (the reference
    computes them over the "v" axis only and reshards: the values are
    the same). ``ring_exchange`` streams the distance rows through the
    ring as wire words (``_dag_step_ringed``); otherwise row-sharded
    distances are replicated as f32 by the same kernel. ``neigh`` is the
    compact neighbour table of ``adj`` (``TopoTensors.neigh``); without
    it one is built here. V, F and T must divide by the shard count.

    Returns ``(slots, max_congestion)``: the slots as the per-shard list
    of ``[F/s, sampled_hops(max_len)]`` int8 blocks (flow-sharded; read
    them back with ``convert.gather_rows``) and the fractional max link
    load, a scalar tensor."""
    from sdnmpi_tpu_torch.oracle.dag import (
        _full_f32,
        congestion_weights,
        propagate_levels,
        restrict_dst_traffic,
        sampled_hops,
    )

    v = adj.shape[0]
    f = src.shape[0]
    s = mesh_shards(mesh)
    if v % s:
        raise ValueError(f"V={v} must divide by {s} shards")
    if f % s:
        raise ValueError(f"flow count {f} must divide by {s} shards")
    have_dst = dst_nodes is not None
    if have_dst and dst_nodes.shape[0] % s:
        raise ValueError(
            f"dst set T={dst_nodes.shape[0]} must divide by {s} shards"
        )
    _full_f32()
    hops = sampled_hops(max_len)
    rp = v // s
    f_per = f // s
    base = torch.zeros((v, v), dtype=torch.float32, device=adj.device)
    base[link_src.long(), link_dst.long()] = link_util.to(torch.float32)
    adj_f = (adj > 0).to(torch.float32)
    if dist is None:
        dist = apsp_distances_rowsharded(adj, mesh)
    if have_dst:
        t_per = dst_nodes.shape[0] // s
        dn_loc = [dst_nodes[q * t_per:(q + 1) * t_per] for q in range(s)]
        traffic_loc = [restrict_dst_traffic(traffic, dn) for dn in dn_loc]
    else:
        traffic_loc = [traffic[q * rp:(q + 1) * rp] for q in range(s)]
    # dist-independent prep first: in ring mode the exchange follows it
    weights = congestion_weights(adj_f, base)
    if ring_exchange:
        d_full = exchange_distances(_row_blocks(dist, mesh), mesh)
    else:
        d_full = _replicated(dist, mesh)
    d_t_loc = []
    for q, d in enumerate(d_full):
        if have_dst:
            dn = dn_loc[q]
            d_t_loc.append(torch.where(
                (dn >= 0)[:, None], d.T[dn.long().clamp(min=0)], INF
            ))
        else:
            d_t_loc.append(d.T[q * rp:(q + 1) * rp])

    def load_of(w):
        return _sum_over_shards([
            propagate_levels(w.to(dev), d_t_loc[q], traffic_loc[q].to(dev), levels)
            for q, dev in enumerate(mesh.devices)
        ])

    load = load_of(weights)
    for _ in range(rounds - 1):
        weights = congestion_weights(adj_f, base + load)
        load = load_of(weights)
    maxc = load.max()
    if neigh is None:
        neigh = neighbor_rows_of(adj)
    # K2's set-up once per device, shared by the launches of its shards;
    # one launch per shard, each with its own flows and fid_base
    tables = {}
    slots = []
    for q, dev in enumerate(mesh.devices):
        w_q = weights.to(dev)
        dn_q = dst_nodes.to(dev) if have_dst else None
        if dev not in tables:
            tables[dev] = sampler_tables(w_q, d_full[q], dn_q, neigh=neigh.to(dev))
        slots.append(sample_slots(
            w_q, d_full[q], src[q * f_per:(q + 1) * f_per].to(dev),
            dst[q * f_per:(q + 1) * f_per].to(dev), hops, salt=salt,
            dst_nodes=dn_q, fid_base=q * f_per, tables=tables[dev],
        ))
    return slots, maxc


def _not_ported(name: str):
    def raise_(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP A12 item 3)")

    raise_.__name__ = name
    return raise_


batch_fdb_sharded = _not_ported("batch_fdb_sharded")
batch_fdb_ringed = _not_ported("batch_fdb_ringed")
route_flows_sharded = _not_ported("route_flows_sharded")
route_adaptive_sharded = _not_ported("route_adaptive_sharded")
multichip_route_step = _not_ported("multichip_route_step")

"""Sharded flow batches over the mesh: the routing half of the shardplane.

Counterpart of ``sdnmpi_tpu/shardplane/routes.py``. Flow batches split
across the mesh's shards, ``F/s`` contiguous flows each, and every
shard keeps its flows' global ids (``fid_base = q * F/s``), so hashed
choices and sampled paths are those of the single-device programs. The
``[V, V]`` state is replicated or row-sharded as each leg needs;
row-sharded state is replicated by the ring all-gather (kernel K3).
Readback stays packed: the legs return per-shard ``[F/s, max_len]`` hop
rows or int8 slot streams, never an ``[F, V]`` intermediate.

- :func:`batch_fdb_sharded` and :func:`batch_fdb_ringed`: the shortest
  path chase of ``oracle/paths.batch_fdb``, on next hops replicated by
  one K3 launch, or streamed to the chase as int16 wire blocks, one ring
  step at a time.
- :func:`route_flows_sharded` and :func:`multichip_route_step`: the
  greedy scanner per shard, loads summed over the shards.
- :func:`route_adaptive_sharded`: the UGAL program, each shard choosing
  and sampling (kernel K2) its own flows, balanced on the summed traffic.
- :func:`route_collective_sharded`: the DAG balancer and sampler
  (``_dag_step`` and ``_dag_step_ringed``). Each shard propagates the
  traffic of its block of destinations and samples its slice of the
  flows; the per-link loads are summed over the shards in shard order
  (the reference's ``psum``), so every shard reweights on the same
  global load. Distances reach every shard through K3: in gather mode as
  f32 rows by one broadcast launch; in ring mode packed to the 2-byte
  wire and landed step by step on the exchange stream (K3's step form),
  started before the distance-independent prep and awaited where the
  distances are first read.

Work the reference replicates on every shard (the balancer on summed
traffic, K2's set-up) runs once per device here and is shared by the
shards placed there.

On a mesh over several processes each process runs its own shards:
the per-shard lists hold its blocks and ``None`` at the others' shards,
the loads are summed over every shard in shard order after K3 gathers
them, and the chase takes this process's flows. The greedy balancer,
the UGAL program and ``multichip_route_step`` raise there
(ROADMAP A4).
"""

from __future__ import annotations

import torch

from sdnmpi_tpu_torch.kernels import ring
from sdnmpi_tpu_torch.kernels.ring import (
    RingExchange,
    finish_distance_exchange,
    pack_next_wire,
    ring_all_gather,
    start_distance_exchange,
    unpack_next_wire,
)
from sdnmpi_tpu_torch.kernels.bfs import neighbor_rows_of
from sdnmpi_tpu_torch.kernels.sampler import sample_slots, sampler_tables
from sdnmpi_tpu_torch.oracle.congestion import route_flows_balanced
from sdnmpi_tpu_torch.oracle.paths import batch_fdb, fdb_ports
from sdnmpi_tpu_torch.shardplane.apsp import (
    apsp_distances_rowsharded,
    apsp_distances_sharded,
)
from sdnmpi_tpu_torch.shardplane.mesh import ShardMesh, later, mesh_shards

INF = float("inf")


def _row_blocks(x, mesh: ShardMesh) -> list:
    """Row-sharded form of ``x``: a list passes through; a replicated
    tensor is cut into each shard's rows (views, on its device; ``None``
    at another process's shards)."""
    if isinstance(x, (list, tuple)):
        return list(x)
    rp = x.shape[0] // mesh_shards(mesh)
    return [x[q * rp:(q + 1) * rp].to(d) if q in mesh.local else None
            for q, d in enumerate(mesh.devices)]


def _replicated(x, mesh: ShardMesh) -> list:
    """Every shard's full copy of ``x``: a row-sharded list is gathered
    by kernel K3 (on a card); a replicated tensor is read in place
    (``None`` at another process's shards)."""
    if isinstance(x, (list, tuple)):
        return ring_all_gather(list(x), mesh)
    return [x.to(d) if q in mesh.local else None for q, d in enumerate(mesh.devices)]


def _sum_over_shards(parts: list, mesh: ShardMesh) -> torch.Tensor:
    """The ``psum``: shard 0's part plus the others, in shard order. On a
    mesh over several processes the parts (this process's shards' entries
    of ``parts``) are gathered by kernel K3 first, so every process adds
    the same parts in the same order and gets one process's sum bit for
    bit."""
    if mesh.multiprocess:
        shape = next(p for p in parts if p is not None).shape
        flat = [None if p is None else p.reshape(1, -1) for p in parts]
        every = ring_all_gather(flat, mesh)[mesh.local[0]]
        parts = [row.reshape(shape) for row in every]
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
    ring as wire words on the exchange stream (``_dag_step_ringed``):
    the exchange starts before the distance-independent prep (the
    utilization scatter, the traffic blocks, the first congestion
    reweighting) and the current stream waits for it only where the
    distances are first read; otherwise row-sharded distances are
    replicated as f32 by K3. ``neigh`` is the
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
    if dist is None:
        dist = apsp_distances_rowsharded(adj, mesh)
    if ring_exchange:  # in flight behind the dist-independent prep
        exchange = start_distance_exchange(_row_blocks(dist, mesh), mesh)
    base = torch.zeros((v, v), dtype=torch.float32, device=adj.device)
    base[link_src.long(), link_dst.long()] = link_util.to(torch.float32)
    adj_f = (adj > 0).to(torch.float32)
    if have_dst:
        t_per = dst_nodes.shape[0] // s
        dn_loc = [dst_nodes[q * t_per:(q + 1) * t_per] for q in range(s)]
        traffic_loc = [restrict_dst_traffic(traffic, dn_loc[q]) if q in mesh.local
                       else None for q in range(s)]
    else:
        traffic_loc = [traffic[q * rp:(q + 1) * rp] for q in range(s)]
    # dist-independent prep first: in ring mode the exchange overlaps it
    weights = congestion_weights(adj_f, base)
    if ring_exchange:
        d_full = finish_distance_exchange(exchange)
    else:
        d_full = _replicated(dist, mesh)
    d_t_loc = [None] * s
    for q in mesh.local:
        d = d_full[q]
        if have_dst:
            dn = dn_loc[q]
            d_t_loc[q] = torch.where(
                (dn >= 0)[:, None], d.T[dn.long().clamp(min=0)], INF
            )
        else:
            d_t_loc[q] = d.T[q * rp:(q + 1) * rp]

    def load_of(w):
        return _sum_over_shards([
            propagate_levels(w.to(dev), d_t_loc[q], traffic_loc[q].to(dev), levels)
            if q in mesh.local else None
            for q, dev in enumerate(mesh.devices)
        ], mesh)

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
    slots = [None] * s
    for q in mesh.local:
        dev = mesh.devices[q]
        w_q = weights.to(dev)
        dn_q = dst_nodes.to(dev) if have_dst else None
        if dev not in tables:
            tables[dev] = sampler_tables(w_q, d_full[q], dn_q, neigh=neigh.to(dev))
        slots[q] = sample_slots(
            w_q, d_full[q], src[q * f_per:(q + 1) * f_per].to(dev),
            dst[q * f_per:(q + 1) * f_per].to(dev), hops, salt=salt,
            dst_nodes=dn_q, fid_base=q * f_per, tables=tables[dev],
        )
    return slots, maxc


def _flow_slices(n: int, mesh: ShardMesh) -> list:
    """Each shard's slice of an ``n``-flow batch; raises unless the shard
    count divides ``n``."""
    s = mesh_shards(mesh)
    if n % s:
        raise ValueError(f"flow count {n} must divide by {s} shards")
    per = n // s
    return [slice(q * per, (q + 1) * per) for q in range(s)]


def _per_device(mesh: ShardMesh, fn) -> dict:
    """``fn(device)`` once for each device of the mesh: the work the
    reference replicates on every shard, shared by the shards placed on
    one device (this process's)."""
    out = {}
    for dev in (mesh.devices[q] for q in mesh.local):
        if dev not in out:
            out[dev] = fn(dev)
    return out


def batch_fdb_sharded(
    next_hop,  # [V, V] int32 tensor, or row-sharded list of [V/s, V] blocks
    port: torch.Tensor,  # [V, V] int32 (replicated)
    src: torch.Tensor,  # [F] int32 (-1 pad)
    dst: torch.Tensor,  # [F] int32
    final_port: torch.Tensor,  # [F] int32
    max_len: int,
    mesh: ShardMesh,
) -> tuple[list, list, list]:
    """Flow-sharded twin of ``oracle.paths.batch_fdb``: shard q chases
    flows ``[q*F/s, (q+1)*F/s)`` on the whole next-hop matrix. Row-sharded
    next hops are replicated by one K3 launch first (the reference's
    all-gather). The chase is per-flow deterministic, so the blocks are
    bit-identical to the single-device extraction. Returns per-shard
    lists ``(nodes [F/s, max_len], ports [F/s, max_len], length [F/s])``;
    read them back with ``convert.gather_rows``. Requires ``F % s == 0``."""
    parts = _flow_slices(src.shape[0], mesh)
    full = _replicated(next_hop, mesh)
    s = mesh_shards(mesh)
    nodes, ports, length = [None] * s, [None] * s, [None] * s
    for q in mesh.local:
        sl, dev = parts[q], mesh.devices[q]
        nodes[q], ports[q], length[q] = batch_fdb(
            full[q], port.to(dev), src[sl].to(dev), dst[sl].to(dev),
            final_port[sl].to(dev), max_len,
        )
    return nodes, ports, length


def batch_fdb_ringed(
    next_hop,  # row-sharded list of [V/s, V] int32 blocks, or a [V, V] tensor
    port: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    final_port: torch.Tensor,
    max_len: int,
    mesh: ShardMesh,
) -> tuple[list, list, list]:
    """Ring-exchange twin of :func:`batch_fdb_sharded`, the same contract
    and bit-identical rows (the reference's ``_batch_fdb_ringed_fn``).

    Each shard packs its next-hop rows to the int16 wire (int32 past
    ``ring.NEXT_WIRE_MAX_V``) and a :class:`~sdnmpi_tpu_torch.kernels.ring.RingExchange`
    lands them, one ring step at a time on the exchange stream, in every
    shard's own ``[V, V]`` view; :func:`chase_exchange` consumes each
    step's arrivals as they land."""
    blocks = _row_blocks(next_hop, mesh)
    v = blocks[mesh.local[0]].shape[1]
    wire16 = v <= ring.NEXT_WIRE_MAX_V
    return chase_exchange(
        lambda: RingExchange([b if b is None or not wire16 else pack_next_wire(b)
                              for b in blocks], mesh),
        port, src, dst, final_port, max_len, mesh, v,
    )


def chase_exchange(start, port, src, dst, final_port, max_len: int,
                   mesh: ShardMesh, v: int) -> tuple[list, list, list]:
    """The gated chase of :func:`batch_fdb_ringed` on the exchange that
    ``start()`` begins (called once the chase's index tensors are built,
    so that nothing in the gated loop copies from the host).

    Each arrival sets the shard's flag for its origin and advances its
    flows by ``ceil(max_len / s)`` hops, each hop gated on the row block
    of the flow's current switch having arrived at that shard, and
    reading that shard's view; a completion pass of ``max_len`` hops
    after the last arrival finishes every flow, and the validity tail of
    ``batch_paths`` keeps only flows that reached their destination.
    Arrival order changes when a hop happens, never what it reads.

    Every shard receives its i-th block at the same step, so the shards
    chase together: each hop is one batch over all the flows. The hops
    of step t's arrivals wait for step t only, and run while step t+1's
    copies are in flight; the current stream is joined to the exchange
    before the completion pass, so a reap reads a finished window.

    On a mesh over several processes a process chases its own shards'
    flows, on its shards' views."""
    s = mesh_shards(mesh)
    parts = _flow_slices(src.shape[0], mesh)
    if v % s:
        raise ValueError(f"V={v} must divide by {s} shards")
    rp = v // s
    # opportunistic hops per arrival; the completion pass has the full
    # budget, so a flow stalled on a late block still finishes
    h_opp = max(1, -(-max_len // s))
    dev = mesh.device
    f_per = parts[0].stop - parts[0].start
    mine = slice(parts[mesh.local[0]].start, parts[mesh.local[-1]].stop)
    n_local = len(mesh.local)
    # each flow's shard: its index among this process's (the row of
    # ``arrived`` and the view it reads) and its ring index
    owner = torch.arange(n_local, device=dev).repeat_interleave(f_per)
    shard_ids = torch.arange(mesh.local[0], mesh.local[-1] + 1, device=dev)
    node = src[mine].to(dev).long()
    t = dst[mine].to(dev).long()
    t_safe = t.clamp(min=0)
    rows = torch.arange(node.shape[0], device=dev)
    k = torch.zeros_like(node)
    out = torch.full((node.shape[0], max_len), -1, dtype=torch.int32, device=dev)
    arrived = torch.zeros((n_local, s), dtype=torch.bool, device=dev)
    raised = torch.ones(n_local, dtype=torch.bool, device=dev)
    rows_local = torch.arange(n_local, device=dev)
    # each step's origins at every shard, cw before ccw
    origins = [[(shard_ids + d) % s for d in ring.step_offsets(step, s)]
               for step in range(max(ring.ring_legs(s)) + 1)]
    ex = start()
    views = ex.views  # [s, V, V]: shard q's rows land in views[q]
    wire16 = views.dtype == torch.int16

    def hop(node, k):
        at_dst = node == t
        safe = node.clamp(0, v - 1)
        avail = arrived[owner, safe // rp]
        can = (node >= 0) & (k < max_len) & (avail | at_dst)
        nxt = views[owner, safe, t_safe]
        nxt = (unpack_next_wire(nxt) if wire16 else nxt).long()
        nxt = torch.where(at_dst | (t < 0), -1, nxt)
        kcl = k.clamp(max=max_len - 1)
        out[rows, kcl] = torch.where(can, node, out[rows, kcl].long()).to(torch.int32)
        return torch.where(can, nxt, node), k + can.long()

    for step, arrivals in enumerate(origins):
        ex.wait(step)
        for origin in arrivals:
            arrived.index_put_((rows_local, origin), raised)
            for _ in range(h_opp):
                node, k = hop(node, k)
    ex.join()
    for _ in range(max_len):
        node, k = hop(node, k)
    # batch_paths' validity tail: a flow counts only if it reached
    ln = (out >= 0).sum(dim=1)
    last = out.gather(1, (ln - 1).clamp(min=0)[:, None])[:, 0]
    reached = (ln > 0) & (last == t)
    n = torch.where(reached[:, None], out, -1)
    ln = torch.where(reached, ln, 0).to(torch.int32)
    p = fdb_ports(port.to(dev), n, ln, final_port[mine].to(dev))
    out = ([None] * s, [None] * s, [None] * s)
    for lst, x in zip(out, (n, p, ln)):
        for q, blk in zip(mesh.local, x.split(f_per)):
            lst[q] = blk
    return out


def window_readback_nbytes(wr) -> int:
    """Host-ward bytes of one reaped window's struct arrays — the
    packed-readback accounting the shardplane contract is asserted
    with (bytes proportional to occupied flows x hop budget, never
    F_padded x V)."""
    total = wr.hop_dpid.nbytes + wr.hop_port.nbytes + wr.hop_len.nbytes
    if getattr(wr, "touched", None) is not None:
        total += wr.touched.nbytes
    return int(total)


def route_flows_sharded(
    adj: torch.Tensor,  # [V, V] 0/1 (replicated)
    dist,  # [V, V] f32 tensor, or row-sharded list
    base_cost: torch.Tensor,  # [V, V] f32
    src: torch.Tensor,  # [U] int32 (-1 pad)
    dst: torch.Tensor,
    weight: torch.Tensor,  # [U] f32 (0 pad)
    mesh: ShardMesh,
    max_len: int,
    chunk: int = 1024,
    neigh: torch.Tensor | None = None,  # [V, D] int32 topology neighbour table
) -> tuple[list, torch.Tensor, torch.Tensor]:
    """Flow batch sharded over the mesh: every shard balances its own
    flows with the greedy scanner (``oracle.congestion.route_flows_balanced``,
    flow ids local to the shard, as the reference's shard_map body sees
    them), and the shards' link loads are summed in shard order (the
    ``psum``). Returns ``(nodes, load, max_congestion)``: the per-shard
    ``[U/s, max_len]`` node blocks, the summed ``[V, V]`` f32 load and
    its max over real links."""
    later("route_flows_sharded", mesh)
    parts = _flow_slices(src.shape[0], mesh)
    full = _replicated(dist, mesh)
    if neigh is None:
        neigh = neighbor_rows_of(adj)
    nodes, loads = [], []
    for q, (sl, dev) in enumerate(zip(parts, mesh.devices)):
        n, load, _ = route_flows_balanced(
            adj.to(dev), full[q], base_cost.to(dev), src[sl].to(dev),
            dst[sl].to(dev), weight[sl].to(dev), max_len, chunk=chunk,
            neigh=neigh.to(dev),
        )
        nodes.append(n)
        loads.append(load)
    load = _sum_over_shards(loads, mesh)
    maxc = torch.where(adj.to(load.device) > 0, load, 0.0).max()
    return nodes, load, maxc


def route_adaptive_sharded(
    adj: torch.Tensor,  # [V, V] 0/1 (replicated)
    util: torch.Tensor,  # [V, V] f32 measured utilization (replicated)
    src: torch.Tensor,  # [F] int32 (-1 pad)
    dst: torch.Tensor,
    weight: torch.Tensor,  # [F] f32 (0 pad)
    n_valid: int,
    mesh: ShardMesh,
    levels: int,
    max_len: int = 8,
    rounds: int = 2,
    n_candidates: int = 4,
    bias: float = 1.0,
    dist=None,  # cached distances: [V, V] tensor or row-sharded list
    packed: bool = False,
    neigh: torch.Tensor | None = None,  # [V, D] int32 topology neighbour table
) -> tuple[list, list, list, torch.Tensor]:
    """``oracle.adaptive.route_adaptive`` with the flow batch sharded over
    every shard of the mesh.

    Shard q makes the UGAL choice for flows ``[q*F/s, (q+1)*F/s)`` with
    ``fid_base = q*F/s`` and builds their traffic; the shards' traffic
    matrices are summed in shard order (the reference's ``psum``), and
    the balancer runs on the whole batch's traffic, so split weights and
    load are the single-device program's. Then each shard samples both
    segments of its flows with kernel K2 (salts 0 and ``0x5BD1E995``,
    as the reference's), every launch on a device sharing one set-up.
    Traffic accumulates in float64 per shard and is cast once after the
    sum, as ``route_adaptive`` does, so the result equals the
    single-device port's on the same batch; against the reference's f32
    sums it is bit-equal where the weights sum exactly (integers).

    Without ``dist`` the exact distances of ``oracle.apsp.apsp_distances``
    are used, as the reference does (no kernel K1); row-sharded ``dist``
    is replicated by one K3 launch. Returns ``(inter, nodes1, nodes2,
    load)``: per-shard lists of ``[F/s]`` intermediates and
    ``[F/s, max_len]`` node rows, and the replicated ``[V, V]`` load. With
    ``packed=True`` the segments come back as the int8 slot streams;
    decode them with ``oracle.adaptive.decode_segments``."""
    from sdnmpi_tpu_torch.oracle.adaptive import (
        congestion_cost,
        dag_weighted_costs,
        ugal_choose,
    )
    from sdnmpi_tpu_torch.oracle.apsp import apsp_distances
    from sdnmpi_tpu_torch.oracle.dag import (
        balance_rounds,
        decode_slots_device,
        sampled_hops,
    )

    later("route_adaptive_sharded (the sharded UGAL program)", mesh)
    v = adj.shape[0]
    parts = _flow_slices(src.shape[0], mesh)
    if neigh is None:
        neigh = neighbor_rows_of(adj)
    if dist is None:
        d_dev = _per_device(mesh, lambda dev: apsp_distances(adj.to(dev)))
    else:
        full = _replicated(dist, mesh)
        d_dev = {}
        for q, dev in enumerate(mesh.devices):
            d_dev.setdefault(dev, full[q])
    dmin = _per_device(mesh, lambda dev: dag_weighted_costs(
        adj.to(dev), d_dev[dev], congestion_cost(adj.to(dev), util.to(dev)),
        levels, neigh=neigh.to(dev),
    ))
    seg, traffic_parts = [], []
    for q, (sl, dev) in enumerate(zip(parts, mesh.devices)):
        s, t = src[sl].to(dev), dst[sl].to(dev)
        inter = ugal_choose(
            dmin[dev], s, t, n_valid, n_candidates=n_candidates, bias=bias,
            fid_base=sl.start,
        )
        s, t = s.long(), t.long()
        detour = inter >= 0
        mid = torch.where(detour, inter.long(), t)
        s2 = torch.where(detour, mid, -1)
        d2 = torch.where(detour, t, -1)
        w_live = torch.where(
            (s >= 0) & (t >= 0), weight[sl].to(dev).to(torch.float64), 0.0)
        tr = torch.zeros(v * v, dtype=torch.float64, device=dev)
        tr.index_add_(0, mid.clamp(min=0) * v + s.clamp(min=0),
                      torch.where(s >= 0, w_live, 0.0))
        tr.index_add_(0, d2.clamp(min=0) * v + s2.clamp(min=0),
                      torch.where(detour, w_live, 0.0))
        traffic_parts.append(tr)
        seg.append((inter, s.to(torch.int32), mid.to(torch.int32),
                    s2.to(torch.int32), d2.to(torch.int32)))
    # the one collective: every shard balances the whole batch's traffic
    traffic = _sum_over_shards(traffic_parts, mesh).to(torch.float32).reshape(v, v)
    balanced = _per_device(mesh, lambda dev: balance_rounds(
        adj.to(dev), d_dev[dev], util.to(dev), traffic.to(dev),
        levels=levels, rounds=rounds,
    )[:2])
    # K2's set-up once per device, shared by both segments of its shards
    tables = _per_device(mesh, lambda dev: sampler_tables(
        balanced[dev][0], d_dev[dev], None, neigh=neigh.to(dev)))
    hops = sampled_hops(max_len)
    inters, out1, out2 = [], [], []
    for q, (sl, dev) in enumerate(zip(parts, mesh.devices)):
        inter, s, mid, s2, d2 = seg[q]
        w, d = balanced[dev][0], d_dev[dev]
        sl1 = sample_slots(w, d, s, mid, hops, fid_base=sl.start,
                           tables=tables[dev])
        sl2 = sample_slots(w, d, s2, d2, hops, salt=0x5BD1E995,
                           fid_base=sl.start, tables=tables[dev])
        if not packed:
            a = adj.to(dev)
            sl1 = decode_slots_device(a, sl1, s, mid)[:, :max_len]
            sl2 = decode_slots_device(a, sl2, s2, d2)[:, :max_len]
        inters.append(inter)
        out1.append(sl1)
        out2.append(sl2)
    return inters, out1, out2, balanced[mesh.devices[0]][1]


def multichip_route_step(
    adj: torch.Tensor,
    base_cost: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    weight: torch.Tensor,
    mesh: ShardMesh,
    max_len: int,
    chunk: int = 1024,
    neigh: torch.Tensor | None = None,
):
    """The whole sharded oracle step: distances row-sharded over the
    mesh's "v" axis (the matmul BFS, no kernel K1), the blocks joined
    into the replicated matrix (the reference's implicit XLA all-gather,
    not its ring kernel), then :func:`route_flows_sharded`."""
    later("multichip_route_step", mesh)
    blocks = apsp_distances_sharded(adj, mesh)
    dist = torch.cat([b.to(adj.device) for b in blocks])
    return route_flows_sharded(
        adj, dist, base_cost, src, dst, weight, mesh, max_len, chunk, neigh,
    )

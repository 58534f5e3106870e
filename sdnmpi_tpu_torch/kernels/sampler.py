"""Per-flow path sampling: kernel K2 and its plain versions.

Counterpart of ``sdnmpi_tpu/kernels/sampler.py`` and of the dense XLA
sampler ``sdnmpi_tpu/oracle/dag.sample_paths_dense``. Every flow walks
the shortest-path DAG toward its destination; at each hop it takes,
among the current node's real out-links one hop closer to the
destination, ``argmax(bf16 log w + Gumbel)``. The Gumbel noise is a
32-bit hash of (flow id, neighbour, hop, salt) turned into a uniform by a
mantissa bitcast, so every implementation draws the same numbers. The
output slot is the chosen neighbour's rank among the node's sorted
out-neighbours; -1 marks the end of the path.

- :func:`sample_paths_dense` is the independent plain version (the
  reference's dense formulation as torch ops, every per-flow quantity a
  ``[F, V]`` row). The kernel is held against it on the card.
- :func:`sampler_tables` is the per-call set-up, built once and shared by
  any number of launches (the sharded program's per-shard calls): the
  topology's compact sorted out-neighbour table ``[V, D]``, the bf16 log
  weight of each of those links, the bf16 distance rows the flows read
  and each destination's row. Its work is proportional to links and to
  the destination set, not to ``V * V``, except without a destination
  set, where one ``[V, V]`` transpose remains. A CPU tensor takes
  :func:`sampler_tables_plain` (torch ops), a CUDA tensor launches the
  set-up kernels of ``csrc/sampler.cu``.
- :func:`sample_slots` is the wrapper: a CPU tensor takes
  :func:`sample_paths_dense`, a CUDA tensor launches ``csrc/sampler.cu``
  over the tables or raises.

A slot is a position in the neighbour table. It equals the dense
version's rank among ``weights > 0`` because the balancer's weights are
positive exactly on the links (``oracle/dag.congestion_weights``).

torch has no ``>>`` for uint32 on the CPU, so the plain versions carry
the hash in int64 holding 32-bit values, with products split so that
nothing overflows; ``.view(torch.float32)`` is the bitcast.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from sdnmpi_tpu_torch.kernels import _build
from sdnmpi_tpu_torch.kernels.bfs import neighbor_rows_of

#: distance stand-in for unreachable pairs: exact in bf16 and larger
#: than any real hop count
UNREACH = 16384.0
#: log-weight marker of "no link"; every real log weight is > -1e3
NO_LINK = -1e4
_MASK = 0xFFFFFFFF
#: warps per SM that a launch of kernel K2 should fill before it gives
#: a flow fewer lanes (:func:`lane_group`)
WARPS_PER_SM = 16


def log_weights(weights: torch.Tensor) -> torch.Tensor:
    """bf16 log split weights, ``NO_LINK`` where w == 0 (any shape)."""
    return torch.where(
        weights > 0.0, torch.log(torch.clamp(weights, min=1e-30)), NO_LINK
    ).to(torch.bfloat16)


def dist_rows(dist: torch.Tensor) -> torch.Tensor:
    """``[V, V]`` bf16 distance table by destination: row t holds every
    node's hop count to t, ``UNREACH`` for inf."""
    return (
        torch.where(torch.isfinite(dist), dist, UNREACH)
        .T.to(torch.bfloat16).contiguous()
    )


def dist_table(
    dist: torch.Tensor, dst_nodes: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The distance rows the flows read: ``(table [R, V] bf16, row_of)``.
    Without ``dst_nodes`` the table is :func:`dist_rows` and a flow reads
    row ``dst`` (``row_of`` is None). With it the table is the compact
    ``[T, V]`` block of the destination set, read straight from the
    distance columns the set names (-1 entries are padding and read
    ``UNREACH``), and ``row_of [V]`` int32 holds each node's first
    position in the set, -1 where it is absent."""
    if dst_nodes is None:
        return dist_rows(dist), None
    v = dist.shape[0]
    t = dst_nodes.shape[0]
    dn = dst_nodes.long()
    valid = dn >= 0
    cols = dist.T[dn.clamp(min=0)]  # [T, V]: every node's hop count to dn[t]
    table = torch.where(
        valid[:, None] & torch.isfinite(cols), cols, UNREACH
    ).to(torch.bfloat16)
    # first position of each node in the set (t = absent); pads land in
    # the spare entry v
    first = torch.full((v + 1,), t, dtype=torch.int64, device=dist.device)
    first.scatter_reduce_(
        0, torch.where(valid, dn, v),
        torch.arange(t, dtype=torch.int64, device=dist.device),
        reduce="amin",
    )
    row_of = torch.where(first[:v] < t, first[:v], -1).to(torch.int32)
    return table.contiguous(), row_of


@dataclasses.dataclass(frozen=True)
class SamplerTables:
    """The per-call set-up of kernel K2 (see :func:`sampler_tables`)."""

    neigh: torch.Tensor  # [V, D] int32 sorted out-neighbours, >= V past the degree
    lw: torch.Tensor  # [V, D] bf16 log weight of each entry, NO_LINK on padding
    dtab: torch.Tensor  # [R, V] bf16 distance rows
    row_of: torch.Tensor | None  # [V] int32 row of each destination; None: row = dst


def sampler_tables(
    weights: torch.Tensor,  # [V, V] f32 split weights (0 = no link)
    dist: torch.Tensor,  # [V, V] f32 hop distances
    dst_nodes: torch.Tensor | None = None,  # [T] int32 destination set (-1 pad)
    neigh: torch.Tensor | None = None,  # [V, D] int32 topology table
) -> SamplerTables:
    """K2's set-up for one set of weights and distances, shared by every
    launch on them. ``neigh`` is the topology's compact neighbour table
    (``kernels.bfs.neighbor_rows`` of the adjacency, built once per
    topology version); without it one is built from ``weights > 0``, as
    part of this set-up. Only the table's links are read from
    ``weights``. CPU tensors take :func:`sampler_tables_plain`; CUDA
    tensors launch the set-up kernels of ``csrc/sampler.cu`` or raise."""
    v = weights.shape[0]
    if weights.shape != (v, v) or dist.shape != (v, v):
        raise ValueError("weights and dist must both be [V, V]")
    if weights.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sampler_tables runs on cpu or cuda, not {weights.device}")
    if neigh is None:
        neigh = neighbor_rows_of(weights)
    if neigh.dim() != 2 or neigh.shape[0] != v or neigh.dtype != torch.int32:
        raise ValueError("neigh must be a [V, D] int32 table")
    if weights.device.type == "cpu":
        return sampler_tables_plain(weights, dist, dst_nodes, neigh)
    for name, x in (("dist", dist), ("dst_nodes", dst_nodes), ("neigh", neigh)):
        if x is not None and x.device != weights.device:
            raise ValueError(f"{name} is on {x.device}, weights on {weights.device}")
    # rows may be strided (an occupied block of a larger matrix); columns
    # must be dense
    weights, dist = (
        x if x.stride(1) == 1 else x.contiguous()
        for x in (weights.to(torch.float32), dist.to(torch.float32))
    )
    neigh = neigh.contiguous()
    d = neigh.shape[1]
    dev = weights.device
    lw = torch.empty((v, d), dtype=torch.bfloat16, device=dev)
    if dst_nodes is None:
        dn, rows, row_of = None, v, None
    else:
        dn = dst_nodes.to(torch.int32).contiguous()
        rows = dn.shape[0]
        row_of = torch.empty(v, dtype=torch.int32, device=dev)
    dtab = torch.empty((rows, v), dtype=torch.bfloat16, device=dev)
    if v == 0:
        return SamplerTables(neigh, lw, dtab, row_of)
    fn = _build.function("sampler", "sampler_setup_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ])
    err = fn(
        neigh.data_ptr(), weights.data_ptr(), weights.stride(0),
        dist.data_ptr(), dist.stride(0),
        None if dn is None else dn.data_ptr(), rows, v, d, lw.data_ptr(),
        dtab.data_ptr(), None if row_of is None else row_of.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(err, "sampler set-up")
    sampler_tables.launches += 1
    return SamplerTables(neigh, lw, dtab, row_of)


#: set-up launches of :func:`sampler_tables` (CPU calls do not count)
sampler_tables.launches = 0


def sampler_tables_plain(
    weights: torch.Tensor,
    dist: torch.Tensor,
    dst_nodes: torch.Tensor | None,
    neigh: torch.Tensor,
) -> SamplerTables:
    """The set-up as torch ops: the log weights of the table's entries,
    :func:`dist_table`'s rows and each node's row."""
    v = weights.shape[0]
    valid = neigh < v
    w = weights.gather(1, torch.where(valid, neigh, 0).long())
    lw = log_weights(torch.where(valid, w, 0.0))
    dtab, row_of = dist_table(dist, dst_nodes)
    return SamplerTables(neigh.contiguous(), lw.contiguous(), dtab, row_of)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 tensors holding 32-bit values, in
    two 16-bit halves of ``c`` so no product leaves the int64 range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """The reference's xorshift-multiply mix, on int64-held uint32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(mix: torch.Tensor, hop: int, salt: int) -> torch.Tensor:
    """f32 Gumbel noise of hop ``hop`` from the hop-invariant mix
    ``(fid * 2654435761) ^ (node * 0x85EBCA77)`` (int64-held uint32)."""
    hh = ((hop + 1) * 0x9E3779B1 + (salt & _MASK)) & _MASK
    u = _hash_u32(mix ^ hh)
    bits = (0x3F800000 | (u >> 9) | 1).to(torch.int32)
    un = bits.view(torch.float32) - 1.0
    return -torch.log(-torch.log(un))


def sample_paths_dense(
    weights: torch.Tensor,  # [V, V] f32 split weights (0 = no link)
    dist: torch.Tensor,  # [V, V] f32 hop distances
    src: torch.Tensor,  # [F] int32 (-1 = padding)
    dst: torch.Tensor,  # [F] int32
    max_len: int,
    salt: int = 0,
    fid_base: int = 0,  # global index of flow 0
    dst_nodes: torch.Tensor | None = None,  # [T] int32 destination set (-1 pad)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: every per-flow quantity is a dense ``[F, V]`` row.

    Returns ``(nodes [F, max_len] int32, slots [F, max_len] int8)``:
    the node each flow stands on before hop h and the slot it took
    there (-1 padded), as ``sdnmpi_tpu``'s ``sample_paths_dense``."""
    return sample_paths_lw(
        log_weights(weights), dist, src, dst, max_len, salt=salt,
        fid_base=fid_base, dst_nodes=dst_nodes,
    )


def sample_paths_lw(
    lw_bf: torch.Tensor,  # [V, V] bf16 log weights (NO_LINK = no link)
    dist: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    max_len: int,
    salt: int = 0,
    fid_base: int = 0,
    dst_nodes: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sample_paths_dense` from precomputed bf16 log weights (the
    form in which another implementation's weights can be fed in)."""
    v = lw_bf.shape[0]
    f = src.shape[0]
    dev = lw_bf.device
    table, row_of = dist_table(dist, dst_nodes)
    src = src.long()
    dst = dst.long()
    # each flow's row of the table, -1 for a dead flow (dst < 0, or
    # missing from the destination set)
    row = dst if row_of is None else row_of.long()[dst.clamp(min=0)]
    row = torch.where(dst >= 0, row, -1)
    d2t = table[row.clamp(min=0)].to(torch.float32)  # [F, V]

    iota = torch.arange(v, dtype=torch.int64, device=dev)
    fid = (torch.arange(f, dtype=torch.int64, device=dev) + fid_base) & _MASK
    mix = _mul32(fid, 2654435761)[:, None] ^ _mul32(iota, 0x85EBCA77)[None, :]
    alive = (src >= 0) & (dst >= 0) & (row >= 0)
    dsrc = d2t.gather(1, src.clamp(min=0)[:, None])[:, 0]
    node = torch.where(alive & (dsrc < UNREACH), src, -1)

    nodes, slots = [], []
    for h in range(max_len):
        moving = (node >= 0) & (node != dst)
        safe = node.clamp(min=0)
        lwrow = lw_bf[safe].to(torch.float32)  # [F, V] log w out of node
        arow = lwrow > -1e3  # real links only
        dcur = d2t.gather(1, safe[:, None])
        cand = arow & (d2t == dcur - 1.0)
        score = torch.where(
            cand, lwrow + gumbel_noise(mix, h, salt), float("-inf")
        )
        nxt = score.argmax(dim=1)
        has = cand.any(dim=1)
        # rank of nxt among the node's sorted out-neighbours
        slot = (arow & (iota[None, :] < nxt[:, None])).sum(dim=1)
        ok = moving & has
        nodes.append(node)
        slots.append(torch.where(ok, slot, -1))
        node = torch.where(ok, nxt, -1)
    if not nodes:
        empty = torch.empty((f, 0), dtype=torch.int32, device=dev)
        return empty, empty.to(torch.int8)
    return (
        torch.stack(nodes, dim=1).to(torch.int32),
        torch.stack(slots, dim=1).to(torch.int8),
    )


def lane_group(n_flows: int, n_sms: int) -> int:
    """Lanes per flow of kernel K2: 4 where the batch's warps at 4 lanes
    fill :data:`WARPS_PER_SM` warps on each of ``n_sms`` SMs, else 8.
    Fewer lanes issue fewer instructions per flow (a large batch is
    issue-bound); more lanes hide the latency of a small batch's
    dependent loads. On an H100 (PERF.md) 4 lanes were fastest at
    config 4's 85,556 flows and 8 at config 13's 10,695 per shard."""
    return 4 if n_flows * 4 >= 32 * WARPS_PER_SM * n_sms else 8


def _check_tables(tables: SamplerTables, v: int, device) -> None:
    """Raise on tables the kernel does not take."""
    n, lw, dtab, row_of = tables.neigh, tables.lw, tables.dtab, tables.row_of
    ok = (
        n.dim() == 2 and n.shape[0] == v and n.dtype == torch.int32
        and lw.shape == n.shape and lw.dtype == torch.bfloat16
        and dtab.dim() == 2 and dtab.shape[1] == v and dtab.dtype == torch.bfloat16
        and (row_of is None or (row_of.shape == (v,) and row_of.dtype == torch.int32))
    )
    if not ok:
        raise ValueError("sampler tables do not match [V, V] weights")
    for x in (n, lw, dtab, row_of):
        if x is not None and (x.device != device or not x.is_contiguous()):
            raise ValueError(f"sampler tables must be contiguous on {device}")


def sample_slots(
    weights: torch.Tensor,  # [V, V] f32 split weights (0 = no link)
    dist: torch.Tensor,  # [V, V] f32 hop distances
    src: torch.Tensor,  # [F] int32 (-1 pad)
    dst: torch.Tensor,  # [F] int32
    hops: int,
    salt: int = 0,
    dst_nodes: torch.Tensor | None = None,  # [T] int32 destination set (-1 pad)
    fid_base: int = 0,  # global index of flow 0 (a shard's offset)
    tables: SamplerTables | None = None,
) -> torch.Tensor:
    """Sampled slot streams ``[F, hops]`` int8, the slots output of
    :func:`sample_paths_dense` with the same arguments.

    ``dst_nodes`` selects the compact destination-set layout; it must
    hold every live flow's ``dst`` (flows whose ``dst`` it lacks read
    as unroutable). ``tables`` is :func:`sampler_tables` of these
    weights, distances and destination set, shared between calls;
    without it the wrapper builds it. CPU tensors take
    :func:`sample_paths_dense`; CUDA tensors launch kernel K2."""
    v = weights.shape[0]
    if weights.shape != (v, v) or dist.shape != (v, v):
        raise ValueError("weights and dist must both be [V, V]")
    if src.dim() != 1 or src.shape != dst.shape:
        raise ValueError("src and dst must be [F] vectors of one length")
    if hops < 0:
        raise ValueError(f"hops must be >= 0, got {hops}")
    if weights.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sample_slots runs on cpu or cuda, not {weights.device}")
    for name, x in (("dist", dist), ("src", src), ("dst", dst),
                    ("dst_nodes", dst_nodes)):
        if x is not None and x.device != weights.device:
            raise ValueError(f"{name} is on {x.device}, weights on {weights.device}")
    f = src.shape[0]
    out = torch.empty((f, hops), dtype=torch.int8, device=weights.device)
    if f == 0 or hops == 0 or v == 0:
        return out
    if tables is not None:
        _check_tables(tables, v, weights.device)
    if weights.device.type == "cpu":
        return sample_paths_dense(
            weights, dist, src, dst, hops, salt=salt, fid_base=fid_base,
            dst_nodes=dst_nodes,
        )[1]
    if tables is None:
        tables = sampler_tables(weights, dist, dst_nodes)
    launch_kernel(tables, src, dst, hops, salt, fid_base,
                  lane_group(f, _build.sm_count(weights.device)), out)
    sample_slots.launches += 1
    return out


def launch_kernel(
    tables: SamplerTables,
    src: torch.Tensor,  # [F] int32 (-1 pad), on the tables' card
    dst: torch.Tensor,  # [F] int32
    hops: int,
    salt: int,
    fid_base: int,
    lanes: int,  # lanes per flow: 4 or 8
    out: torch.Tensor,  # [F, hops] int8, written
) -> None:
    """Launch kernel K2 once over ``tables`` at ``lanes`` lanes per flow,
    without counting the launch (:func:`sample_slots` counts its own)."""
    fn = _build.function("sampler", "sampler_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ])
    src32 = src.to(torch.int32).contiguous()
    dst32 = dst.to(torch.int32).contiguous()
    v, d = tables.neigh.shape
    row_of = tables.row_of
    err = fn(
        tables.neigh.data_ptr(), tables.lw.data_ptr(), tables.dtab.data_ptr(),
        None if row_of is None else row_of.data_ptr(), src32.data_ptr(),
        dst32.data_ptr(), src.shape[0], v, d, hops, salt & _MASK,
        fid_base & _MASK, lanes, out.data_ptr(), _build.stream_ptr(out.device),
    )
    _build.check(err, "sampler")


#: kernel launches of :func:`sample_slots` (CPU calls do not count)
sample_slots.launches = 0

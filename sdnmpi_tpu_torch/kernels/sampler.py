"""Per-flow path sampling: kernel K2 and its plain version.

Counterpart of ``sdnmpi_tpu/kernels/sampler.py`` and of the dense XLA
sampler ``sdnmpi_tpu/oracle/dag.sample_paths_dense``. Every flow walks
the shortest-path DAG toward its destination; at each hop it takes,
among the current node's real out-links one hop closer to the
destination, ``argmax(bf16 log w + Gumbel)``. The Gumbel noise is a
32-bit hash of (flow id, neighbour, hop, salt) turned into a uniform by a
mantissa bitcast, so every implementation draws the same numbers. The
output slot is the chosen neighbour's rank among the node's sorted
out-neighbours; -1 marks the end of the path.

:func:`sample_paths_dense` is the plain version (the reference's dense
formulation as torch ops). :func:`sample_slots` is the wrapper: a CPU
tensor takes the plain version, a CUDA tensor launches ``csrc/sampler.cu``
or raises. Both take their bf16 log weights and bf16 distance table from
the same torch code (:func:`log_weights`, :func:`dist_rows`).

torch has no ``>>`` for uint32 on the CPU, so the plain version carries
the hash in int64 holding 32-bit values, with products split so that
nothing overflows; ``.view(torch.float32)`` is the bitcast.
"""

from __future__ import annotations

import ctypes

import torch

from sdnmpi_tpu_torch.kernels import _build
from sdnmpi_tpu_torch.kernels.bfs import neighbor_rows

#: distance stand-in for unreachable pairs: exact in bf16 and larger
#: than any real hop count
UNREACH = 16384.0
#: log-weight marker of "no link"; every real log weight is > -1e3
NO_LINK = -1e4
_MASK = 0xFFFFFFFF


def log_weights(weights: torch.Tensor) -> torch.Tensor:
    """``[V, V]`` bf16 log split weights, ``NO_LINK`` where w == 0."""
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


def dst_table(
    dist_bf: torch.Tensor, dst: torch.Tensor, dst_nodes: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Distance rows the flows read and each flow's row: ``(table
    [R, V] bf16, row [F] int32)``. Without ``dst_nodes`` the table is
    ``dist_bf`` and a flow reads row ``dst``. With it the table is the
    compact ``[T, V]`` block of the destination set (-1 entries are
    padding and read ``UNREACH``) and a flow reads the first position
    of its ``dst`` in the set; row -1 marks a dead flow (``dst`` < 0, or
    missing from the set)."""
    dst = dst.long()
    if dst_nodes is None:
        return dist_bf, torch.where(dst >= 0, dst, -1).to(torch.int32)
    v = dist_bf.shape[0]
    t = dst_nodes.shape[0]
    dn = dst_nodes.long()
    valid = dn >= 0
    table = torch.where(
        valid[:, None], dist_bf[dn.clamp(min=0)],
        torch.tensor(UNREACH, dtype=torch.bfloat16, device=dist_bf.device),
    ).contiguous()
    # first position of each node in the set (t = absent); pads land in
    # the spare entry v
    first = torch.full((v + 1,), t, dtype=torch.int64, device=dist_bf.device)
    first.scatter_reduce_(
        0, torch.where(valid, dn, v),
        torch.arange(t, dtype=torch.int64, device=dist_bf.device),
        reduce="amin",
    )
    row = first[dst.clamp(min=0)]
    row = torch.where((dst >= 0) & (row < t), row, -1)
    return table, row.to(torch.int32)


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
    table, row = dst_table(dist_rows(dist), dst, dst_nodes)
    d2t = table[row.long().clamp(min=0)].to(torch.float32)  # [F, V]

    src = src.long()
    dst = dst.long()
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


def sample_slots(
    weights: torch.Tensor,  # [V, V] f32 split weights (0 = no link)
    dist: torch.Tensor,  # [V, V] f32 hop distances
    src: torch.Tensor,  # [F] int32 (-1 pad)
    dst: torch.Tensor,  # [F] int32
    hops: int,
    salt: int = 0,
    dst_nodes: torch.Tensor | None = None,  # [T] int32 destination set (-1 pad)
    fid_base: int = 0,  # global index of flow 0 (a shard's offset)
) -> torch.Tensor:
    """Sampled slot streams ``[F, hops]`` int8, the slots output of
    :func:`sample_paths_dense` with the same arguments.

    ``dst_nodes`` selects the compact destination-set layout; it must
    hold every live flow's ``dst`` (flows whose ``dst`` it lacks read
    as unroutable). CPU tensors take the plain version; CUDA tensors
    launch kernel K2."""
    v = weights.shape[0]
    if weights.shape != (v, v) or dist.shape != (v, v):
        raise ValueError("weights and dist must both be [V, V]")
    if src.dim() != 1 or src.shape != dst.shape:
        raise ValueError("src and dst must be [F] vectors of one length")
    if hops < 0:
        raise ValueError(f"hops must be >= 0, got {hops}")
    if weights.device.type == "cpu":
        return sample_paths_dense(
            weights, dist, src, dst, hops, salt=salt, fid_base=fid_base,
            dst_nodes=dst_nodes,
        )[1]
    if weights.device.type != "cuda":
        raise ValueError(f"sample_slots runs on cpu or cuda, not {weights.device}")
    for name, x in (("dist", dist), ("src", src), ("dst", dst),
                    ("dst_nodes", dst_nodes)):
        if x is not None and x.device != weights.device:
            raise ValueError(f"{name} is on {x.device}, weights on {weights.device}")
    f = src.shape[0]
    out = torch.empty((f, hops), dtype=torch.int8, device=weights.device)
    if f == 0 or hops == 0 or v == 0:
        return out
    table, row = dst_table(dist_rows(dist), dst, dst_nodes)
    neigh = neighbor_rows(weights > 0).contiguous()
    lw = log_weights(weights).gather(1, neigh.clamp(max=v - 1).long()).contiguous()
    src32 = src.to(torch.int32).contiguous()
    dst32 = dst.to(torch.int32).contiguous()
    lib = _build.load("sampler")
    fn = lib.sampler_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    err = fn(
        neigh.data_ptr(), lw.data_ptr(), table.data_ptr(), src32.data_ptr(),
        dst32.data_ptr(), row.data_ptr(), f, v, v, hops, salt & _MASK,
        fid_base & _MASK, out.data_ptr(), _build.stream_ptr(weights.device),
    )
    _build.check(err, "sampler")
    sample_slots.launches += 1
    return out


#: kernel launches of :func:`sample_slots` (CPU calls do not count)
sample_slots.launches = 0

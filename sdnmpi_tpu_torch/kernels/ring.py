"""Bidirectional ring all-gather over the port's shard mesh: kernel K3.

Counterpart of ``sdnmpi_tpu/kernels/ring.py``. A sharded tensor is a
list of per-shard row blocks (``shardplane/mesh.py``); the ring
all-gather leaves every shard with the whole ``[R, C]`` matrix, moved by
the reference's schedule: a cw and a ccw leg over the flattened shard
order, double-buffered, in ceil((s-1)/2) steps.

- :func:`ring_all_gather` is the wrapper: CPU tensors take
  :func:`ring_all_gather_plain` (the schedule as torch ``copy_`` calls
  between per-shard buffers, ``_ring_gather_xla_fn``'s semantics); CUDA
  tensors launch ``csrc/ring.cu``, one launch playing every shard of a
  mesh placed on one card, or raise.
- :func:`ring_stream` runs one gather of the shards' wire blocks and then
  hands every block to a consumer in the reference's arrival order. The
  shardplane's consumers do not need that order while the exchange is
  not overlapped with them, so they gather and unpack whole matrices
  (:func:`exchange_distances`, one launch and one unpack per shard).
- Wire packing: hop counts ride as bf16 while V - 1 fits bf16's exact
  integers, else as int16 with -1 for inf (exact while V <= 2**15), else
  unpacked f32; next hops ride as int16.

``ring_supported`` and the Pallas/XLA split of the reference are TPU
dispatch and have no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from sdnmpi_tpu_torch.kernels import _build

#: largest hop count the bf16 wire round-trips bit-exactly (every
#: integer in [0, 256] and inf are representable in bf16)
WIRE_EXACT_MAX_HOPS = 256

#: largest V the int16 wire formats cover exactly
NEXT_WIRE_MAX_V = 1 << 15

#: most shards one launch of the kernel plays (its pointer table)
MAX_SHARDS = 64
#: threads per block of the kernel (csrc/ring.cu kThreads)
_THREADS = 256
#: units each thread copies per block slice, for sizing the grid
_UNITS_PER_THREAD = 8


def dist_wire_dtype(v: int) -> torch.dtype:
    """Wire dtype for hop-count distances on a V-switch fabric: bf16
    while V - 1 sits in bf16's exact-integer range, int16 (inf sentinel)
    up to the int16 bound, f32 past it."""
    if v - 1 <= WIRE_EXACT_MAX_HOPS:
        return torch.bfloat16
    if v <= NEXT_WIRE_MAX_V:
        return torch.int16
    return torch.float32


def pack_dist_wire(dist: torch.Tensor, v: int | None = None) -> torch.Tensor:
    """f32 hop counts -> wire blocks, bit-exact. ``v`` is the FULL
    matrix's switch capacity (defaults to ``dist.shape[-1]``)."""
    dt = dist_wire_dtype(dist.shape[-1] if v is None else v)
    if dt == torch.int16:
        return torch.where(torch.isinf(dist), -1.0, dist).to(torch.int16)
    return dist.to(dt)


def unpack_dist_wire(wire: torch.Tensor) -> torch.Tensor:
    """Wire blocks -> f32 hop counts (int16's -1 back to inf)."""
    if wire.dtype == torch.int16:
        w = wire.to(torch.float32)
        return torch.where(w < 0, float("inf"), w)
    return wire.to(torch.float32)


def pack_next_wire(nxt: torch.Tensor) -> torch.Tensor:
    """int32 next-hop rows -> int16 wire (exact while V < 2**15)."""
    return nxt.to(torch.int16)


def unpack_next_wire(wire: torch.Tensor) -> torch.Tensor:
    return wire.to(torch.int32)


def ring_legs(n_shards: int) -> tuple[int, int]:
    """(cw, ccw) hop counts: cw carries s//2 hops, ccw (s-1)//2."""
    return (n_shards // 2, (n_shards - 1) // 2)


def ring_perms(n_shards: int) -> tuple[list, list]:
    """(cw, ccw) permutation lists over the flattened shard order."""
    cw = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    ccw = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    return cw, ccw


def arrival_steps(shard: int, n_shards: int) -> list[int]:
    """The ring step at which each shard's block reaches ``shard`` (0 =
    its own block): the reference's ``arrival_steps`` for one shard."""
    n_cw, n_ccw = ring_legs(n_shards)
    out = []
    for q in range(n_shards):
        d_cw = (shard - q) % n_shards
        d_ccw = (q - shard) % n_shards
        out.append(min(d_cw if d_cw <= n_cw else n_shards,
                       d_ccw if d_ccw <= n_ccw else n_shards))
    return out


def exchange_bytes(v_rows: int, n_cols: int, n_shards: int,
                   itemsize: int = 2) -> int:
    """Wire bytes one full exchange moves into each shard: every remote
    block crosses it once."""
    if n_shards <= 1:
        return 0
    block = -(-v_rows // n_shards)
    return (n_shards - 1) * block * n_cols * itemsize


def _padded_blocks(blocks: list) -> tuple[list, int, int]:
    """Per-shard blocks padded to one row count ``b`` (the uneven final
    blocks of ``shard_rows``), contiguous; returns (blocks, b, R)."""
    r = sum(x.shape[0] for x in blocks)
    b = max(x.shape[0] for x in blocks)
    out = []
    for x in blocks:
        if x.shape[0] != b:
            pad = x.new_zeros((b, x.shape[1]))
            pad[: x.shape[0]] = x
            x = pad
        out.append(x.contiguous())
    return out, b, r


def ring_all_gather_plain(blocks: list) -> list:
    """The schedule as torch ``copy_`` calls: each shard's ``[2, 2, B, C]``
    comm buffer (direction x slot), the sends of a step, then its
    copy-outs. Takes equal ``[B, C]`` blocks, returns ``[s*B, C]`` each."""
    s = len(blocks)
    b, c = blocks[0].shape
    n_cw, n_ccw = ring_legs(s)
    out = [x.new_empty((s * b, c)) for x in blocks]
    comm = [x.new_empty((2, 2, b, c)) for x in blocks]
    for me in range(s):
        out[me][me * b:(me + 1) * b].copy_(blocks[me])
    for t in range(1, max(n_cw, n_ccw) + 1):
        for me in range(s):
            for d, legs, peer in ((0, n_cw, (me + 1) % s), (1, n_ccw, (me - 1) % s)):
                if t <= legs:
                    src = blocks[me] if t == 1 else comm[me][d, (t - 1) % 2]
                    comm[peer][d, t % 2].copy_(src)
        for me in range(s):
            for d, legs, origin in ((0, n_cw, (me - t) % s), (1, n_ccw, (me + t) % s)):
                if t <= legs:
                    out[me][origin * b:(origin + 1) * b].copy_(comm[me][d, t % 2])
    return out


#: per (device, stream, shards, slices): [flag words, calls so far]
_FLAGS: dict = {}


def _unit(nbytes: int, ptrs: list) -> int:
    """Widest copy unit (16, 8, 4 or 2 bytes) that divides the block and
    every pointer; 2- and 4-byte elements always allow 2."""
    for u in (16, 8, 4):
        if nbytes % u == 0 and all(p % u == 0 for p in ptrs):
            return u
    return 2


def _launch(blocks: list, b: int) -> list:
    """One launch of kernel K3 over equal contiguous ``[b, C]`` blocks of
    one card. The grid is sized from the occupancy the card reports, so
    every block is resident (the launch is cooperative)."""
    dev = blocks[0].device
    s = len(blocks)
    c = blocks[0].shape[1]
    es = blocks[0].element_size()
    nbytes = b * c * es
    out = [torch.empty((s * b, c), dtype=blocks[0].dtype, device=dev)
           for _ in range(s)]
    comm = torch.empty((s, 2, 2, nbytes), dtype=torch.uint8, device=dev)
    ptrs = [x.data_ptr() for x in blocks] + [o.data_ptr() for o in out]
    unit = _unit(nbytes, ptrs + [comm.data_ptr()])
    n_units = nbytes // unit
    n_cw, n_ccw = ring_legs(s)
    lib = _build.load("ring")
    with torch.cuda.device(dev):
        cap_fn = lib.ring_capacity
        cap_fn.argtypes = [ctypes.c_int]
        cap_fn.restype = ctypes.c_int
        cap = cap_fn(unit)
        if cap < 0:
            _build.check(-cap, "ring")
        if cap < s:
            raise RuntimeError(
                f"ring kernel: {s} shards need {s} co-resident blocks, the "
                f"card holds {cap}"
            )
        want = -(-n_units // (_THREADS * _UNITS_PER_THREAD))
        nblk = max(1, min(want, cap // s))
        stream = _build.stream_ptr(dev)
        key = (dev, stream.value, s, nblk)
        entry = _FLAGS.get(key)
        if entry is None:
            entry = _FLAGS[key] = [
                torch.zeros(s * 2 * 2 * nblk, dtype=torch.int32, device=dev), 0
            ]
        flags, epoch = entry
        fn = lib.ring_launch
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        in_arr = (ctypes.c_void_p * s)(*ptrs[:s])
        out_arr = (ctypes.c_void_p * s)(*ptrs[s:])
        err = fn(
            in_arr, out_arr, s, comm.data_ptr(), flags.data_ptr(), nblk,
            n_units, unit, epoch & 0xFFFFFFFF, n_cw, n_ccw, stream,
        )
        _build.check(err, "ring")
        entry[1] = epoch + 1
    ring_all_gather.launches += 1
    return out


def ring_all_gather(blocks: list, mesh) -> list:
    """All-gather the row-sharded blocks of ``mesh`` over its
    bidirectional ring: returns one ``[R, C]`` tensor per shard.

    ``blocks[q]`` is shard q's row block, rows ``[q*b, (q+1)*b)`` of the
    ``[R, C]`` matrix with ``b = ceil(R / s)`` (the final blocks may be
    short, as ``convert.shard_rows`` cuts them): short blocks are padded
    onto the wire and the result trimmed, as ``ring.py:386-400`` does.
    Strided blocks are made contiguous first. s = 1 returns the block and
    launches nothing. CPU tensors take the plain version; CUDA tensors
    launch kernel K3 (every shard on one card) or raise."""
    s = mesh.n_shards
    if len(blocks) != s:
        raise ValueError(f"{len(blocks)} blocks for a {s}-shard mesh")
    if s == 1:
        return [blocks[0]]
    first = blocks[0]
    for x in blocks:
        if x.dim() != 2 or x.shape[1] != first.shape[1]:
            raise ValueError("blocks must be [rows, C] with one C")
        if x.dtype != first.dtype or x.device != first.device:
            raise ValueError("blocks must share one dtype and one device")
    padded, b, r = _padded_blocks(blocks)
    if first.device.type == "cpu":
        out = ring_all_gather_plain(padded)
    elif first.device.type == "cuda":
        if s > MAX_SHARDS:
            raise ValueError(f"ring kernel takes at most {MAX_SHARDS} shards")
        if first.element_size() not in (2, 4):
            raise ValueError(f"ring kernel moves 2- or 4-byte words, not {first.dtype}")
        out = _launch(padded, b)
    else:
        raise ValueError(f"ring_all_gather runs on cpu or cuda, not {first.device}")
    return out if r == s * b else [o[:r] for o in out]


#: kernel launches of :func:`ring_all_gather` (CPU calls do not count)
ring_all_gather.launches = 0


def ring_stream(mesh, blocks: list, consume, carry: list) -> list:
    """Gather the shards' equal ``[B, C]`` wire blocks with one ring
    all-gather, then hand every block to ``consume(carry, blk, src, step)``
    in the reference's arrival order (``ring.py:185-195``): for each shard
    its own block at step 0, then per step t the cw block of shard
    ``(me - t) % s`` before the ccw block of ``(me + t) % s``. ``carry``
    holds one carry per shard; returns the final carries."""
    s = mesh.n_shards
    n_cw, n_ccw = ring_legs(s)
    b = blocks[0].shape[0]
    full = ring_all_gather(blocks, mesh)
    out = []
    for me in range(s):
        c = consume(carry[me], blocks[me], me, 0)
        for t in range(1, max(n_cw, n_ccw) + 1):
            for legs, src in ((n_cw, (me - t) % s), (n_ccw, (me + t) % s)):
                if t <= legs:
                    c = consume(c, full[me][src * b:(src + 1) * b], src, t)
        out.append(c)
    return out


def exchange_distances(dist: list, mesh) -> list:
    """Row-sharded f32 hop counts -> the replicated f32 matrix on every
    shard, packed for the wire (bit-exact, see :func:`dist_wire_dtype`)."""
    v = dist[0].shape[1]
    wire = ring_all_gather([pack_dist_wire(d, v) for d in dist], mesh)
    return [unpack_dist_wire(w) for w in wire]


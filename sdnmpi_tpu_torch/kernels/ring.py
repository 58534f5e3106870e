"""All-gather over the port's shard mesh: kernel K3, its step form, and
their plain versions.

Counterpart of ``sdnmpi_tpu/kernels/ring.py``. A sharded tensor is a
list of per-shard row blocks (``shardplane/mesh.py``); the all-gather
leaves every shard with the whole ``[R, C]`` matrix.

- :func:`ring_all_gather` is the wrapper: CPU tensors take
  :func:`ring_all_gather_plain` (the reference's schedule, a cw and a ccw
  leg over the flattened shard order, double-buffered, in ceil((s-1)/2)
  steps, as torch ``copy_`` calls between per-shard buffers:
  ``_ring_gather_xla_fn``'s semantics); CUDA tensors launch
  ``csrc/ring.cu``, one broadcast copy that stores every shard's block
  straight into every shard's output (a mesh placed on one card), or
  raise. Both compute the same function; the ring is what a TPU's
  neighbour-only links need, and a card reaches every output directly.
- :func:`ring_step` is K3's step form: it lands the arrivals of one ring
  step in every shard's own view (CPU: :func:`ring_step_plain`; CUDA:
  ``ring_step_run`` in ``csrc/ring.cu``, on the bulk path of TMA copies
  through shared memory or the vector path, by alignment). A
  :class:`StepPlan` does the host work of every step of one exchange
  once, so that a step launches with one C call. :class:`RingExchange`
  runs the steps of one exchange from one plan on the device's exchange
  stream, one event per step, so that a consumer on the current stream
  waits only for the step it reads while the next one is in flight: the
  reference's ``ring_stream``, whose next ``ppermute`` overlaps the
  consumer of the last. :func:`ring_stream` keeps the reference's
  contract on top of it; the shardplane's three ring consumers (the
  gated chase, the column-pipelined next-hop argmin, the DAG step's
  distance exchange) drive an exchange directly.
- Across processes (a mesh of ``shardplane/mesh.py`` over several
  processes, each holding one arc of the ring): the sharded lists hold
  this process's blocks, ``None`` elsewhere. On CUDA each process
  launches K3 or a step for its own sources and stores into every
  shard's output or view, through pointers that the other processes
  exported (receive buffers from ``ring_ipc_alloc``, handed to torch
  without a copy); an interprocess event after each launch, one host
  barrier per exchange, and each consumer waits on the events of the
  processes whose blocks it reads (:class:`_Link`). On the CPU the plain
  versions run the same schedule on blocks gathered over the ``gloo``
  group. Every process must make the same calls in the same order.
- Wire packing: hop counts ride as bf16 while V - 1 fits bf16's exact
  integers, else as int16 with -1 for inf (exact while V <= 2**15), else
  unpacked f32; next hops ride as int16.

``ring_supported`` and the Pallas/XLA split of the reference are TPU
dispatch and have no counterpart here.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from sdnmpi_tpu_torch.kernels import _build

#: largest hop count the bf16 wire round-trips bit-exactly (every
#: integer in [0, 256] and inf are representable in bf16)
WIRE_EXACT_MAX_HOPS = 256

#: largest V the int16 wire formats cover exactly
NEXT_WIRE_MAX_V = 1 << 15

#: most shards one launch of the kernel serves (its pointer table)
MAX_SHARDS = 64

#: CTAs of one step launch: few enough to leave SMs to the consumer
#: that runs beside the exchange (the sweep in chip_smoke.py picks it)
STEP_CTAS = 128

#: the bulk path's alignment: bulk copies take 16-byte aligned addresses
#: and sizes
BULK_ALIGN = 16

#: bytes of one shared-memory stage of the bulk path (``kChunk`` in
#: ``csrc/ring.cu``): a bulk step uses at most one CTA a chunk
BULK_CHUNK = 49152

#: the step calls of recent plans (:class:`StepPlan`), by the addresses,
#: block size, stream and CTA count they were built for; cleared when it
#: holds ``PLAN_CALLS_KEPT``
_PLAN_CALLS: dict = {}
PLAN_CALLS_KEPT = 64

#: Test and measurement hooks of :class:`RingExchange`, off when
#: False/None. ``POISON`` fills each new view with a sentinel (NaN on a
#: float wire, the integer maximum on an int wire) until its rows land,
#: so that a read before its wait shows. ``BEFORE_STEP(t)`` runs on the
#: exchange stream before step t is launched (a delayed exchange).
#: ``TRACE``, a list, collects timing events ``(kind, exchange, t,
#: event)`` in the order they are enqueued: on the exchange stream
#: ``"start"`` and ``"end"`` around step t's copies; on the consumer's
#: stream ``"fork"`` (t = -1) where the exchange forks, ``"wait"`` just
#: before it waits for step t, ``"ready"`` just after, and ``"join"``
#: (t = the last step) just before it joins the exchange.
POISON = False
BEFORE_STEP = None
TRACE = None


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


def step_offsets(t: int, n_shards: int) -> list[int]:
    """The ring's schedule: the blocks that reach shard ``me`` at step
    ``t`` are those of shards ``(me + d) % n_shards`` for ``d`` in the
    list, cw before ccw (the reference's arrival order, ``ring.py:185-195``);
    step 0 is each shard's own block."""
    if t == 0:
        return [0]
    n_cw, n_ccw = ring_legs(n_shards)
    return [d for legs, d in ((n_cw, -t), (n_ccw, t)) if t <= legs]


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


def _unit(nbytes: int, ptrs: list) -> int:
    """Widest copy unit (16, 8, 4 or 2 bytes) that divides the block and
    every pointer; 2- and 4-byte elements always allow 2."""
    for u in (16, 8, 4):
        if nbytes % u == 0 and all(p % u == 0 for p in ptrs):
            return u
    return 2


def _launch(blocks: list, b: int) -> list:
    """One launch of kernel K3 over equal contiguous ``[b, C]`` blocks of
    one card."""
    dev = blocks[0].device
    s = len(blocks)
    c = blocks[0].shape[1]
    nbytes = b * c * blocks[0].element_size()
    # one allocation for every shard's copy (one host call, not s)
    out = list(torch.empty((s, s * b, c), dtype=blocks[0].dtype, device=dev))
    if nbytes == 0:
        return out
    _k3(blocks, 0, [o.data_ptr() for o in out], nbytes, _build.stream_ptr(dev))
    return out


def _k3(blocks: list, q0: int, outs: list, nbytes: int, stream) -> None:
    """Launch K3 for the sources ``blocks`` (shards ``q0..``) into the
    output addresses ``outs`` of every shard."""
    s = len(outs)
    ptrs = [x.data_ptr() for x in blocks] + outs
    unit = _unit(nbytes, ptrs)
    fn = _build.function("ring", "ring_launch", [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p,
    ])
    in_arr = (ctypes.c_void_p * len(blocks))(*ptrs[:len(blocks)])
    out_arr = (ctypes.c_void_p * s)(*outs)
    err = fn(in_arr, len(blocks), q0, out_arr, s, nbytes // unit, unit, stream)
    _build.check(err, "ring")
    ring_all_gather.launches += 1


def ring_all_gather(blocks: list, mesh) -> list:
    """All-gather the row-sharded blocks of ``mesh``: returns one
    ``[R, C]`` tensor per shard.

    ``blocks[q]`` is shard q's row block, rows ``[q*b, (q+1)*b)`` of the
    ``[R, C]`` matrix with ``b = ceil(R / s)`` (the final blocks may be
    short, as ``convert.shard_rows`` cuts them): short blocks are padded
    onto the wire and the result trimmed, as ``ring.py:386-400`` does.
    Strided blocks are made contiguous first. s = 1 returns the block and
    launches nothing. CPU tensors take the plain version (the ring
    schedule); CUDA tensors launch kernel K3 or raise. On a mesh over
    several processes, ``blocks`` holds this process's blocks (of one row
    count in every process; other entries are ignored) and the result
    this process's outputs, ``None`` elsewhere."""
    s = mesh.n_shards
    if len(blocks) != s:
        raise ValueError(f"{len(blocks)} blocks for a {s}-shard mesh")
    if s == 1:
        return [blocks[0]]
    if mesh.multiprocess:
        return _gather_across(blocks, mesh)
    _check_blocks(blocks)
    first = blocks[0]
    padded, b, r = _padded_blocks(blocks)
    if first.device.type == "cpu":
        out = ring_all_gather_plain(padded)
    else:
        out = _launch(padded, b)
    return out if r == s * b else [o[:r] for o in out]


def _check_blocks(blocks: list) -> None:
    """Raise on blocks that neither K3 nor its plain version takes."""
    first = blocks[0]
    for x in blocks:
        if x.dim() != 2 or x.shape[1] != first.shape[1]:
            raise ValueError("blocks must be [rows, C] with one C")
        if x.dtype != first.dtype or x.device != first.device:
            raise ValueError("blocks must share one dtype and one device")
    if first.device.type == "cuda":
        if len(blocks) > MAX_SHARDS:
            raise ValueError(f"ring kernel takes at most {MAX_SHARDS} shards")
        if first.element_size() not in (2, 4):
            raise ValueError(f"ring kernel moves 2- or 4-byte words, not {first.dtype}")
    elif first.device.type != "cpu":
        raise ValueError(f"ring_all_gather runs on cpu or cuda, not {first.device}")


def _gather_across(blocks: list, mesh) -> list:
    """:func:`ring_all_gather` on a mesh over several processes: this
    process's blocks in, its shards' ``[R, C]`` outputs out (``None`` at
    the other processes' shards). On CUDA one K3 launch for this
    process's sources stores into every shard's output (:class:`_Link`);
    on the CPU every block comes over the group and the plain version
    runs."""
    s = mesh.n_shards
    mine = [blocks[q].contiguous() for q in mesh.local]
    _check_blocks(mine)
    if mine[0].device.type == "cpu":
        out = ring_all_gather_plain(_blocks_over_group(mine, mesh))
        return [out[q] if q in mesh.local else None for q in range(s)]
    b, c = mine[0].shape
    dev = mine[0].device
    stream = torch.cuda.current_stream(dev)
    out, handle = _recv_buffer((len(mine), s * b, c), mine[0].dtype, dev)
    link = _Link(mesh, mine, out, handle, 1, stream)
    nbytes = b * c * mine[0].element_size()
    if nbytes:
        _k3(mine, mesh.local[0], link.targets, nbytes, ctypes.c_void_p(stream.cuda_stream))
    link.arrive(0, stream)
    link.barrier()
    link.wait(0, stream)
    return [out[mesh.local.index(q)] if q in mesh.local else None for q in range(s)]


#: kernel launches of :func:`ring_all_gather` (CPU calls do not count)
ring_all_gather.launches = 0


def ring_step_plain(blocks: list, views: torch.Tensor, t: int,
                    local: tuple | None = None) -> None:
    """Step ``t`` of the exchange as torch ``copy_`` calls: the arrivals
    of :func:`ring_all_gather_plain`'s step t at every shard (its own
    block at step 0), each stored at rows ``origin*B..`` of that shard's
    ``[s*B, C]`` view ``views[me]``. With ``local`` (the ring indices of
    the shards ``views`` holds) only those shards' views."""
    s = len(blocks)
    b = blocks[0].shape[0]
    for k, me in enumerate(range(s) if local is None else local):
        for d in step_offsets(t, s):
            origin = (me + d) % s
            views[k][origin * b:(origin + 1) * b].copy_(blocks[origin])


class StepArgs(NamedTuple):
    """The step kernel's launch arguments for one step (:func:`step_args`)."""

    #: 3 addresses a source q: its block, then its destinations in
    #: ``step_offsets`` order, 0 where it has one
    table: tuple
    bulk: bool
    #: the vector path's word in bytes (8, 4 or 2)
    unit: int
    #: the bulk path's split of every copy: ``head`` bytes up to the
    #: first 16-byte boundary and ``tail`` bytes after the last, as 2-byte
    #: words, ``mid`` bytes through the shared-memory stages
    head: int
    mid: int
    tail: int
    #: bulk: CTAs; vector: CTAs a source
    grid: int


def step_args(src: list, views: list, nbytes: int, t: int, ctas: int) -> StepArgs:
    """Step ``t``'s launch arguments from integers alone: ``src[q]`` is the
    address of shard q's block (0 for a source another process launches
    for: it has no entry in the table), ``views[me]`` that of shard me's
    view, ``nbytes`` a block's size. Source q goes to every shard ``me`` with
    ``(me + d) % s == q`` for ``d`` in ``step_offsets(t, s)``, at
    ``views[me] + q * nbytes``. The bulk path takes the step when every
    address of the table shares one residue mod ``BULK_ALIGN`` and an
    aligned 16-byte word lies inside a block; else the vector path copies
    whole blocks in the widest word that ``nbytes`` and every address
    allow (8, 4 or 2 bytes: addresses that allow 16 go bulk)."""
    s = len(src)
    offsets = step_offsets(t, s)
    pad = [0] * (2 - len(offsets))
    table = []
    for q in range(s):
        if src[q]:
            table += [src[q], *[views[(q - d) % s] + q * nbytes for d in offsets], *pad]
    n_src = len(table) // 3
    live = [p for p in table if p]
    phase = live[0] % BULK_ALIGN
    head = min(nbytes, -phase % BULK_ALIGN)
    mid = (nbytes - head) // BULK_ALIGN * BULK_ALIGN
    if mid > 0 and {p % BULK_ALIGN for p in live} == {phase}:
        grid = min(ctas, n_src * -(-mid // BULK_CHUNK))
        return StepArgs(tuple(table), True, 0, head, mid, nbytes - head - mid, grid)
    return StepArgs(tuple(table), False, _unit(nbytes, live), 0, 0, 0,
                    min(max(ctas // n_src, 1), 65535))


def _check_step(blocks: list, views: torch.Tensor, s: int) -> None:
    """Raise on blocks and views that the step form does not take:
    ``views`` holds ``[s*B, C]`` views of an ``s``-shard ring, one for
    each block unless another process holds some of the shards."""
    first = blocks[0]
    b, c = first.shape
    for x in blocks:
        if x.shape != first.shape or x.dtype != first.dtype or x.device != first.device:
            raise ValueError("blocks must be equal [B, C] blocks of one dtype and device")
        if not x.is_contiguous():
            raise ValueError("blocks must be contiguous")
    n = views.shape[0] if views.dim() == 3 else -1
    if views.shape != (n, s * b, c) or n < 1 or views.dtype != first.dtype:
        raise ValueError(f"views must be [n, {s * b}, {c}] {first.dtype}, not "
                         f"{tuple(views.shape)} {views.dtype}")
    if views.device != first.device or not views.is_contiguous():
        raise ValueError("views must be contiguous, on the blocks' device")
    if first.device.type == "cuda":
        if s > MAX_SHARDS:
            raise ValueError(f"ring kernel takes at most {MAX_SHARDS} shards")
        if first.element_size() not in (2, 4):
            raise ValueError(f"ring kernel moves 2- or 4-byte words, not {first.dtype}")
    elif first.device.type != "cpu":
        raise ValueError(f"ring_step runs on cpu or cuda, not {first.device}")


class StepPlan:
    """K3's step form planned once for ``blocks`` and ``views`` as
    :func:`ring_step` takes them: the checks and, on CUDA, every step's
    launch arguments (:func:`step_args`) as a prebuilt C call, with the C
    function and the stream that is current when the plan is built.
    :meth:`launch` is then one C call a step. The calls are kept by every
    address, size, stream and CTA count they were built from
    (``_PLAN_CALLS``), so a plan for memory that the allocator hands out
    again reuses them.

    On a mesh over several processes ``blocks`` are this process's
    sources, shards ``sources`` of the ring, and ``targets`` the address
    of every shard's view, this process's in ``views`` and the others'
    mapped from theirs (:class:`_Link`)."""

    def __init__(self, blocks: list, views: torch.Tensor, ctas: int | None = None,
                 sources: tuple | None = None, targets: list | None = None):
        self.s = s = len(blocks) if targets is None else len(targets)
        _check_step(blocks, views, s)
        if targets is None and views.shape[0] != s:
            raise ValueError(f"{views.shape[0]} views for {s} blocks")
        self.blocks, self.views = blocks, views
        self.last = max(ring_legs(s))
        #: "bulk" or "vector" for each step (CUDA only)
        self.paths: tuple = ()
        #: the handle of the stream the steps launch on (CUDA only)
        self.stream = None
        self._calls: tuple = ()
        dev = blocks[0].device
        nbytes = blocks[0].numel() * blocks[0].element_size()
        if dev.type != "cuda" or nbytes == 0:
            return
        src = [0] * s
        for q, x in zip(range(s) if sources is None else sources, blocks):
            src[q] = x.data_ptr()
        pitch = views.stride(0) * views.element_size()
        if targets is None:
            targets = [views.data_ptr() + me * pitch for me in range(s)]
        stream = _build.stream_ptr(dev)
        self.stream = stream.value or 0  # the default stream's handle is 0
        ctas = STEP_CTAS if ctas is None else ctas
        key = (*src, *targets, nbytes, self.stream, ctas)
        planned = _PLAN_CALLS.get(key)
        if planned is None:
            calls, paths = [], []
            for t in range(self.last + 1):
                a = step_args(src, targets, nbytes, t, ctas)
                table = (ctypes.c_void_p * len(a.table))(*a.table)
                calls.append((table, len(a.table) // 3, int(a.bulk), nbytes, a.unit,
                              a.head, a.mid, a.tail, a.grid, stream))
                paths.append("bulk" if a.bulk else "vector")
            if len(_PLAN_CALLS) >= PLAN_CALLS_KEPT:
                _PLAN_CALLS.clear()
            planned = _PLAN_CALLS[key] = (tuple(calls), tuple(paths))
            StepPlan.builds += 1
        self._calls, self.paths = planned
        self._fn = _build.function("ring", "ring_step_run", [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ])

    #: CUDA plans that built their calls rather than reuse them
    builds = 0

    def launch(self, t: int) -> None:
        """Land step ``t``: on CUDA one launch on the plan's stream, on the
        CPU :func:`ring_step_plain`."""
        if not 0 <= t <= self.last:
            raise ValueError(f"step {t} outside 0..{self.last} for {self.s} shards")
        if self.blocks[0].device.type == "cpu":
            ring_step_plain(self.blocks, self.views, t)
        elif self._calls:
            _build.check(self._fn(*self._calls[t]), "ring step")
            ring_step.launches += 1


def ring_step(blocks: list, views: torch.Tensor, t: int,
              ctas: int | None = None) -> None:
    """Land step ``t`` of the ring exchange of ``blocks`` (s equal
    contiguous ``[B, C]`` blocks, shard q's at index q) in ``views``
    (``[s, s*B, C]``, shard me's view at ``views[me]``): for every shard,
    the blocks that reach it at step t (``arrival_steps``), at rows
    ``origin*B..``. Steps 0 to ``max(ring_legs(s))`` in order leave every
    view equal to :func:`ring_all_gather_plain`'s output. CPU tensors
    take :func:`ring_step_plain`; CUDA tensors launch the step kernel on
    the current stream with ``ctas`` CTAs (``STEP_CTAS``), or raise: a
    :class:`StepPlan` built for one step."""
    StepPlan(blocks, views, ctas).launch(t)


#: kernel launches of :func:`ring_step` (CPU calls do not count)
ring_step.launches = 0

_streams: dict = {}


def exchange_stream(device) -> "torch.cuda.Stream":
    """The exchange stream of a CUDA ``device`` (one per device, of the
    default priority, made at first use)."""
    dev = torch.device(device)
    st = _streams.get(dev)
    if st is None:
        st = _streams[dev] = torch.cuda.Stream(dev)
    return st


def _sentinel(dtype: torch.dtype):
    return float("nan") if dtype.is_floating_point else torch.iinfo(dtype).max


class RingExchange:
    """One ring exchange of the shards' wire ``blocks`` (row blocks of one
    ``[R, C]`` matrix, shard q's at index q; short final blocks are
    padded), landing step by step in every shard's own view.

    On CUDA the constructor forks the device's exchange stream (it first
    waits for the current stream, where the wire was packed), plans the
    steps there once (:class:`StepPlan`), launches steps 0 to ``last``
    from the plan and records an event after each; :meth:`wait` makes the
    current stream wait for one step's event, and :meth:`join` for the
    whole exchange. The blocks and the views are marked as used by the
    exchange stream, so the caching allocator hands their memory out
    again only after it. On the CPU the steps run in order, in place,
    inside :meth:`wait` (:func:`ring_step`): a step lands only when a
    consumer asks for it.

    With a ``mesh`` over several processes, ``blocks`` holds this
    process's blocks (of one row count in every process), ``views`` the
    views of this process's shards (:attr:`local`, in ring order), and
    the steps store into the other processes' views too (:class:`_Link`):
    an interprocess event after each step, one host barrier after the
    last, and :meth:`wait` waits for the events of the processes whose
    blocks have reached this process's shards by then. On the CPU every
    block comes over the group in the constructor."""

    def __init__(self, blocks: list, mesh=None):
        self.across = mesh is not None and mesh.multiprocess
        self.link = None
        if self.across:
            #: the ring indices of the shards whose views this process holds
            self.local = mesh.local
            mine = [blocks[q].contiguous() for q in self.local]
            self.s, (self.b, c) = mesh.n_shards, mine[0].shape
            self.r = self.s * self.b
        else:
            mine, self.b, self.r = _padded_blocks(blocks)
            self.s, c = len(mine), mine[0].shape[1]
            self.local = tuple(range(self.s))
        self.blocks = mine
        self._slot = {q: k for k, q in enumerate(self.local)}
        s, b = self.s, self.b
        self.last = max(ring_legs(s))
        first = mine[0]
        shape = (len(self.local), s * b, c)
        self.landed = -1  # the CPU's last landed step
        self.stream = None
        if first.device.type != "cuda" or not self.across:
            if POISON:
                self.views = torch.full(shape, _sentinel(first.dtype), dtype=first.dtype,
                                        device=first.device)
            else:
                self.views = torch.empty(shape, dtype=first.dtype, device=first.device)
        if first.device.type != "cuda":
            if self.across:
                self.blocks = _blocks_over_group(mine, mesh)
            return
        dev = first.device
        self.main = torch.cuda.current_stream(dev)
        self.stream = exchange_stream(dev)
        self.stream.wait_stream(self.main)
        self._trace("fork", -1, self.main)
        for x in mine:
            x.record_stream(self.stream)
        sources = targets = None
        if self.across:
            self.views, handle = _recv_buffer(shape, first.dtype, dev)
            if POISON:
                with torch.cuda.stream(self.stream):
                    self.views.fill_(_sentinel(first.dtype))
            self.link = _Link(mesh, mine, self.views, handle, self.last + 1, self.stream)
            self.link.reach = _reach(mesh, self.last)
            sources, targets = self.local, self.link.targets
        else:
            self.views.record_stream(self.stream)
        self.events = []
        with torch.cuda.stream(self.stream):
            plan = StepPlan(mine, self.views, sources=sources, targets=targets)
            for t in range(self.last + 1):
                if BEFORE_STEP is not None:
                    BEFORE_STEP(t)
                self._trace("start", t, self.stream)
                plan.launch(t)
                self._trace("end", t, self.stream)
                if self.link is not None:
                    self.link.arrive(t, self.stream)
                    continue
                ev = torch.cuda.Event()
                ev.record(self.stream)
                self.events.append(ev)
        if self.link is not None:
            self.link.barrier()

    def _trace(self, kind: str, t: int, stream) -> None:
        if TRACE is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            TRACE.append((kind, self, t, ev))

    def wait(self, t: int) -> None:
        """Make the current stream wait until step ``t`` has landed (on
        the CPU: land the steps up to ``t``)."""
        if self.stream is None:
            while self.landed < t:
                self.landed += 1
                if self.across:
                    ring_step_plain(self.blocks, self.views, self.landed, self.local)
                else:
                    ring_step(self.blocks, self.views, self.landed)
            return
        self._trace("wait", t, self.main)
        if self.link is None:
            self.main.wait_event(self.events[t])
        else:
            self.link.wait(t, self.main)
        self._trace("ready", t, self.main)

    def join(self) -> None:
        """The current stream waits for the whole exchange."""
        if self.stream is None:
            self.wait(self.last)
            return
        self._trace("join", self.last, self.main)
        if self.link is None:
            self.main.wait_stream(self.stream)
        else:
            self.link.wait(self.last, self.main)

    def origins(self, me: int, t: int) -> list:
        """The shards whose blocks reach shard ``me`` at step ``t``, cw
        before ccw (the reference's arrival order)."""
        return [(me + d) % self.s for d in step_offsets(t, self.s)]

    def view(self, me: int) -> torch.Tensor:
        """Shard ``me``'s ``[R, C]`` view (rows land as their steps do)."""
        return self.views[self._slot[me]][: self.r]

    def block(self, me: int, origin: int) -> torch.Tensor:
        """Shard ``origin``'s ``[B, C]`` block in shard ``me``'s view."""
        return self.views[self._slot[me]][origin * self.b:(origin + 1) * self.b]


def ring_stream(mesh, blocks: list, consume, carry: list) -> list:
    """Stream the shards' equal ``[B, C]`` wire blocks around the ring
    (:class:`RingExchange`) and hand every block to ``consume(carry, blk,
    src, step)`` as its step lands, in the reference's arrival order
    (``ring.py:185-195``): for each shard its own block at step 0, then
    per step t the cw block of shard ``(me - t) % s`` before the ccw block
    of ``(me + t) % s``. The consumers of step t are enqueued after the
    current stream waits for step t only, while the later steps are in
    flight. ``carry`` holds one carry per shard; returns the final
    carries, with the current stream joined to the exchange (on a mesh
    over several processes, this process's shards' carries, the others
    as given)."""
    s = mesh.n_shards
    if len(blocks) != s:
        raise ValueError(f"{len(blocks)} blocks for a {s}-shard mesh")
    ex = RingExchange(blocks, mesh)
    out = list(carry)
    for t in range(ex.last + 1):
        ex.wait(t)
        for me in ex.local:
            for src in ex.origins(me, t):
                out[me] = consume(out[me], ex.block(me, src), src, t)
    ex.join()
    return out


def start_distance_exchange(dist: list, mesh=None) -> RingExchange:
    """Pack row-sharded f32 hop counts to the wire (on the current
    stream) and start their exchange (see :func:`dist_wire_dtype`); on a
    mesh over several processes, this process's blocks."""
    v = next(d for d in dist if d is not None).shape[1]
    return RingExchange([None if d is None else pack_dist_wire(d, v) for d in dist],
                        mesh)


def finish_distance_exchange(ex: RingExchange) -> list:
    """Wait for a distance exchange and unpack every shard's replicated
    f32 matrix (``None`` at another process's shards)."""
    ex.join()
    return [unpack_dist_wire(ex.view(q)) if q in ex._slot else None
            for q in range(ex.s)]


def exchange_distances(dist: list, mesh) -> list:
    """Row-sharded f32 hop counts -> the replicated f32 matrix on every
    shard, packed for the wire (bit-exact, see :func:`dist_wire_dtype`):
    the blocking exchange, started and awaited at once."""
    if len(dist) != mesh.n_shards:
        raise ValueError(f"{len(dist)} blocks for a {mesh.n_shards}-shard mesh")
    return finish_distance_exchange(start_distance_exchange(dist, mesh))


# -- across processes -------------------------------------------------------

#: bytes of a CUDA IPC handle (``cudaIpcMemHandle_t``, ``cudaIpcEventHandle_t``)
IPC_HANDLE = 64

#: receive buffers free for reuse, by (device, bytes)
_BUFFERS: dict = {}
#: every receive buffer this process allocated
_ALLOCATED: list = []
#: interprocess events free for reuse, by device: (event, handle)
_EVENTS: dict = {}
#: event sets of finished exchanges, free from the next handshake on
_DONE: dict = {}
#: other processes' buffers and events this process opened, by handle
_OPENED_BUFFERS: dict = {}
_OPENED_EVENTS: dict = {}


def _ipc(symbol: str, argtypes: list):
    return _build.function("ring", symbol, argtypes)


class _IpcBuffer:
    """A receive buffer: device memory of the ring library
    (``ring_ipc_alloc``) that other processes can map by its handle."""

    def __init__(self, dev: torch.device, nbytes: int):
        ptr = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(IPC_HANDLE)
        fn = _ipc("ring_ipc_alloc", [ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.c_char_p])
        with torch.cuda.device(dev):
            _build.check(fn(nbytes, ctypes.byref(ptr), handle), "ring_ipc_alloc")
        self.dev, self.nbytes, self.ptr, self.handle = dev, nbytes, ptr.value, handle.raw
        _ALLOCATED.append(self)


class _Lease:
    """Hands a receive buffer to torch without a copy
    (``__cuda_array_interface__``); torch holds the lease while any
    tensor uses the memory, and the buffer goes back to the free list
    when it lets go."""

    def __init__(self, buf: _IpcBuffer):
        self.buf = buf
        self.__cuda_array_interface__ = {
            "shape": (buf.nbytes,), "typestr": "|u1", "data": (buf.ptr, False),
            "version": 2,
        }

    def __del__(self):
        _BUFFERS.setdefault((self.buf.dev, self.buf.nbytes), []).append(self.buf)


def _recv_buffer(shape: tuple, dtype: torch.dtype, dev: torch.device) -> tuple:
    """A ``shape`` tensor of ``dtype`` in a receive buffer, and the
    buffer's handle. A buffer is handed out again once torch lets go of
    its last tensor; the peers' stores into it then wait for the ready
    event its owner records at the next exchange (:class:`_Link`)."""
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    key = (dev, max(nbytes, BULK_ALIGN))
    free = _BUFFERS.get(key)
    buf = free.pop() if free else _IpcBuffer(*key)
    raw = torch.as_tensor(_Lease(buf), device=dev)
    return raw[:nbytes].view(dtype).reshape(shape), buf.handle


def _new_event(dev: torch.device) -> tuple:
    ev = ctypes.c_void_p()
    handle = ctypes.create_string_buffer(IPC_HANDLE)
    fn = _ipc("ring_ipc_event", [ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p])
    with torch.cuda.device(dev):
        _build.check(fn(ctypes.byref(ev), handle), "ring_ipc_event")
    return ev.value, handle.raw


def _opened(cache: dict, symbol: str, handle: bytes) -> int:
    """Another process's buffer or event, opened once per handle."""
    got = cache.get(handle)
    if got is None:
        out = ctypes.c_void_p()
        fn = _ipc(symbol, [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)])
        _build.check(fn(handle, ctypes.byref(out)), symbol)
        got = cache[handle] = out.value
    return got


def _record(event: int, stream) -> None:
    fn = _ipc("ring_event_record", [ctypes.c_void_p, ctypes.c_void_p])
    _build.check(fn(event, stream.cuda_stream), "ring_event_record")


def _stream_wait(stream, event: int) -> None:
    fn = _ipc("ring_stream_wait", [ctypes.c_void_p, ctypes.c_void_p])
    _build.check(fn(stream.cuda_stream, event), "ring_stream_wait")


def _meta(blocks: list) -> torch.Tensor:
    """What every process's blocks must agree on: rows (least and most),
    width and word size."""
    rows = [x.shape[0] for x in blocks]
    return torch.tensor([min(rows), max(rows), blocks[0].shape[1],
                         blocks[0].element_size()], dtype=torch.int64)


def _agree(metas: list) -> None:
    """Raise, in every process alike, unless every process's blocks have
    one row count, width and word size."""
    if any(not torch.equal(m, metas[0]) for m in metas) or metas[0][0] != metas[0][1]:
        raise ValueError(
            "an exchange across processes takes blocks of one row count, width "
            f"and word size in every process: (rows min, max, C, bytes) "
            f"{[m.tolist() for m in metas]}"
        )


def _blocks_over_group(mine: list, mesh) -> list:
    """Every shard's block, in ring order, from every process's ``mine``
    over the ``gloo`` group (the CPU's exchange across processes)."""
    from sdnmpi_tpu_torch.shardplane.mesh import all_gather_cpu

    _agree(all_gather_cpu(_meta(mine), mesh))
    return [blk for got in all_gather_cpu(torch.stack(mine), mesh) for blk in got]


def _reach(mesh, last: int) -> dict:
    """For each process, the ring steps at which its blocks land in this
    process's views."""
    owner = [sh.process_index for sh in mesh.shards]
    s = mesh.n_shards
    reach: dict = {p: [] for p in sorted(set(owner))}
    for t in range(last + 1):
        for me in mesh.local:
            for d in step_offsets(t, s):
                steps = reach[owner[(me + d) % s]]
                if not steps or steps[-1] != t:
                    steps.append(t)
    return reach


class _Link:
    """One exchange's handshake across the processes of a mesh, on CUDA.

    In the constructor this process takes ``n_steps + 1`` interprocess
    events (a ready event, then one a step) and records the ready event
    on ``stream``, after everything it had queued there: a receive
    buffer handed out again is written only after its last readers.
    Then one ``all_gather`` over the group swaps what the blocks must
    agree on (:func:`_agree`), the view buffers' handles and the events'
    handles; the other processes' buffers and events are opened (once
    per handle), ``targets`` gets every shard's view address, and
    ``stream`` waits for the other processes' ready events.
    :meth:`arrive` records step t's event after its launch; one
    :meth:`barrier` after the last step orders every record before any
    wait; :meth:`wait` makes a stream wait for every process's last
    arrival that has reached this process's views (``reach``, all steps
    of every process unless set). Once a stream has waited for the last
    step, the exchange's events are taken again from the next handshake
    on: by then every process has queued its waits on them, since all
    run the same calls in one order."""

    def __init__(self, mesh, blocks: list, views: torch.Tensor, handle: bytes,
                 n_steps: int, stream):
        from sdnmpi_tpu_torch.shardplane.mesh import all_gather_cpu

        dev = views.device
        free = _EVENTS.setdefault(dev, [])
        free.extend(_DONE.pop(dev, []))
        self.dev = dev
        self.mine = [free.pop() if free else _new_event(dev) for _ in range(n_steps + 1)]
        _record(self.mine[0][0], stream)
        meta = _meta(blocks).view(torch.uint8)
        payload = torch.frombuffer(
            bytearray(handle + b"".join(h for _, h in self.mine)), dtype=torch.uint8)
        got = all_gather_cpu(torch.cat([meta, payload]), mesh)
        n_meta = meta.numel()
        _agree([g[:n_meta].view(torch.int64) for g in got])
        owner = [sh.process_index for sh in mesh.shards]
        pitch = views.stride(0) * views.element_size()
        self.targets = [0] * mesh.n_shards
        self.events = {}
        for p, g in enumerate(got):
            raw = g[n_meta:].numpy().tobytes()
            if p == mesh.rank:
                base, evs = views.data_ptr(), [e for e, _ in self.mine]
            else:
                base = _opened(_OPENED_BUFFERS, "ring_ipc_open", raw[:IPC_HANDLE])
                evs = [_opened(_OPENED_EVENTS, "ring_ipc_open_event",
                               raw[IPC_HANDLE * (i + 1):IPC_HANDLE * (i + 2)])
                       for i in range(n_steps + 1)]
                _stream_wait(stream, evs[0])
            for k, q in enumerate(q for q in range(mesh.n_shards) if owner[q] == p):
                self.targets[q] = base + k * pitch
            self.events[p] = evs
        self.reach = {p: list(range(n_steps)) for p in self.events}
        self.n_steps = n_steps
        self.waited: dict = {}

    def arrive(self, t: int, stream) -> None:
        _record(self.mine[t + 1][0], stream)

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier()

    def wait(self, t: int, stream) -> None:
        for p, steps in self.reach.items():
            landed = [u for u in steps if u <= t]
            if landed and landed[-1] > self.waited.get(p, -1):
                _stream_wait(stream, self.events[p][landed[-1] + 1])
                self.waited[p] = landed[-1]
        if t == self.n_steps - 1:  # the exchange is over for its events
            _DONE.setdefault(self.dev, []).extend(self.mine)
            self.mine = []


def close_exchanges() -> None:
    """End this process's part in the exchanges across processes: every
    process closes the buffers and events it opened, behind a barrier
    after every store, and frees its own (those no tensor holds) behind
    a second, once no process has them open. Every process of the group
    calls it, after its last exchange."""
    import torch.distributed as dist

    for dev in {b.dev for b in _ALLOCATED} | set(_EVENTS) | set(_DONE):
        torch.cuda.synchronize(dev)
    dist.barrier()
    void = [ctypes.c_void_p]
    for ptr in _OPENED_BUFFERS.values():
        _build.check(_ipc("ring_ipc_close", void)(ptr), "ring_ipc_close")
    events = list(_OPENED_EVENTS.values())
    _OPENED_BUFFERS.clear()
    _OPENED_EVENTS.clear()
    dist.barrier()
    for bufs in _BUFFERS.values():
        for buf in bufs:
            _build.check(_ipc("ring_ipc_free", void)(buf.ptr), "ring_ipc_free")
            _ALLOCATED.remove(buf)
    _BUFFERS.clear()
    events += [ev for evs in (*_EVENTS.values(), *_DONE.values()) for ev, _ in evs]
    _EVENTS.clear()
    _DONE.clear()
    for ev in events:
        _build.check(_ipc("ring_event_destroy", void)(ev), "ring_event_destroy")

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
- Wire packing: hop counts ride as bf16 while V - 1 fits bf16's exact
  integers, else as int16 with -1 for inf (exact while V <= 2**15), else
  unpacked f32; next hops ride as int16.

``ring_supported`` and the Pallas/XLA split of the reference are TPU
dispatch and have no counterpart here.
"""

from __future__ import annotations

import ctypes
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
    ptrs = [x.data_ptr() for x in blocks] + [o.data_ptr() for o in out]
    unit = _unit(nbytes, ptrs)
    fn = _build.function("ring", "ring_launch", [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ])
    in_arr = (ctypes.c_void_p * s)(*ptrs[:s])
    out_arr = (ctypes.c_void_p * s)(*ptrs[s:])
    err = fn(in_arr, out_arr, s, nbytes // unit, unit, _build.stream_ptr(dev))
    _build.check(err, "ring")
    ring_all_gather.launches += 1
    return out


def ring_all_gather(blocks: list, mesh) -> list:
    """All-gather the row-sharded blocks of ``mesh``: returns one
    ``[R, C]`` tensor per shard.

    ``blocks[q]`` is shard q's row block, rows ``[q*b, (q+1)*b)`` of the
    ``[R, C]`` matrix with ``b = ceil(R / s)`` (the final blocks may be
    short, as ``convert.shard_rows`` cuts them): short blocks are padded
    onto the wire and the result trimmed, as ``ring.py:386-400`` does.
    Strided blocks are made contiguous first. s = 1 returns the block and
    launches nothing. CPU tensors take the plain version (the ring
    schedule); CUDA tensors launch kernel K3 (every shard on one card) or
    raise."""
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


def ring_step_plain(blocks: list, views: torch.Tensor, t: int) -> None:
    """Step ``t`` of the exchange as torch ``copy_`` calls: the arrivals
    of :func:`ring_all_gather_plain`'s step t at every shard (its own
    block at step 0), each stored at rows ``origin*B..`` of that shard's
    ``[s*B, C]`` view ``views[me]``."""
    s = len(blocks)
    b = blocks[0].shape[0]
    for me in range(s):
        for d in step_offsets(t, s):
            origin = (me + d) % s
            views[me][origin * b:(origin + 1) * b].copy_(blocks[origin])


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
    address of shard q's block, ``views[me]`` that of shard me's view,
    ``nbytes`` a block's size. Source q goes to every shard ``me`` with
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
        table += [src[q], *[views[(q - d) % s] + q * nbytes for d in offsets], *pad]
    live = [p for p in table if p]
    phase = live[0] % BULK_ALIGN
    head = min(nbytes, -phase % BULK_ALIGN)
    mid = (nbytes - head) // BULK_ALIGN * BULK_ALIGN
    if mid > 0 and {p % BULK_ALIGN for p in live} == {phase}:
        grid = min(ctas, s * -(-mid // BULK_CHUNK))
        return StepArgs(tuple(table), True, 0, head, mid, nbytes - head - mid, grid)
    return StepArgs(tuple(table), False, _unit(nbytes, live), 0, 0, 0,
                    min(max(ctas // s, 1), 65535))


def _check_step(blocks: list, views: torch.Tensor) -> None:
    """Raise on blocks and views that the step form does not take."""
    s = len(blocks)
    first = blocks[0]
    b, c = first.shape
    for x in blocks:
        if x.shape != first.shape or x.dtype != first.dtype or x.device != first.device:
            raise ValueError("blocks must be equal [B, C] blocks of one dtype and device")
        if not x.is_contiguous():
            raise ValueError("blocks must be contiguous")
    if views.shape != (s, s * b, c) or views.dtype != first.dtype:
        raise ValueError(f"views must be [{s}, {s * b}, {c}] {first.dtype}, not "
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
    again reuses them."""

    def __init__(self, blocks: list, views: torch.Tensor, ctas: int | None = None):
        _check_step(blocks, views)
        self.blocks, self.views = blocks, views
        self.s = s = len(blocks)
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
        src = [x.data_ptr() for x in blocks]
        pitch = views.stride(0) * views.element_size()
        stream = _build.stream_ptr(dev)
        self.stream = stream.value or 0  # the default stream's handle is 0
        ctas = STEP_CTAS if ctas is None else ctas
        key = (*src, views.data_ptr(), pitch, nbytes, self.stream, ctas)
        planned = _PLAN_CALLS.get(key)
        if planned is None:
            view_ptrs = [views.data_ptr() + me * pitch for me in range(s)]
            calls, paths = [], []
            for t in range(self.last + 1):
                a = step_args(src, view_ptrs, nbytes, t, ctas)
                table = (ctypes.c_void_p * len(a.table))(*a.table)
                calls.append((table, s, int(a.bulk), nbytes, a.unit, a.head, a.mid,
                              a.tail, a.grid, stream))
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
    consumer asks for it."""

    def __init__(self, blocks: list):
        padded, b, r = _padded_blocks(blocks)
        self.blocks = padded
        self.s = s = len(padded)
        self.b, self.r = b, r
        self.last = max(ring_legs(s))
        first = padded[0]
        shape = (s, s * b, first.shape[1])
        if POISON:
            self.views = torch.full(shape, _sentinel(first.dtype), dtype=first.dtype,
                                    device=first.device)
        else:
            self.views = torch.empty(shape, dtype=first.dtype, device=first.device)
        self.landed = -1  # the CPU's last landed step
        self.stream = None
        if first.device.type != "cuda":
            return
        dev = first.device
        self.main = torch.cuda.current_stream(dev)
        self.stream = exchange_stream(dev)
        self.stream.wait_stream(self.main)
        self._trace("fork", -1, self.main)
        for x in (*padded, self.views):
            x.record_stream(self.stream)
        self.events = []
        with torch.cuda.stream(self.stream):
            plan = StepPlan(padded, self.views)
            for t in range(self.last + 1):
                if BEFORE_STEP is not None:
                    BEFORE_STEP(t)
                self._trace("start", t, self.stream)
                plan.launch(t)
                self._trace("end", t, self.stream)
                ev = torch.cuda.Event()
                ev.record(self.stream)
                self.events.append(ev)

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
                ring_step(self.blocks, self.views, self.landed)
            return
        self._trace("wait", t, self.main)
        self.main.wait_event(self.events[t])
        self._trace("ready", t, self.main)

    def join(self) -> None:
        """The current stream waits for the whole exchange."""
        if self.stream is None:
            self.wait(self.last)
        else:
            self._trace("join", self.last, self.main)
            self.main.wait_stream(self.stream)

    def origins(self, me: int, t: int) -> list:
        """The shards whose blocks reach shard ``me`` at step ``t``, cw
        before ccw (the reference's arrival order)."""
        return [(me + d) % self.s for d in step_offsets(t, self.s)]

    def view(self, me: int) -> torch.Tensor:
        """Shard ``me``'s ``[R, C]`` view (rows land as their steps do)."""
        return self.views[me][: self.r]

    def block(self, me: int, origin: int) -> torch.Tensor:
        """Shard ``origin``'s ``[B, C]`` block in shard ``me``'s view."""
        return self.views[me][origin * self.b:(origin + 1) * self.b]


def ring_stream(mesh, blocks: list, consume, carry: list) -> list:
    """Stream the shards' equal ``[B, C]`` wire blocks around the ring
    (:class:`RingExchange`) and hand every block to ``consume(carry, blk,
    src, step)`` as its step lands, in the reference's arrival order
    (``ring.py:185-195``): for each shard its own block at step 0, then
    per step t the cw block of shard ``(me - t) % s`` before the ccw block
    of ``(me + t) % s``. The consumers of step t are enqueued after the
    current stream waits for step t only, while the later steps are in
    flight. ``carry`` holds one carry per shard; returns the final
    carries, with the current stream joined to the exchange."""
    s = mesh.n_shards
    if len(blocks) != s:
        raise ValueError(f"{len(blocks)} blocks for a {s}-shard mesh")
    ex = RingExchange(blocks)
    out = list(carry)
    for t in range(ex.last + 1):
        ex.wait(t)
        for me in range(s):
            for src in ex.origins(me, t):
                out[me] = consume(out[me], ex.block(me, src), src, t)
    ex.join()
    return out


def start_distance_exchange(dist: list) -> RingExchange:
    """Pack row-sharded f32 hop counts to the wire (on the current
    stream) and start their exchange (see :func:`dist_wire_dtype`)."""
    v = dist[0].shape[1]
    return RingExchange([pack_dist_wire(d, v) for d in dist])


def finish_distance_exchange(ex: RingExchange) -> list:
    """Wait for a distance exchange and unpack every shard's replicated
    f32 matrix."""
    ex.join()
    return [unpack_dist_wire(ex.view(q)) for q in range(ex.s)]


def exchange_distances(dist: list, mesh) -> list:
    """Row-sharded f32 hop counts -> the replicated f32 matrix on every
    shard, packed for the wire (bit-exact, see :func:`dist_wire_dtype`):
    the blocking exchange, started and awaited at once."""
    if len(dist) != mesh.n_shards:
        raise ValueError(f"{len(dist)} blocks for a {mesh.n_shards}-shard mesh")
    return finish_distance_exchange(start_distance_exchange(dist))

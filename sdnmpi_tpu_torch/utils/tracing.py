"""Oracle timing, request-scoped spans + structured trace log (SURVEY
§5: the reference has no tracing/profiling at all; its closest artifact
is INFO-level handler logging).

Layers:

- :class:`OracleStats` — cheap always-on wall-time accounting of oracle
  invocations (a bounded deque per operation). The controller exposes it
  so operators can see route-compute latency percentiles without any
  profiler attached.
- :class:`Span` / :func:`start_span` / :func:`span` — request-scoped
  spans with parent/child links: one route request (packet-in ->
  coalesce -> window dispatch -> reap -> batched encode -> sliced
  install) yields one reconstructable span tree in the JSONL sink.
  Fan-in (many packet-ins coalescing into one window) is recorded as
  ``span_link`` records from the extra parents to the window span.
- :class:`Stages` — a span whose children run one after another, the
  stages of one call (the oracle's collective path: ``collective`` with
  ``resolve``, ``group``, ``deal``, ``base``, ``enqueue``;
  ``collective_reap`` with ``wait``, ``decode``, ``fdbs``,
  ``congestion``; ``phased`` with ``pack`` and its phases'
  ``collective`` spans).
- :func:`device_trace` — optional ``torch.profiler`` context writing a
  Chrome trace when ``Config.profile_dir`` is set; a no-op otherwise.

All layers emit structured JSONL records through ``trace_event`` when a
sink is installed (``set_trace_sink``), giving the structured event log
the reference lacks. Spans are also live while ``torch.profiler`` is
recording: each then opens a profiler range named ``sdnmpi.<span
name>`` for its lifetime, so the profiler lays the program's stages on
its own timeline beside the device's operations (``--profile-dir`` and
``--profile-dump`` traces, a benchmark's traced run). The JSONL record
is the same either way: ``t0``/``t1`` stay ``perf_counter`` stamps.
With neither armed, spans collapse to a shared no-op singleton and
``trace_event`` is one ``is None`` test — the hot path pays nothing for
the capability.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import pathlib
import statistics
import threading
import time
from typing import Callable, Optional

from torch.autograd import profiler as _torch_profiler

from sdnmpi_tpu_torch.utils.metrics import CURRENT_SPAN, REGISTRY

_sink: Optional[Callable[[dict], None]] = None
_sink_file = None  # open handle when the sink is file-based
#: additional tee'd sinks (the flight recorder, the --trace-dump
#: collector) delivered beside the primary sink; spans are live when
#: EITHER channel is armed. Kept separate from set_trace_sink so the
#: recorder can attach/detach without disturbing a file sink's handle.
_extra_sinks: list = []
_sink_errors = REGISTRY.counter(
    "trace_sink_errors_total",
    "trace sink callables that raised (record dropped, sink kept)",
)


def set_trace_sink(path_or_fn) -> None:
    """Install a JSONL trace sink: a file path, a callable(dict), or
    None to disable. Replacing a file-based sink closes its handle."""
    global _sink, _sink_file
    if _sink_file is not None:
        _sink_file.close()
        _sink_file = None
    if path_or_fn is None:
        _sink = None
    elif callable(path_or_fn):
        _sink = path_or_fn
    else:
        f = pathlib.Path(path_or_fn).open("a")
        _sink_file = f
        _sink = lambda rec: (f.write(json.dumps(rec) + "\n"), f.flush())  # noqa: E731


def add_trace_sink(fn: Callable[[dict], None]) -> None:
    """Attach an additional sink (tee). Idempotent per callable."""
    if fn not in _extra_sinks:
        _extra_sinks.append(fn)


def remove_trace_sink(fn: Callable[[dict], None]) -> None:
    """Detach a tee'd sink installed by :func:`add_trace_sink`."""
    if fn in _extra_sinks:
        _extra_sinks.remove(fn)


def _deliver(sink, rec: dict) -> None:
    try:
        sink(rec)
    except Exception:
        _sink_errors.inc()
        logging.getLogger("tracing").debug(
            "trace sink raised; record dropped", exc_info=True
        )


def trace_event(kind: str, **fields) -> None:
    """Emit one structured trace record (no-op without a sink). A sink
    that raises drops the record — never the caller: the sink is a tap
    on the control plane, and a broken exporter must not take the bus
    handler that happened to emit through it down with it. Each tee'd
    sink is guarded independently, so one broken exporter cannot starve
    the others of the record."""
    if _sink is not None or _extra_sinks:
        rec = {"ts": time.time(), "kind": kind, **fields}
        if _sink is not None:
            _deliver(_sink, rec)
        for sink in _extra_sinks:
            _deliver(sink, rec)


# -- request-scoped spans --------------------------------------------------

#: span-id allocator; ids are unique within one process/sink lifetime.
#: 0 is reserved for "no parent" (a root span).
_span_seq = 0

#: prefix of the profiler range a live span opens while the profiler records
RANGE_PREFIX = "sdnmpi."


def _live() -> bool:
    """Whether a span opened now is recorded: a sink is armed, or
    ``torch.profiler`` is recording (the module flag its start and stop
    set, the cheapest read of it)."""
    return _sink is not None or bool(_extra_sinks) or _torch_profiler._is_profiler_enabled


class Span:
    """One timed stage of a request, emitted as a single ``span`` JSONL
    record at :meth:`end` (``t0``/``t1`` are ``perf_counter`` stamps, so
    a reconstructed tree's stage ordering is monotonic even when the
    wall clock steps). Create through :func:`start_span` (explicit
    lifecycle — the coalescer parks spans across handler returns) or
    :func:`span` (context manager). Opened while the profiler records,
    it also holds a profiler range, ``sdnmpi.<name>``, closed at
    :meth:`end`; ranges may close out of LIFO order, as parked spans
    do."""

    __slots__ = ("id", "parent", "name", "t0", "fields", "_done", "_range")

    def __init__(self, name: str, parent: int, **fields) -> None:
        global _span_seq
        _span_seq += 1
        self.id = _span_seq
        self.parent = parent
        self.name = name
        self.t0 = time.perf_counter()
        self.fields = fields
        self._done = False
        self._range = (
            _torch_profiler.record_function(RANGE_PREFIX + name).__enter__()
            if _torch_profiler._is_profiler_enabled else None
        )
        # exemplar attribution: histogram observations inside this
        # span's scope pick up its id (utils/metrics.CURRENT_SPAN)
        CURRENT_SPAN[0] = self.id

    def child(self, name: str, **fields) -> "Span":
        return start_span(name, parent=self, **fields)

    def link(self, parent: "Span") -> None:
        """Record an ADDITIONAL parent (fan-in: many packet-ins feed one
        coalesced window). The tree edge is ``self.parent``; links are
        extra edges carried as their own records."""
        if self._done:
            return
        trace_event("span_link", span=self.id, parent=parent.id)

    def end(self, **fields) -> None:
        """Emit the span record (idempotent; extra fields merge in)."""
        if self._done:
            return
        self._done = True
        if CURRENT_SPAN[0] == self.id:
            # restore the enclosing span for later observations (only
            # when still active: parked spans end out of LIFO order)
            CURRENT_SPAN[0] = self.parent
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        trace_event(
            "span",
            name=self.name,
            span=self.id,
            parent=self.parent,
            t0=round(self.t0, 6),
            t1=round(t1, 6),
            wall_ms=round((t1 - self.t0) * 1e3, 3),
            **{**self.fields, **fields},
        )


class _NullSpan:
    """Shared do-nothing span handed out while no sink is installed and
    the profiler is not recording, so instrumented code threads span
    objects unconditionally but the disabled path allocates nothing per
    request."""

    __slots__ = ()
    id = 0
    parent = 0

    def child(self, name: str, **fields) -> "_NullSpan":
        return self

    def link(self, parent) -> None:
        pass

    def end(self, **fields) -> None:
        pass


NULL_SPAN = _NullSpan()


def start_span(name: str, parent=None, **fields):
    """Open a span (returns :data:`NULL_SPAN` when tracing is off: no
    sink armed and the profiler not recording). ``parent`` is a Span or
    None (root). The caller owns the lifecycle: call ``end()`` when the
    stage completes."""
    if not _live():
        return NULL_SPAN
    pid = 0 if parent is None else parent.id
    return Span(name, pid, **fields)


def start_child_span(name: str, **fields):
    """Open a span parented to the AMBIENT active span (the
    ``CURRENT_SPAN`` id exemplars attribute to) — for stages that run
    below an explicitly-parented span but behind a seam that does not
    thread the Span object. The oracle's sharded dispatch legs use
    this: the Router's ``route_window``/``dispatch`` span is active
    when the engine runs, so the shardplane leg nests under it in
    flight-recorder bundles exactly like the single-chip stages, with
    no oracle-API change. Parent id 0 (no ambient span) makes a root."""
    if not _live():
        return NULL_SPAN
    return Span(name, CURRENT_SPAN[0], **fields)


@contextlib.contextmanager
def span(name: str, parent=None, **fields):
    """Context-manager form of :func:`start_span`."""
    sp = start_span(name, parent=parent, **fields)
    try:
        yield sp
    finally:
        sp.end()


class Stages:
    """The children of ``span`` that run one after another: the stages
    of one call. :meth:`stage` ends the open stage and opens the next, a
    child of ``span``; :meth:`done` ends the open stage, so what follows
    runs in ``span``'s own time. As a context manager it ends the open
    stage and ``span``, also when the body raises. Over
    :data:`NULL_SPAN` (tracing off, or :data:`NULL_STAGES` for a caller
    outside a staged call) every stage is :data:`NULL_SPAN` too."""

    __slots__ = ("span", "_stage")

    def __init__(self, span) -> None:
        self.span = span
        self._stage = NULL_SPAN

    def stage(self, name: str, **fields) -> None:
        self._stage.end()
        self._stage = self.span.child(name, **fields)

    def done(self) -> None:
        self._stage.end()
        self._stage = NULL_SPAN

    def __enter__(self) -> "Stages":
        return self

    def __exit__(self, *exc) -> None:
        self.done()
        self.span.end()


#: stages that record nothing: what a staged leg's reap gets when its
#: caller is not itself staged
NULL_STAGES = Stages(NULL_SPAN)


def read_span_tree(records) -> dict[int, dict]:
    """Rebuild span nodes from decoded JSONL records: ``{span_id:
    {record..., "children": [ids], "links": [extra parent ids]}}``.
    The jq-free offline half of the span channel (tests + tooling); the
    README documents the jq one-liner equivalent."""
    nodes: dict[int, dict] = {}
    links: list[tuple[int, int]] = []
    for rec in records:
        if rec.get("kind") == "span":
            nodes[rec["span"]] = {**rec, "children": [], "links": []}
        elif rec.get("kind") == "span_link":
            links.append((rec["span"], rec["parent"]))
    for sid, node in nodes.items():
        parent = nodes.get(node.get("parent", 0))
        if parent is not None:
            parent["children"].append(sid)
    for sid, pid in links:
        if sid in nodes:
            nodes[sid]["links"].append(pid)
    return nodes


class OracleStats:
    """Bounded per-operation wall-time samples with summary figures.

    Appends take a lock (deque.append is atomic, but ``summary`` sorts
    the deque, and CPython raises ``deque mutated during iteration``
    when an append from another thread — the RPC event loop reading
    while the bus thread records — lands mid-sort); ``summary`` copies
    under the same lock and computes on the copy."""

    def __init__(self, maxlen: int = 512) -> None:
        self.samples: dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=maxlen)
        )
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def timed(self, op: str, **fields):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.samples[op].append(dt)
            trace_event("oracle", op=op, wall_ms=round(dt * 1e3, 3), **fields)

    def summary(self) -> dict[str, dict]:
        with self._lock:
            copies = {op: list(xs) for op, xs in self.samples.items()}
        out = {}
        for op, data in copies.items():
            data.sort()
            n = len(data)
            if n == 0:  # defaultdict read-access can leave empty deques
                continue
            # nearest-rank percentiles: p = ceil(q * n)-th smallest
            # sample (1-based). The old (99 * n) // 100 index was biased
            # a full rank high at small n (n=100 -> the max, not the
            # 99th sample).
            p50 = data[min(n - 1, (n + 1) // 2 - 1)]
            p99 = data[min(n - 1, (99 * n + 99) // 100 - 1)]
            out[op] = {
                "count": n,
                "mean_ms": round(statistics.fmean(data) * 1e3, 3),
                "p50_ms": round(p50 * 1e3, 3),
                "p99_ms": round(p99 * 1e3, 3),
                "max_ms": round(data[-1] * 1e3, 3),
            }
        return out


#: process-wide stats instance the oracle layers record into
STATS = OracleStats()

@contextlib.contextmanager
def device_trace(profile_dir: Optional[str]):
    """``torch.profiler`` context that writes a Chrome trace under
    ``profile_dir``; a no-op when profile_dir is falsy."""
    if not profile_dir:
        yield
        return
    from sdnmpi_tpu_torch.utils.devprof import _profiler, write_chrome_trace

    with _profiler() as prof:
        yield
    write_chrome_trace(prof, str(profile_dir), "device_trace")

"""Process-wide control-plane metrics registry (SURVEY §5: the
reference has no metrics at all; its closest artifact is the Monitor's
TSV log).

Three instrument kinds, Prometheus-shaped but dependency-free:

- :class:`Counter` — monotonically increasing count (``inc``);
- :class:`Gauge` — last-set value (``set``);
- :class:`Histogram` — fixed-bucket cumulative histogram (``observe``)
  with ``sum``/``count`` so rates and means fall out of two scrapes;
- :class:`LabeledCounter` — one counter per label value (a
  ``collections.Counter`` under the hood; the jit-trace probe
  ``utils.tracing.TRACE_COUNTS`` is its storage).

Design constraints, in priority order:

1. **Hot-path cheapness.** ``inc``/``set``/``observe`` are attribute
   writes and a ``bisect`` — no locks, no allocation beyond CPython's
   int/float boxing, no strings formatted, nothing conditional on an
   exporter being attached. The control plane is single-threaded by
   bus discipline (SURVEY §5), so plain writes are safe; the RPC
   mirror and the Prometheus renderer read through :meth:`snapshot`,
   which copies bucket lists so a reader never observes a torn
   histogram row.
2. **One registry, many exporters.** The RPC ``update_telemetry``
   broadcast, the text exposition (api/telemetry.py), and the bench
   ``--metrics-dump`` all read the SAME :data:`REGISTRY` snapshot, so
   they can never disagree about a value's meaning or moment.
3. **Idempotent registration.** ``counter(name)`` returns the existing
   instrument when the name is taken (modules grab their instruments
   at import time; re-imports and test reloads must not double-count).

Naming follows Prometheus conventions (``_total`` counters, base-unit
``_seconds``/``_bytes`` histograms) so the text exposition needs no
mapping table.
"""

from __future__ import annotations

import collections
from bisect import bisect_left
from typing import Optional

# Default latency buckets (seconds): 100us .. ~5s, roughly x3 steps —
# wide enough for a CPU-backend device dispatch and a remote-tunnel
# round-trip to land in distinct buckets.
LATENCY_BUCKETS_S = (
    0.0001, 0.0003, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 5.0
)

# Default size buckets (entries / bytes): 1 .. ~1M, x4 steps.
SIZE_BUCKETS = (
    1, 4, 16, 64, 256, 1024, 4096, 16384, 65536, 262144, 1048576
)

#: the ACTIVE span id, written by utils/tracing's Span lifecycle and
#: read by :meth:`Histogram.observe` when exemplars are armed — a one-
#: element list so metrics (imported by tracing) never imports tracing
#: back. 0 = no active span (tracing off, or between requests).
CURRENT_SPAN = [0]


class Counter:
    """Monotonic counter. ``inc`` is one attribute add — hot-path safe."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written value. ``set`` is one attribute write."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket histogram: ``bounds[i]`` is bucket i's inclusive
    upper edge; the final bucket is +Inf. ``observe`` is a bisect plus
    two adds — no allocation, no lock (see module docstring).

    **Exemplars**: when :meth:`arm_exemplars` has been called,
    each bucket additionally remembers the span id active at its most
    recent observation (the flight recorder resolves the id back to a
    full span tree, so a Prometheus latency spike becomes a concrete
    request trace). Unarmed — the default — ``exemplars`` is None and
    ``observe`` pays exactly one attribute load + is-None test extra:
    no per-observe allocation, the PR-4 hot-path contract."""

    __slots__ = ("name", "help", "bounds", "counts", "sum", "count",
                 "exemplars")

    def __init__(
        self, name: str, buckets=LATENCY_BUCKETS_S, help: str = ""
    ) -> None:
        self.name = name
        self.help = help
        self.bounds = tuple(float(b) for b in buckets)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram {name}: buckets must be sorted")
        self.counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        #: per-bucket span id of the latest observation (None = unarmed)
        self.exemplars: Optional[list] = None

    def observe(self, value: float, exemplar: int = 0) -> None:
        i = bisect_left(self.bounds, value)
        self.counts[i] += 1
        self.sum += value
        self.count += 1
        ex = self.exemplars
        if ex is not None:
            # fixed per-bucket slot, overwritten in place — the armed
            # path allocates nothing per observe either. ``exemplar``
            # lets sites whose spans have already closed attribute
            # explicitly (Router's flush e2e sample passes its last
            # window span id); everyone else inherits the tracing
            # layer's active span.
            sid = exemplar or CURRENT_SPAN[0]
            if sid:
                ex[i] = sid

    def arm_exemplars(self) -> None:
        """Start recording per-bucket exemplar span ids (idempotent)."""
        if self.exemplars is None:
            self.exemplars = [0] * (len(self.bounds) + 1)


class LabeledCounter:
    """A family of counters keyed by one label value.

    Storage is a ``collections.Counter`` exposed as ``values`` so
    existing probe idioms (``TRACE_COUNTS[kernel] += 1``,
    ``TRACE_COUNTS.clear()``) keep working while the registry snapshot
    and the text exposition see every label.
    """

    __slots__ = ("name", "help", "label", "values")

    def __init__(self, name: str, label: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self.label = label
        self.values: collections.Counter = collections.Counter()

    def inc(self, label_value: str, n: int = 1) -> None:
        self.values[label_value] += n


class LabeledHistogram:
    """A family of :class:`Histogram` children keyed by one label value
    (``jit_compile_seconds{kernel=...}``, the SLO plane's
    ``slo_route_latency_seconds{tenant=...}``).

    ``labels(value)`` hands back the child Histogram, which callers
    should grab ONCE per label and then observe into directly — the
    child's ``observe`` is the same bisect-plus-two-adds hot path as an
    unlabeled histogram. Children surface in the registry snapshot as
    ``name{label=value}`` histogram entries, so every exporter (text
    exposition, RPC feed, timeline) renders them without new plumbing.
    Label cardinality is the caller's contract: label values must be a
    bounded operator-controlled set (kernel names, configured tenants),
    never request data.
    """

    __slots__ = ("name", "help", "label", "buckets", "children", "_armed")

    def __init__(
        self, name: str, label: str, buckets=LATENCY_BUCKETS_S,
        help: str = "",
    ) -> None:
        self.name = name
        self.help = help
        self.label = label
        self.buckets = tuple(float(b) for b in buckets)
        self.children: dict[str, Histogram] = {}
        self._armed = False

    def labels(self, value: str) -> Histogram:
        """The child histogram for one label value (created on first
        use; joins exemplar arming like a late registration)."""
        h = self.children.get(value)
        if h is None:
            h = Histogram(
                f"{self.name}{{{self.label}={value}}}", self.buckets,
                self.help,
            )
            if self._armed:
                h.arm_exemplars()
            self.children[value] = h
        return h

    def observe(self, label_value: str, value: float) -> None:
        self.labels(label_value).observe(value)

    def arm_exemplars(self) -> None:
        self._armed = True
        for h in self.children.values():
            h.arm_exemplars()


class MetricsRegistry:
    """Name -> instrument map with idempotent constructors.

    Only the MAP is lock-guarded (registration, snapshot, reset —
    structural operations off the hot path); instrument writes stay
    lock-free. Instrumented modules register at import time, but the
    guard means even a late registration cannot race a reader thread's
    snapshot iteration."""

    def __init__(self) -> None:
        import threading

        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()
        self._exemplars_armed = False

    def _get_or_make(self, name: str, kind, *args, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, kind):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}, not {kind.__name__}"
                    )
                return existing
            metric = kind(name, *args, **kwargs)
            if self._exemplars_armed and isinstance(metric, Histogram):
                metric.arm_exemplars()  # late registrations join armed
            self._metrics[name] = metric
            return metric

    def arm_exemplars(self) -> None:
        """Arm per-bucket exemplar capture on every histogram, present
        and future (the flight recorder arms this once when it starts;
        the unarmed default keeps the PR-4 zero-allocation observe)."""
        with self._lock:
            self._exemplars_armed = True
            metrics = list(self._metrics.values())
        for m in metrics:
            if isinstance(m, (Histogram, LabeledHistogram)):
                m.arm_exemplars()

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(name, Gauge, help)

    def histogram(
        self, name: str, buckets=LATENCY_BUCKETS_S, help: str = ""
    ) -> Histogram:
        h = self._get_or_make(name, Histogram, buckets, help)
        if h.bounds != tuple(float(b) for b in buckets):
            # a silent wrong-bucketed instrument lands every later
            # observation in the top/+Inf buckets — as loud as the
            # kind-mismatch check, not garbage dashboards
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{h.bounds}, not {tuple(buckets)}"
            )
        return h

    def labeled_counter(
        self, name: str, label: str, help: str = ""
    ) -> LabeledCounter:
        c = self._get_or_make(name, LabeledCounter, label, help)
        if c.label != label:
            raise ValueError(
                f"labeled counter {name!r} already registered with "
                f"label {c.label!r}, not {label!r}"
            )
        return c

    def labeled_histogram(
        self, name: str, label: str, buckets=LATENCY_BUCKETS_S,
        help: str = "",
    ) -> LabeledHistogram:
        h = self._get_or_make(name, LabeledHistogram, label, buckets, help)
        if h.label != label or h.buckets != tuple(float(b) for b in buckets):
            raise ValueError(
                f"labeled histogram {name!r} already registered with "
                f"label {h.label!r} buckets {h.buckets}"
            )
        if self._exemplars_armed:
            h.arm_exemplars()
        return h

    def get(self, name: str) -> Optional[object]:
        return self._metrics.get(name)

    def __iter__(self):
        with self._lock:
            return iter(sorted(self._metrics.items()))

    def snapshot(self) -> dict:
        """JSON-safe copy of every instrument's current state — the one
        payload the RPC broadcast, the text exposition, and the bench
        dump all render from. Bucket lists are copied so a concurrent
        reader (the RPC event loop) never aliases live mutable state."""
        counters: dict[str, int] = {}
        gauges: dict[str, float] = {}
        histograms: dict[str, dict] = {}
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if isinstance(m, Counter):
                counters[name] = m.value
            elif isinstance(m, Gauge):
                gauges[name] = m.value
            elif isinstance(m, Histogram):
                h = {
                    "buckets": list(m.bounds),
                    "counts": list(m.counts),
                    "sum": m.sum,
                    "count": m.count,
                }
                if m.exemplars is not None:
                    h["exemplars"] = list(m.exemplars)
                histograms[name] = h
            elif isinstance(m, LabeledHistogram):
                for key in sorted(m.children):
                    c = m.children[key]
                    h = {
                        "buckets": list(c.bounds),
                        "counts": list(c.counts),
                        "sum": c.sum,
                        "count": c.count,
                    }
                    if c.exemplars is not None:
                        h["exemplars"] = list(c.exemplars)
                    histograms[c.name] = h
            elif isinstance(m, LabeledCounter):
                counters.update(
                    {
                        f"{name}{{{m.label}={k}}}": v
                        for k, v in sorted(m.values.items())
                    }
                )
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": histograms,
        }

    def reset(self) -> None:
        """Zero every instrument in place (tests; instrument identity —
        and therefore module-level references — survives)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if isinstance(m, Counter):
                m.value = 0
            elif isinstance(m, Gauge):
                m.value = 0.0
            elif isinstance(m, Histogram):
                m.counts = [0] * (len(m.bounds) + 1)
                m.sum = 0.0
                m.count = 0
                if m.exemplars is not None:
                    m.exemplars = [0] * (len(m.bounds) + 1)
            elif isinstance(m, LabeledHistogram):
                # children zero IN PLACE: callers hold child references
                # per the labels() grab-once contract (SLOPlane._hists,
                # the devprof compile listener), so dropping the dict
                # would orphan every cached child — post-reset
                # observations would land in objects no snapshot or
                # trigger can see
                for c in m.children.values():
                    c.counts = [0] * (len(c.bounds) + 1)
                    c.sum = 0.0
                    c.count = 0
                    if c.exemplars is not None:
                        c.exemplars = [0] * (len(c.bounds) + 1)
            elif isinstance(m, LabeledCounter):
                m.values.clear()


#: the process-wide registry every pipeline stage records into
REGISTRY = MetricsRegistry()

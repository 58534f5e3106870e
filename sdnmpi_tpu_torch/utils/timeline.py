"""Bounded downsampled metrics timeline.

The flight recorder keeps a SHORT rolling snapshot window (its trigger
baseline — tens of flushes); dashboards and the Perfetto export need
*minutes* of queryable history at bounded memory. This module keeps a
multi-resolution ring of **compact rows** (flattened counter/gauge
scalars plus derived figures — interval p99s, cache hit rate — never
full registry snapshots):

- level 0 holds the last ``maxlen`` flushes at full cadence;
- level k holds every ``decimation^k``-th flush, ``maxlen`` of them —
  so total memory is ``levels * maxlen`` rows while the covered span
  grows geometrically (512 flushes at the default Monitor cadence of
  1 s/pass ≈ 8.5 minutes at full resolution, ~2.3 hours at level 2).

Rows carry BOTH clocks: ``ts`` (wall, for humans and the RPC
``timeline()`` reply) and ``t_pc`` (``perf_counter``, the clock span
records use) — so :mod:`api.traceview` can rebase counter samples onto
the same axis as the span slices and the two render as one timeline.

Derived series (computed at record time from the previous raw row, so
consumers never re-diff counters):

- ``install_e2e_p99_ms`` — the interval's estimated route p99 (bucket
  delta of ``install_e2e_seconds``, nearest-rank);
- ``route_cache_hit_rate`` — interval hits / (hits + misses);

beside the raw gauges (``congestion_hot_link_bps``,
``device_memory_in_use_bytes``, queue depths, ...) and counter values.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

from sdnmpi_tpu_torch.utils.metrics import REGISTRY


def estimate_p99(buckets, counts) -> float:
    """Nearest-rank p99 from per-bucket counts (the flight recorder's
    estimator, hoisted here so both consumers share one definition):
    the upper edge of the bucket holding the 99th-percentile rank; the
    +Inf bucket reports the last finite edge (a lower bound)."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = max(1, -(-99 * total // 100))  # ceil(0.99 n), 1-based
    run = 0
    for i, c in enumerate(counts):
        run += c
        if run >= rank:
            return float(buckets[i]) if i < len(buckets) else float(
                buckets[-1]
            )
    return float(buckets[-1])


#: histograms whose interval p99 becomes a derived ``<name>_p99_ms``
#: series (the route/install latency lines a dashboard plots first)
P99_SERIES = ("install_e2e_seconds", "pipeline_reap_seconds")

#: the curated counter tracks the Perfetto export draws beside the span
#: slices (everything else stays queryable over the timeline() RPC —
#: a hundred counter tracks would bury the spans they annotate)
DEFAULT_TRACKS = (
    "route_cache_hit_rate",
    "install_e2e_seconds_p99_ms",
    "congestion_hot_link_bps",
    "device_memory_in_use_bytes",
    "coalescer_queue_depth",
    "pipeline_inflight_windows",
    "fabric_divergence_total",
    "trafficplane_hot_pair_bps",
    "route_staleness_ratio",
    "measured_vs_modeled_divergence",
)

#: labeled-family -> timeline channel mapping.
#: Plain counters/gauges map into rows by name and histograms by their
#: ``_count``/``_sum`` figures automatically; a LABELED family's
#: children carry ``name{label=value}`` names whose cardinality is the
#: caller's contract, so each family must DECLARE how it flattens into
#: one timeline channel — today "sum" (children aggregated; counters
#: sum their values, histogram children their counts). The metrics-lint
#: gate fails any labeled instrument registered without an entry here:
#: a metric you cannot see on the timeline is a metric whose regression
#: you cannot date.
LABELED_CHANNELS = {
    "admission_rejections_total": "sum",
    "fabric_divergence_total": "sum",
    "fabric_tenant_bytes_total": "sum",
    "flight_anomalies_total": "sum",
    "jit_compile_seconds": "sum",
    "jit_traces_total": "sum",
    "sentinel_divergence_total": "sum",
    "slo_burn_triggers_total": "sum",
    "slo_route_latency_seconds": "sum",
    "trafficplane_tenant_bytes_total": "sum",
}


class MetricsTimeline:
    """Multi-resolution ring of compact registry rows (module doc)."""

    def __init__(
        self,
        maxlen: int = 512,
        decimation: int = 4,
        levels: int = 3,
        registry=REGISTRY,
        clock=time.time,
    ) -> None:
        self.registry = registry
        self.clock = clock
        self.decimation = max(2, int(decimation))
        self.levels = [
            collections.deque(maxlen=int(maxlen)) for _ in range(levels)
        ]
        self.n_recorded = 0
        #: previous raw (counters, histogram counts) for interval deltas
        self._prev_counters: dict = {}
        self._prev_hist: dict = {}

    # -- ingest ------------------------------------------------------------

    def tick(self, snapshot: Optional[dict] = None,
             now: Optional[float] = None) -> dict:
        """Record one row (per EventStatsFlush). ``snapshot`` lets the
        flight recorder share the snapshot it already paid for; without
        one the registry is snapshotted here."""
        snap = self.registry.snapshot() if snapshot is None else snapshot
        row = self._compact(snap)
        row["ts"] = round(self.clock() if now is None else now, 6)
        row["t_pc"] = time.perf_counter()
        self.n_recorded += 1
        self.levels[0].append(row)
        # decimated levels: every d^k-th row also lands in level k
        step = 1
        for lvl in self.levels[1:]:
            step *= self.decimation
            if self.n_recorded % step == 0:
                lvl.append(row)
        return row

    def _compact(self, snap: dict) -> dict:
        """Flatten one registry snapshot into a scalar row + derived
        interval figures (one dict of floats — no bucket lists, no
        exemplars, no nested payloads)."""
        row: dict = {}
        counters = snap.get("counters", {})
        gauges = snap.get("gauges", {})
        hists = snap.get("histograms", {})
        row.update(counters)
        row.update(gauges)
        for name, h in hists.items():
            row[f"{name}_count"] = h["count"]
            row[f"{name}_sum"] = round(h["sum"], 6)
        # labeled families flatten into their declared channel (one
        # aggregate series per family beside the raw child series)
        agg: dict[str, float] = {}
        for name, v in counters.items():
            if "{" in name:
                base = name.split("{", 1)[0]
                if base in LABELED_CHANNELS:
                    agg[base] = agg.get(base, 0) + v
        for name, h in hists.items():
            if "{" in name:
                base = name.split("{", 1)[0]
                if base in LABELED_CHANNELS:
                    key = f"{base}_count"
                    agg[key] = agg.get(key, 0) + h["count"]
        row.update(agg)
        # derived: interval p99 of the latency headliners
        for name in P99_SERIES:
            h = hists.get(name)
            if h is None:
                continue
            prev = self._prev_hist.get(name)
            delta = h["counts"]
            if prev is not None and len(prev) == len(delta):
                delta = [a - b for a, b in zip(delta, prev)]
            row[f"{name}_p99_ms"] = round(
                estimate_p99(h["buckets"], delta) * 1e3, 3
            )
            self._prev_hist[name] = list(h["counts"])
        # derived: route-cache interval hit rate
        hits = counters.get("route_cache_hits_total", 0)
        misses = counters.get("route_cache_misses_total", 0)
        dh = hits - self._prev_counters.get("route_cache_hits_total", 0)
        dm = misses - self._prev_counters.get("route_cache_misses_total", 0)
        if dh + dm > 0:
            row["route_cache_hit_rate"] = round(dh / (dh + dm), 4)
        elif hits + misses > 0:
            row["route_cache_hit_rate"] = round(
                hits / (hits + misses), 4
            )
        self._prev_counters = {
            "route_cache_hits_total": hits,
            "route_cache_misses_total": misses,
        }
        return row

    # -- reads -------------------------------------------------------------

    def rows(self) -> list[dict]:
        """Merged multi-resolution history, oldest first: each coarser
        level contributes only the span the finer levels no longer
        cover, so one flush never appears twice."""
        out: list[dict] = []
        horizon = None  # oldest ts covered by finer levels
        for lvl in self.levels:
            if not lvl:
                continue
            rows = list(lvl)
            if horizon is None:
                out = rows
            else:
                out = [r for r in rows if r["ts"] < horizon] + out
            horizon = out[0]["ts"] if out else horizon
        return out

    def series(self, names=None) -> dict:
        """``{name: [[ts, value], ...]}`` over the merged history —
        the ``timeline()`` RPC payload. ``names`` filters; None returns
        every series present in any row."""
        rows = self.rows()
        want = set(names) if names else None
        out: dict[str, list] = {}
        for row in rows:
            ts = row["ts"]
            for k, v in row.items():
                if k in ("ts", "t_pc"):
                    continue
                if want is not None and k not in want:
                    continue
                out.setdefault(k, []).append([ts, v])
        return {
            "series": out,
            "n_rows": len(rows),
            "span_s": round(rows[-1]["ts"] - rows[0]["ts"], 3)
            if len(rows) > 1 else 0.0,
        }

    def counter_tracks(self, names=DEFAULT_TRACKS) -> list[dict]:
        """``[{name, points: [[t_pc, value], ...]}, ...]`` on the
        perf_counter clock — the Perfetto counter-track input
        (api/traceview.chrome_trace's ``counters=``)."""
        rows = self.rows()
        tracks: dict[str, list] = {}
        for row in rows:
            for name in names:
                v = row.get(name)
                if v is not None:
                    tracks.setdefault(name, []).append([row["t_pc"], v])
        return [
            {"name": k, "points": pts} for k, pts in tracks.items()
        ]

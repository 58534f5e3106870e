"""Perfetto / Chrome-trace export of span trees.

The span channel (utils/tracing.py) emits one JSONL ``span`` record per
pipeline stage; this module renders those records in the Chrome Trace
Event Format — the JSON object Perfetto, ``chrome://tracing``, and
``ui.perfetto.dev`` all open directly — so a coalesced route window
(dispatch overlapping the previous window's decode+install) shows up on
a real timeline instead of being eyeballed from wall_ms fields.

Mapping:

- every ``span`` record becomes one complete ("ph": "X") event with
  microsecond ``ts``/``dur`` rebased to the capture's first span;
- each span TREE gets its own ``tid`` (one track per request), named by
  its root span (``packet_in``, ``reval``, ...), so concurrent requests
  stack instead of overpainting each other;
- ``span_link`` records (coalescer fan-in: many packet-ins feeding one
  window) become flow-event pairs ("ph": "s"/"f") drawn as arrows from
  each extra parent into the window span.

Entry points: :func:`chrome_trace` (records -> trace dict),
:func:`dump_chrome_trace` (records -> file), :func:`convert` (JSONL
trace-log file -> trace file; also the ``python -m
sdnmpi_tpu_torch.api.traceview`` CLI). The launcher's ``--trace-dump PATH``
collects spans in memory and writes the trace on shutdown.
"""

from __future__ import annotations

import json
import pathlib
from typing import Iterable

#: keys of a span record that are structural, not user payload — the
#: rest are forwarded into the event's ``args`` for the detail pane
_STRUCTURAL = {"ts", "kind", "name", "span", "parent", "t0", "t1", "wall_ms"}


def _roots(spans: dict[int, dict]) -> dict[int, int]:
    """span id -> root id of its tree (parents outside the capture —
    e.g. a rotated-out root — promote the orphan to a root itself)."""
    root_of: dict[int, int] = {}

    def resolve(sid: int) -> int:
        seen = []
        cur = sid
        while True:
            hit = root_of.get(cur)
            if hit is not None:
                break
            seen.append(cur)
            parent = spans[cur].get("parent", 0)
            if not parent or parent not in spans:
                hit = cur
                break
            cur = parent
        for s in seen:
            root_of[s] = hit
        return hit

    for sid in spans:
        resolve(sid)
    return root_of


def chrome_trace(records: Iterable[dict], counters=None) -> dict:
    """Render decoded trace records as a Chrome Trace Event Format
    object (``{"traceEvents": [...], "displayTimeUnit": "ms"}``).

    ``counters`` adds Perfetto **counter tracks** beside the span
    slices: ``[{"name": ..., "points": [[t_pc, value],
    ...]}, ...]`` on the same ``perf_counter`` clock span ``t0``/``t1``
    stamps use (utils/timeline.MetricsTimeline.counter_tracks), so
    cache-hit-rate, route p99, congestion, and device-memory lines
    render on the same timeline as the requests they explain."""
    spans = {r["span"]: r for r in records if r.get("kind") == "span"}
    links = [
        (r["span"], r["parent"])
        for r in records
        if r.get("kind") == "span_link"
    ]
    events: list[dict] = []
    if not spans and not counters:
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    t_candidates = [r["t0"] for r in spans.values()] + [
        track["points"][0][0]
        for track in counters or ()
        if track.get("points")
    ]
    if not t_candidates:
        # counters= given but every track empty-pointed: an empty
        # trace, not a ValueError from min()
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    t_base = min(t_candidates)
    for track in counters or ():
        for t_pc, value in track.get("points", ()):
            events.append({
                "name": track["name"],
                "cat": "metric",
                "ph": "C",
                "ts": round((t_pc - t_base) * 1e6, 3),
                "pid": 1,
                "args": {"value": value},
            })
    if not spans:
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    root_of = _roots(spans)
    # stable per-tree track ids in first-seen order
    tid_of: dict[int, int] = {}
    for sid in sorted(spans):
        root = root_of[sid]
        if root not in tid_of:
            tid_of[root] = len(tid_of) + 1
            events.append({
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid_of[root],
                "args": {
                    "name": f"{spans[root]['name']} #{root}"
                },
            })
    events.append({
        "name": "process_name",
        "ph": "M",
        "pid": 1,
        "args": {"name": "sdnmpi control plane"},
    })
    for sid in sorted(spans):
        rec = spans[sid]
        args = {
            k: v for k, v in rec.items() if k not in _STRUCTURAL
        }
        args["span"] = sid
        if rec.get("parent"):
            args["parent"] = rec["parent"]
        events.append({
            "name": rec["name"],
            "cat": "span",
            "ph": "X",
            "ts": round((rec["t0"] - t_base) * 1e6, 3),
            "dur": round(max(0.0, rec["t1"] - rec["t0"]) * 1e6, 3),
            "pid": 1,
            "tid": tid_of[root_of[sid]],
            "args": args,
        })
    for n, (sid, parent) in enumerate(links):
        if sid not in spans or parent not in spans:
            continue
        src, dst = spans[parent], spans[sid]
        flow = {
            "name": "fan_in",
            "cat": "link",
            "id": n + 1,
            "pid": 1,
        }
        events.append({
            **flow,
            "ph": "s",
            "ts": round((src["t0"] - t_base) * 1e6, 3),
            "tid": tid_of[root_of[parent]],
        })
        events.append({
            **flow,
            "ph": "f",
            "bp": "e",  # bind to the enclosing slice, not the next one
            "ts": round((dst["t0"] - t_base) * 1e6, 3),
            "tid": tid_of[root_of[sid]],
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_chrome_trace(
    records: Iterable[dict], path: str, counters=None
) -> dict:
    """Write :func:`chrome_trace` of ``records`` to ``path``; returns
    the trace object."""
    trace = chrome_trace(records, counters=counters)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


class TraceCollector:
    """Bounded in-memory span collector for ``--trace-dump``: a tee'd
    trace sink retaining only span/span_link records (the kinds the
    timeline renders), dumped once on shutdown — with the metrics
    timeline's counter tracks beside the slices when one is passed."""

    def __init__(self, max_records: int = 100_000) -> None:
        import collections

        self.records: "collections.deque[dict]" = collections.deque(
            maxlen=max_records
        )

    def __call__(self, rec: dict) -> None:
        if rec.get("kind") in ("span", "span_link"):
            self.records.append(rec)

    def dump(self, path: str, timeline=None) -> dict:
        counters = (
            timeline.counter_tracks() if timeline is not None else None
        )
        return dump_chrome_trace(
            list(self.records), path, counters=counters
        )


def convert(jsonl_path: str, out_path: str) -> dict:
    """Offline conversion: a ``--trace-log`` JSONL file -> a Perfetto-
    loadable trace JSON."""
    records = []
    for line in pathlib.Path(jsonl_path).read_text().splitlines():
        line = line.strip()
        if line:
            records.append(json.loads(line))
    return dump_chrome_trace(records, out_path)


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        prog="sdnmpi_tpu_torch.api.traceview",
        description="convert a --trace-log JSONL file to a Perfetto/"
        "chrome://tracing JSON timeline",
    )
    p.add_argument("trace_log", help="JSONL trace log (utils/tracing.py)")
    p.add_argument("out", help="output trace JSON path")
    args = p.parse_args(argv)
    trace = convert(args.trace_log, args.out)
    print(f"{len(trace['traceEvents'])} events -> {args.out}")


if __name__ == "__main__":
    main()

"""Text exposition of the telemetry plane (Prometheus scrape format).

The RPC mirror's ``update_telemetry`` broadcast and this renderer read
the SAME registry snapshot (utils/metrics.REGISTRY + the oracle stats
summary), so the visualizer feed and scrape-style tooling can never
disagree — one registry, two encodings.

Entry points:

- :func:`render` — Prometheus text format (0.0.4) of a snapshot;
- :func:`telemetry_snapshot` — the shared JSON-safe snapshot payload
  (registry + oracle latency summary);
- :func:`dump` — write the exposition to a path ("-" = stdout), used
  by ``python -m sdnmpi_tpu_torch --metrics-dump`` and the bench suite's
  ``--metrics-dump`` (each config subprocess dumps its own registry
  next to the bench JSON via :func:`install_env_dump_hook`).
"""

from __future__ import annotations

import sys

from sdnmpi_tpu_torch.utils.metrics import REGISTRY

#: env var the bench runner sets for config subprocesses: a path to
#: dump the registry exposition to at interpreter exit
DUMP_ENV = "SDNMPI_METRICS_DUMP"


def telemetry_snapshot(registry=None, stats=None) -> dict:
    """The one telemetry payload: registry snapshot plus the oracle
    wall-time summary. Everything JSON-safe; the RPC broadcast ships it
    verbatim and :func:`render` flattens it to text."""
    if registry is None:
        registry = REGISTRY
    if stats is None:
        from sdnmpi_tpu_torch.utils.tracing import STATS

        stats = STATS
    snap = registry.snapshot()
    snap["oracle"] = stats.summary()
    return snap


def _sanitize(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    return "".join(c if c.isalnum() or c in "_:" else "_" for c in name)


def _escape_label(value: str) -> str:
    """Prometheus label-value escaping: an unescaped quote/backslash in
    one label value would make the parser reject the ENTIRE scrape."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _split_label(name: str) -> tuple[str, str]:
    """``name{key=value}`` -> (sanitized base, rendered ``key="value"``
    pair); a bare name comes back with an empty pair. The ONE parse of
    the labeled-instrument naming convention — the counter and
    histogram render branches must never drift on it. Split on the
    FIRST '{' and drop only the final '}': the label value itself may
    contain braces."""
    if "{" not in name:
        return _sanitize(name), ""
    base, label = name.split("{", 1)
    if label.endswith("}"):
        label = label[:-1]
    key, _, val = label.partition("=")
    return _sanitize(base), f'{key}="{_escape_label(val)}"'


def render(snapshot: dict) -> str:
    """Prometheus text exposition of a :func:`telemetry_snapshot` (or a
    bare registry snapshot). Counter names already carrying a label
    (``name{key=value}``) pass through with the label quoted."""
    lines: list[str] = []
    for name, value in snapshot.get("counters", {}).items():
        base, extra = _split_label(name)
        if extra:
            lines.append(f"{base}{{{extra}}} {value}")
        else:
            lines.append(f"{base} {value}")
    for name, value in snapshot.get("gauges", {}).items():
        lines.append(f"{_sanitize(name)} {value}")
    for name, h in snapshot.get("histograms", {}).items():
        # labeled-histogram children arrive as name{label=value}: the
        # label rides every series of the child, beside le= on buckets
        name, extra = _split_label(name)
        cumulative = 0
        sep = "," if extra else ""
        for bound, count in zip(h["buckets"], h["counts"]):
            cumulative += count
            lines.append(
                f'{name}_bucket{{{extra}{sep}le="{bound}"}} {cumulative}'
            )
        cumulative += h["counts"][-1]
        lines.append(f'{name}_bucket{{{extra}{sep}le="+Inf"}} {cumulative}')
        lines.append(f"{name}_sum{{{extra}}} {h['sum']}" if extra
                     else f"{name}_sum {h['sum']}")
        lines.append(f"{name}_count{{{extra}}} {h['count']}" if extra
                     else f"{name}_count {h['count']}")
    # oracle latency summary flattens to gauges (count/mean/p50/p99/max
    # per op) so scrape tooling sees route-compute latency too
    for op, s in snapshot.get("oracle", {}).items():
        base = _sanitize(f"oracle_{op}")
        for key, value in s.items():
            lines.append(f"{base}_{key} {value}")
    return "\n".join(lines) + "\n"


def dump(path: str = "-", snapshot: dict | None = None) -> str:
    """Render the current telemetry and write it to ``path`` ("-" =
    stdout). Returns the rendered text."""
    text = render(telemetry_snapshot() if snapshot is None else snapshot)
    if path == "-":
        sys.stdout.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)
    return text


def install_env_dump_hook() -> bool:
    """Arm an interpreter-exit dump to ``$SDNMPI_METRICS_DUMP`` when the
    env var is set (the bench runner's --metrics-dump plumbing: each
    config subprocess dumps its own registry next to its bench JSON).
    Returns True when armed."""
    import atexit
    import os

    path = os.environ.get(DUMP_ENV)
    if not path:
        return False
    atexit.register(lambda: dump(path))
    return True


# -- metrics reference -----------------------------------------------------
#
# The README's metrics reference table is generated from the reference
# package's registry; every instrument this package registers carries
# the reference's name, kind and label (tests/test_torch_telemetry.py
# holds the port's rows against the reference's), so the one table
# covers both. Print this package's rows with:
#
#   python -m sdnmpi_tpu_torch.api.telemetry --table

#: every module that registers instruments at import time — imported
#: before walking the registry so the reference is complete regardless
#: of which subsystems the current process happened to touch
INSTRUMENTED_MODULES = (
    "sdnmpi_tpu_torch.utils.metrics",
    "sdnmpi_tpu_torch.utils.tracing",
    "sdnmpi_tpu_torch.utils.flight",
    "sdnmpi_tpu_torch.utils.event_log",
    "sdnmpi_tpu_torch.utils.devprof",
    "sdnmpi_tpu_torch.control.router",
    "sdnmpi_tpu_torch.control.southbound",
    "sdnmpi_tpu_torch.control.admission",
    "sdnmpi_tpu_torch.control.audit",
    "sdnmpi_tpu_torch.control.slo",
    "sdnmpi_tpu_torch.control.recovery",
    "sdnmpi_tpu_torch.control.monitor",
    "sdnmpi_tpu_torch.control.topology_manager",
    "sdnmpi_tpu_torch.control.fabric",
    "sdnmpi_tpu_torch.control.sentinel",
    "sdnmpi_tpu_torch.control.replica",
    "sdnmpi_tpu_torch.api.snapshot",
    "sdnmpi_tpu_torch.oracle.trafficplane",
    "sdnmpi_tpu_torch.oracle.engine",
    "sdnmpi_tpu_torch.oracle.utilplane",
    "sdnmpi_tpu_torch.oracle.incremental",
    "sdnmpi_tpu_torch.oracle.routecache",
    "sdnmpi_tpu_torch.oracle.hier",
    "sdnmpi_tpu_torch.shardplane.hier",
    "sdnmpi_tpu_torch.core.topology_db",
)

#: name-prefix -> owning subsystem, LONGEST match wins (the table's
#: "owner" column; a new prefix without an entry surfaces as "?" in
#: the table, which the lint rejects — so new subsystems must claim
#: their names here)
METRIC_OWNERS = (
    ("admission_", "control/admission"),
    ("audit_", "control/audit"),
    ("barrier_", "control/recovery"),
    ("barriers_pending", "control/recovery"),
    ("desired_flows", "control/recovery"),
    ("coalescer_", "control/router"),
    ("compile_cache_", "utils/devprof"),
    ("congestion_", "control/topology_manager"),
    ("device_memory_", "utils/devprof"),
    ("echo_", "control/southbound"),
    ("event_log_", "utils/event_log"),
    ("fabric_", "control/fabric"),
    ("fabric_divergence_", "control/audit"),
    ("fabric_diverged_", "control/audit"),
    ("fabric_tenant_", "control/audit"),
    ("flight_", "utils/flight"),
    ("hier_", "oracle/hier"),
    ("install_e2e_", "control/router"),
    ("install_", "control/recovery"),
    ("jit_compile_", "utils/devprof"),
    ("jit_", "utils/tracing"),
    ("measured_vs_modeled_", "control/sentinel"),
    ("monitor_", "control/monitor"),
    ("oracle_", "oracle/engine"),
    ("pipeline_", "control/router"),
    ("profile_", "utils/devprof"),
    ("ownership_", "control/replica"),
    ("reconcile_", "control/recovery"),
    ("recovery_", "control/recovery"),
    ("replica_", "control/replica"),
    ("replication_", "control/replica"),
    ("snapshot_", "api/snapshot"),
    ("reval_", "control/router"),
    ("ring_", "shardplane"),
    ("route_cache_", "oracle/routecache"),
    ("route_staleness_", "control/sentinel"),
    ("sentinel_", "control/sentinel"),
    ("router_", "control/router"),
    ("sched_", "control/router"),
    ("serving_warmup_", "oracle/engine"),
    ("shard_", "oracle/engine"),
    ("slo_", "control/slo"),
    ("southbound_", "control/southbound"),
    ("topology_", "core/topology_db"),
    ("trace_", "utils/tracing"),
    ("trafficplane_", "oracle/trafficplane"),
    ("utilplane_", "oracle/utilplane"),
)


def owner_of(name: str) -> str:
    best = "?"
    best_len = 0
    for prefix, owner in METRIC_OWNERS:
        if name.startswith(prefix) and len(prefix) > best_len:
            best, best_len = owner, len(prefix)
    return best


def _import_instrumented() -> None:
    import importlib

    for mod in INSTRUMENTED_MODULES:
        importlib.import_module(mod)


def instrument_rows(registry=None) -> list[dict]:
    """Walk the (fully imported) registry into reference rows:
    ``{name, kind, label, owner, help}`` sorted by name. Labeled
    families appear ONCE under their family name — the label column
    carries the key."""
    from sdnmpi_tpu_torch.utils.metrics import (
        Counter,
        Gauge,
        Histogram,
        LabeledCounter,
        LabeledHistogram,
    )

    _import_instrumented()
    if registry is None:
        registry = REGISTRY
    kinds = {
        Counter: "counter",
        Gauge: "gauge",
        Histogram: "histogram",
        LabeledCounter: "counter",
        LabeledHistogram: "histogram",
    }
    rows = []
    for name, inst in registry:
        rows.append({
            "name": name,
            "kind": kinds.get(type(inst), type(inst).__name__),
            "label": getattr(inst, "label", "") or "",
            "owner": owner_of(name),
            "help": getattr(inst, "help", "") or "",
        })
    return rows


def metrics_table(registry=None) -> str:
    """The README's generated metrics reference table (markdown)."""
    lines = [
        "| metric | type | labels | owner |",
        "|---|---|---|---|",
    ]
    for r in instrument_rows(registry):
        lines.append(
            f"| `{r['name']}` | {r['kind']} | {r['label']} "
            f"| `{r['owner']}` |"
        )
    return "\n".join(lines) + "\n"


def documented_metrics(readme_text: str) -> set:
    """Metric names claimed by the README's reference table: the
    backticked first column of ``| `name` | ...`` rows (the lint's
    parse side — format drift fails loudly as an empty set)."""
    import re

    return set(re.findall(r"^\| `([a-z0-9_]+)` \|", readme_text, re.M))


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        prog="sdnmpi_tpu_torch.api.telemetry",
        description="telemetry tooling",
    )
    p.add_argument(
        "--table", action="store_true",
        help="print the generated metrics reference table (markdown)",
    )
    args = p.parse_args(argv)
    if args.table:
        sys.stdout.write(metrics_table())
    else:
        dump("-")


if __name__ == "__main__":
    main()

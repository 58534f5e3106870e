"""Controller composition root.

The reference composes its apps through Ryu's ``_CONTEXTS`` dependency
injection, with ``RPCInterface`` as the transitive root
(reference: sdnmpi/rpc_interface.py:19-25; SURVEY §3.1). Here composition
is explicit: one ``Controller`` wires the bus, the four apps, and the
southbound together, in a fixed deterministic order.

Counterpart of ``sdnmpi_tpu/control/controller.py``: the same planes,
built in the same order with the same bus subscriptions. The measured
traffic matrix and the memory gauges follow ``Config.device`` with the
torch oracle; the anomaly-armed profiler captures ``torch.profiler``
windows; ``Config.hier_oracle`` routes through the hierarchical oracle
(``oracle/hier.py``).
"""

from __future__ import annotations

from typing import Optional

from sdnmpi_tpu_torch.config import Config, DEFAULT_CONFIG
from sdnmpi_tpu_torch.control.bus import EventBus
from sdnmpi_tpu_torch.control.monitor import Monitor
from sdnmpi_tpu_torch.control.process_manager import ProcessManager
from sdnmpi_tpu_torch.control.router import Router
from sdnmpi_tpu_torch.control.topology_manager import TopologyManager


class Controller:
    name = "Controller"

    def __init__(
        self,
        southbound,
        config: Config = DEFAULT_CONFIG,
        *,
        ownership=None,
        replica_link=None,
    ) -> None:
        self.config = config
        self.bus = EventBus()
        self.southbound = southbound
        # telemetry snapshot seam: the RPC mirror (and anything else on
        # the bus) reads the process-wide registry through the
        # composition root, so tests can interpose and the reply always
        # carries the controller's own view
        from sdnmpi_tpu_torch.control import events as ev

        self.bus.provide(
            ev.TelemetryRequest,
            lambda req: ev.TelemetryReply(self.telemetry()),
        )

        # Subscription order fixes packet-in handling order; the reference's
        # equivalent order is Ryu's app instantiation order (SURVEY §3.1).
        self.topology_manager = TopologyManager(self.bus, southbound, config)
        self.process_manager = ProcessManager(self.bus, southbound, config)
        self.router = Router(self.bus, southbound, config)
        if hasattr(southbound, "install_highwater"):
            # batched-install backpressure cap (see OFSouthbound)
            southbound.install_highwater = config.install_highwater
        if hasattr(southbound, "send_barriers"):
            # acked installs: barrier-terminated windows
            southbound.send_barriers = config.install_barriers
        if hasattr(southbound, "echo_interval"):
            # controller-side keepalive knobs (the launcher arms the
            # loop; echo_tick is also callable synchronously in tests)
            southbound.echo_interval = config.echo_interval_s
            southbound.echo_timeout = config.echo_timeout_s
        if config.coalesce_routes:
            if hasattr(southbound, "on_idle"):
                # route coalescing: the southbound's burst-drained edge
                # flushes the Router's pending lookups as one batched
                # oracle call (see Router.flush_routes)
                southbound.on_idle = self.router.flush_routes
                self.router.coalesce = True
            else:
                # never half-enable: without an idle edge a lone parked
                # packet would wait forever for a batch companion
                import logging

                logging.getLogger("Controller").warning(
                    "coalesce_routes is on but the southbound has no "
                    "on_idle hook; falling back to direct per-packet "
                    "route resolution"
                )
        self.monitor: Optional[Monitor] = (
            Monitor(self.bus, southbound, config) if config.enable_monitor else None
        )
        # --observe-links equivalent (reference: run_router.sh:2): learn
        # links/hosts from LLDP probes + traffic instead of entity events
        self.discovery = None
        if config.observe_links:
            from sdnmpi_tpu_torch.control.discovery import LLDPDiscovery

            self.discovery = LLDPDiscovery(self.bus, southbound, config)

        # structured JSONL event log: a wildcard bus tap (SURVEY §5)
        self.event_logger = None
        if config.event_log:
            from sdnmpi_tpu_torch.utils.event_log import EventLogger

            self.event_logger = EventLogger(
                config.event_log, max_bytes=config.event_log_max_bytes
            )
            self.bus.tap(self.event_logger)

        # device-runtime telemetry (utils/devprof.py): memory
        # watermark gauges sampled once per Monitor flush. Subscribed
        # BEFORE the flight recorder so the trigger pass (and the
        # timeline row) sees the same pass's fresh sample.
        from sdnmpi_tpu_torch.utils import devprof

        devprof.install_monitoring()
        device = config.device if config.oracle_backend == "torch" else "cpu"
        self.bus.subscribe(
            ev.EventStatsFlush, lambda e: devprof.sample_memory(device)
        )

        # SLO plane (control/slo.py): per-tenant objectives,
        # per-tenant latency histograms fed by the Router at window
        # completion, and one multi-window burn-rate trigger per tenant
        # registered with the flight recorder below.
        self.slo = None
        if config.slo_targets:
            from sdnmpi_tpu_torch.control.slo import SLOPlane

            self.slo = SLOPlane(
                config.slo_targets,
                self.router.admission,
                burn_factor=config.slo_burn_factor,
                slow_flushes=config.slo_slow_flushes,
            )
            self.router.slo = self.slo

        # fabric ground-truth audit plane (control/audit.py):
        # per-flush OFPST_FLOW sweeps diff the fabric's actual tables
        # against the desired store and heal confirmed divergence as
        # targeted re-drives. Arms only when the southbound can answer
        # flow stats (the sim Fabric and OFSouthbound both can; duck-
        # typed minimal test stacks cannot). Subscribed BEFORE the
        # flight recorder so the trigger pass sees the same flush's
        # fresh divergence counters.
        self.audit = None
        if config.fabric_audit and hasattr(southbound, "flow_stats"):
            from sdnmpi_tpu_torch.control.audit import AuditPlane

            self.audit = AuditPlane(config, southbound, self.router)
            self.router.audit = self.audit
            # the congestion report's measured-vs-modeled column reads
            # the audit's attribution (TopologyManager._assemble_congestion)
            self.topology_manager.audit = self.audit
            self.bus.subscribe(
                ev.EventStatsFlush, lambda e: self.audit.sweep()
            )

        # measured traffic matrix + shadow route-quality sentinel
        #: the audit sweep's attributed byte deltas feed a
        # device-resident per-tenant src->dst rate matrix
        # (oracle/trafficplane.py), and each flush re-scores a paced
        # sample of installed routes against a fresh oracle optimum for
        # that measured matrix (control/sentinel.py). Subscribed AFTER
        # the audit sweep (the flush that feeds the matrix) and BEFORE
        # the flight recorder (the trigger pass must see this flush's
        # divergence counters).
        self.traffic = None
        self.sentinel = None
        if self.audit is not None and config.traffic_plane:
            from sdnmpi_tpu_torch.control.sentinel import RouteSentinel
            from sdnmpi_tpu_torch.oracle.trafficplane import TrafficPlane

            self.traffic = TrafficPlane(
                self.topology_manager.topologydb, config
            )
            self.audit.traffic = self.traffic
            self.sentinel = RouteSentinel(
                config, self.router, self.topology_manager.topologydb,
                self.traffic, audit=self.audit,
            )
            self.bus.subscribe(
                ev.EventStatsFlush, lambda e: self._traffic_tick()
            )

        # active/active replica plane: store replication +
        # lease failover, ticking on the same EventStatsFlush edge as
        # the audit sweep above (and before the flight recorder below,
        # so a failover's adoption events land in the same pass's
        # trigger sweep). Default-off: without an ownership map and a
        # peer link nothing is constructed.
        self.ownership = ownership
        self.replica = None
        if ownership is not None and replica_link is not None:
            from sdnmpi_tpu_torch.control.replica import ReplicaPlane

            self.replica = ReplicaPlane(self, ownership, replica_link, config)
            self.bus.subscribe(
                ev.EventStatsFlush, lambda e: self.replica.tick()
            )
        self.bus.provide(ev.ReplicaStatusRequest, self._replica_status)

        # anomaly-armed profiler capture: a firing trigger
        # opens a torch.profiler window for profile_capture_s seconds
        self.profile_capture = None
        if config.profile_dump_dir:
            self.profile_capture = devprof.ProfileCapture(
                config.profile_dump_dir, config.profile_capture_s
            )

        # flight recorder: bounded span-tree ring + snapshot
        # window + event tail, with anomaly triggers freezing diagnostic
        # bundles. Wired LAST so its per-EventStatsFlush trigger pass
        # observes the same pass's utilization flush, anti-entropy tick,
        # and recovery counters (bus handlers run in subscription order).
        self.flight = None
        if config.flight_recorder:
            from sdnmpi_tpu_torch.utils.flight import (
                FlightRecorder,
                HistogramThreshold,
                P99Regression,
            )

            flight = FlightRecorder(
                max_trees=config.flight_max_trees,
                dump_dir=config.flight_dump_dir,
                # the SLO slow window reads the recorder's snapshot
                # ring: size it to COVER slo_slow_flushes, or a large
                # configured window would silently truncate to the
                # ring depth and page noisier than configured
                max_snapshots=max(32, config.slo_slow_flushes + 1),
            )
            # escalations/timeouts: every increment is an incident
            flight.add_counter_triggers()
            for hist in self.LATENCY_HISTOGRAMS:
                if config.flight_latency_threshold_s > 0:
                    flight.triggers.append(HistogramThreshold(
                        hist, config.flight_latency_threshold_s
                    ))
                if config.flight_p99_factor > 0:
                    flight.triggers.append(P99Regression(
                        hist, factor=config.flight_p99_factor
                    ))
            flight.add_context("topology", self._topology_forensics)
            flight.add_context("windows", self.router.window_census)
            if self.slo is not None:
                # SLO burn triggers + the bundle context naming the
                # burning tenant's dominant pipeline stage
                flight.triggers.extend(self.slo.triggers())
                flight.add_context(
                    "slo", lambda: self.slo.forensics(self.flight)
                )
            if self.audit is not None:
                # fabric divergence is ALWAYS an incident: the frozen
                # bundle's detail names the switch and rows
                flight.triggers.append(self.audit.trigger())
                flight.add_context("audit", self.audit.forensics)
            if self.sentinel is not None:
                # routes-don't-fit-the-traffic: the frozen bundle's
                # detail names the worst (tenant, collective, pod-pair)
                # and the context carries the measured matrix
                flight.triggers.append(self.sentinel.trigger())
                flight.add_context("traffic", self.sentinel.forensics)
            if self.replica is not None:
                # failover forensics: ownership map, sequence numbers,
                # replication lag at the moment a bundle froze
                flight.add_context("replica", self.replica.status)
            flight.on_anomaly = self._publish_anomaly
            flight.arm()
            self.bus.tap(flight.event_tap)
            self.bus.subscribe(
                ev.EventStatsFlush, lambda e: flight.snapshot_tick()
            )
            self.flight = flight

        # metrics timeline (utils/timeline.py): one compact
        # row per EventStatsFlush — riding the flight recorder's
        # snapshot tee when armed (the tick already paid for the
        # snapshot), its own subscription otherwise.
        self.timeline = None
        if config.metrics_timeline:
            from sdnmpi_tpu_torch.utils.timeline import MetricsTimeline

            self.timeline = MetricsTimeline(
                maxlen=config.timeline_points
            )
            if self.flight is not None:
                self.flight.on_snapshot = (
                    lambda ts, snap: self.timeline.tick(snap, ts)
                )
            else:
                self.bus.subscribe(
                    ev.EventStatsFlush, lambda e: self.timeline.tick()
                )
        if self.profile_capture is not None:
            # close an expired capture window on the flush AFTER the
            # flight recorder's trigger pass (which may have opened it)
            self.bus.subscribe(
                ev.EventStatsFlush,
                lambda e: self.profile_capture.tick(),
            )
        self.bus.provide(ev.SpanTreeRequest, self._span_tree)
        self.bus.provide(ev.FlightDumpRequest, self._flight_dump)
        self.bus.provide(ev.TimelineRequest, self._timeline)
        self.bus.provide(ev.TrafficMatrixRequest, self._traffic_matrix)

    #: the route/install/re-route latency histograms the flight
    #: recorder's latency/p99 triggers watch
    LATENCY_HISTOGRAMS = (
        "install_e2e_seconds",
        "pipeline_install_seconds",
        "reval_rescore_seconds",
        "reval_install_seconds",
        "barrier_rtt_seconds",
    )

    def attach(self) -> None:
        """Connect the southbound fabric and replay discovery."""
        self.southbound.connect(self.bus)

    def telemetry(self) -> dict:
        """One snapshot of the control-plane telemetry: the process-wide
        metrics registry (counters/gauges/histograms, the jit-trace
        family) plus the oracle wall-time summary and the latest
        congestion-analytics report. The RPC mirror broadcasts exactly
        this dict as ``update_telemetry`` and the Prometheus exposition
        (api/telemetry.py) renders exactly this dict — one registry,
        two encodings, no chance of drift."""
        from sdnmpi_tpu_torch.control import events as ev
        from sdnmpi_tpu_torch.api.telemetry import telemetry_snapshot

        # the event log's own figures (event_log_events_total,
        # event_log_rotations_total) already live in the registry —
        # no hand-injected duplicates to reconcile
        snap = telemetry_snapshot()
        try:
            report = self.bus.request(ev.CongestionReportRequest()).report
        except LookupError:  # duck-typed minimal stacks
            report = {}
        if report:
            snap["congestion"] = report
        return snap

    # -- flight recorder seams -----------------------------------

    def _span_tree(self, req) -> "object":
        from sdnmpi_tpu_torch.control import events as ev

        tree = (
            self.flight.tree_for(req.span_id)
            if self.flight is not None
            else None
        )
        return ev.SpanTreeReply(tree)

    def _flight_dump(self, req) -> "object":
        from sdnmpi_tpu_torch.control import events as ev

        bundle = (
            self.flight.freeze("manual", {})
            if self.flight is not None
            else {}
        )
        return ev.FlightDumpReply(bundle)

    def _timeline(self, req) -> "object":
        from sdnmpi_tpu_torch.control import events as ev

        timeline = (
            self.timeline.series(req.names)
            if self.timeline is not None
            else {"series": {}, "n_rows": 0, "span_s": 0.0}
        )
        return ev.TimelineReply(timeline)

    def _traffic_tick(self) -> None:
        """Per-flush measured-traffic step: publish the matrix epoch the
        audit sweep just staged, then let the sentinel re-score against
        it (runs after audit.sweep by subscription order, before the
        flight recorder's trigger pass)."""
        self.traffic.flush()
        self.sentinel.sweep()

    def _traffic_matrix(self, req) -> "object":
        from sdnmpi_tpu_torch.control import events as ev

        matrix = (
            self.traffic.matrix()
            if self.traffic is not None
            else {"epoch": 0, "mode": "off", "endpoints": [], "cells": []}
        )
        return ev.TrafficMatrixReply(matrix)

    def _replica_status(self, req) -> "object":
        from sdnmpi_tpu_torch.control import events as ev

        status = (
            self.replica.status()
            if self.replica is not None
            else {"mode": "off"}
        )
        return ev.ReplicaStatusReply(status)

    def _publish_anomaly(self, bundle: dict) -> None:
        """Flight-recorder anomaly hook -> one EventAnomaly on the bus
        (the RPC mirror broadcasts it). The summary strips the bulky
        members — trees and full snapshots stay in the recorder and the
        dump file."""
        from sdnmpi_tpu_torch.control import events as ev

        summary = {
            k: v
            for k, v in bundle.items()
            if k not in ("span_trees", "metrics", "events_tail", "exemplars")
        }
        if self.profile_capture is not None:
            # anomaly-armed device profiling: the capture
            # window opens the moment the trigger fires and closes on a
            # later flush tick — the profile OF the incident
            self.profile_capture.on_anomaly(bundle)
        self.bus.publish(ev.EventAnomaly(
            bundle["trigger"], summary, bundle.get("path")
        ))

    def _topology_forensics(self) -> dict:
        """Flight-bundle context: TopologyDB epoch/dirty-set state, the
        utilization plane's epoch, and the latest congestion report —
        the 'what did the graph look like' half of an incident."""
        db = self.topology_manager.topologydb
        plane = self.topology_manager.util_plane
        out = {
            "version": getattr(db, "version", None),
            "n_switches": len(getattr(db, "switches", ())),
            "util_epoch": plane.epoch if plane is not None else 0,
            "congestion": self.topology_manager.congestion,
        }
        log = getattr(db, "_delta_log", None)
        if log:
            out["delta_log_tail"] = [list(e) for e in list(log)[-16:]]
        return out

"""Controller composition root.

The reference composes its apps through Ryu's ``_CONTEXTS`` dependency
injection, with ``RPCInterface`` as the transitive root
(reference: sdnmpi/rpc_interface.py:19-25; SURVEY §3.1). Here composition
is explicit: one ``Controller`` wires the bus, the four apps, and the
southbound together, in a fixed deterministic order.

Counterpart of ``sdnmpi_tpu/control/controller.py``. The planes the
port does not have yet (the SLO, audit, traffic, replica, flight-recorder
and timeline planes of ROADMAP A11) are refused by
:meth:`Config.require_ported` before anything is built; their bus
seams answer as the reference's do when the plane is off.
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
        config.require_ported()
        if ownership is not None or replica_link is not None:
            raise NotImplementedError(
                "the active/active replica plane is not ported yet (ROADMAP A11)"
            )
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
        # watermark gauges sampled once per Monitor flush
        from sdnmpi_tpu_torch.utils import devprof

        devprof.install_monitoring()
        device = config.device if config.oracle_backend == "torch" else "cpu"
        self.bus.subscribe(
            ev.EventStatsFlush, lambda e: devprof.sample_memory(device)
        )

        # the planes of ROADMAP A11 (require_ported refused them above);
        # their bus seams answer as the reference's do with the plane off
        self.slo = None
        self.audit = None
        self.traffic = None
        self.sentinel = None
        self.ownership = None
        self.replica = None
        self.flight = None
        self.timeline = None
        self.profile_capture = None
        self.bus.provide(
            ev.ReplicaStatusRequest,
            lambda req: ev.ReplicaStatusReply({"mode": "off"}),
        )
        self.bus.provide(ev.SpanTreeRequest, lambda req: ev.SpanTreeReply(None))
        self.bus.provide(ev.FlightDumpRequest, lambda req: ev.FlightDumpReply({}))
        self.bus.provide(
            ev.TimelineRequest,
            lambda req: ev.TimelineReply(
                {"series": {}, "n_rows": 0, "span_s": 0.0}
            ),
        )
        self.bus.provide(
            ev.TrafficMatrixRequest,
            lambda req: ev.TrafficMatrixReply(
                {"epoch": 0, "mode": "off", "endpoints": [], "cells": []}
            ),
        )

    def attach(self) -> None:
        """Connect the southbound fabric and replay discovery."""
        self.southbound.connect(self.bus)

    def telemetry(self) -> dict:
        """The reference's telemetry snapshot (``api/telemetry.py``) is
        not ported yet (ROADMAP A11)."""
        raise NotImplementedError(
            "the telemetry snapshot (api/telemetry.py) is not ported yet "
            "(ROADMAP A11)"
        )

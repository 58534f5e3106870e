"""Port-statistics monitor app.

Equivalent of the reference's ``Monitor`` (reference: sdnmpi/monitor.py:21-94):
polls per-port counters of every live datapath on an interval, converts
cumulative counters into rx/tx packets-per-second and bytes-per-second
deltas, and logs one TSV line per port
(``dpid  port  rx_pps  rx_bps  tx_pps  tx_bps``, monitor.py:87-88).

Beyond the reference, every sample is also published as ``EventPortStats``
so the TopologyManager can maintain the per-link utilization tensor that
feeds congestion-aware routing — turning the monitor stream from a log
file into an input of the path oracle (SURVEY §5 north star).

``poll(now)`` performs one synchronous sampling pass (tests inject
timestamps); ``run()`` is the asyncio polling loop used by the CLI, taking
the place of the reference's green thread (monitor.py:32,47-52).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

from sdnmpi_tpu_torch.config import Config, DEFAULT_CONFIG
from sdnmpi_tpu_torch.control import events as ev
from sdnmpi_tpu_torch.control.bus import EventBus
from sdnmpi_tpu_torch.utils.metrics import REGISTRY

log = logging.getLogger("Monitor")

_m_passes = REGISTRY.counter(
    "monitor_passes_total",
    "completed port-stats sampling passes (the telemetry feed cadence)",
)
_m_samples = REGISTRY.counter(
    "monitor_port_samples_total", "per-port throughput samples published"
)
# shared with control/southbound.py (which discards the stale cached
# StatsReply on a FEATURES_REPLY redial): both sites count the same
# phenomenon — per-connection stats state outliving its connection
_m_stale_stats = REGISTRY.counter(
    "monitor_stale_stats_total",
    "stale cached port-stats state discarded when a datapath redialed",
)


@dataclasses.dataclass
class _PortSample:
    timestamp: float
    rx_packets: int
    rx_bytes: int
    tx_packets: int
    tx_bytes: int


class Monitor:
    name = "Monitor"

    def __init__(
        self,
        bus: EventBus,
        southbound,
        config: Config = DEFAULT_CONFIG,
    ) -> None:
        self.bus = bus
        self.southbound = southbound
        self.config = config
        self.datapaths: set[int] = set()
        #: dpid -> port_no -> last sample (reference: monitor.py:29-31)
        self.datapath_stats: dict[int, dict[int, _PortSample]] = {}

        bus.subscribe(ev.EventDatapathUp, self._datapath_up)
        bus.subscribe(ev.EventDatapathDown, self._datapath_down)

    def _datapath_up(self, event: ev.EventDatapathUp) -> None:
        self.datapaths.add(event.dpid)
        if self.datapath_stats.get(event.dpid):
            # an Up without a Down in between is a redial race (or a
            # recovery-plane resync): the switch's counters restarted
            # from zero, so the old baselines would differentiate into
            # negative garbage — re-baseline from scratch
            _m_stale_stats.inc()
            self.datapath_stats[event.dpid] = {}
        else:
            self.datapath_stats.setdefault(event.dpid, {})

    def _datapath_down(self, event: ev.EventDatapathDown) -> None:
        self.datapaths.discard(event.dpid)
        self.datapath_stats.pop(event.dpid, None)

    # -- sampling ---------------------------------------------------------

    def poll(self, now: Optional[float] = None) -> None:
        """One sampling pass over every live datapath. The end of the
        pass publishes EventStatsFlush so utilization consumers ingest
        the pass's samples as one vectorized batch (the device
        utilization plane's scatter cadence)."""
        for dpid in sorted(self.datapaths):
            self._poll_one(dpid, time.time() if now is None else now)
        _m_passes.inc()
        self.bus.publish(ev.EventStatsFlush())

    def _poll_one(self, dpid: int, now: float) -> None:
        """Sample one datapath — the unit shared by the synchronous
        poll() and the sliced async loop."""
        stats = self.southbound.port_stats(dpid)
        self._ingest(dpid, stats, now)

    def _ingest(self, dpid: int, stats, now: float) -> None:
        per_port = self.datapath_stats.setdefault(dpid, {})
        for stat in sorted(stats, key=lambda s: s.port_no):
            last = per_port.get(stat.port_no)
            if last is None:
                # first sample establishes the baseline
                # (reference: monitor.py:70-77)
                per_port[stat.port_no] = _PortSample(
                    now, stat.rx_packets, stat.rx_bytes, stat.tx_packets, stat.tx_bytes
                )
                continue

            dt = now - last.timestamp
            if dt <= 0:
                continue
            rx_pps = (stat.rx_packets - last.rx_packets) / dt
            rx_bps = (stat.rx_bytes - last.rx_bytes) / dt
            tx_pps = (stat.tx_packets - last.tx_packets) / dt
            tx_bps = (stat.tx_bytes - last.tx_bytes) / dt

            # TSV stream, same columns as the reference (monitor.py:87-88)
            log.info(
                "%016x\t%d\t%d\t%d\t%d\t%d",
                dpid,
                stat.port_no,
                rx_pps,
                rx_bps,
                tx_pps,
                tx_bps,
            )
            _m_samples.inc()
            self.bus.publish(
                ev.EventPortStats(dpid, stat.port_no, rx_pps, rx_bps, tx_pps, tx_bps)
            )

            per_port[stat.port_no] = _PortSample(
                now, stat.rx_packets, stat.rx_bytes, stat.tx_packets, stat.tx_bytes
            )

    #: datapaths polled per event-loop slice in the async loop
    POLL_SLICE = 64

    async def run(self) -> None:
        """Asyncio polling loop (CLI profile with monitoring enabled).

        The pass over datapaths is sliced: control returns to the event
        loop every POLL_SLICE switches, so a 1,000-switch fabric cannot
        starve the RPC mirror or packet handling for a whole sampling
        pass. Slicing (not a worker thread) keeps the single-threaded
        bus discipline — handlers never run concurrently (SURVEY §5
        race-discipline equivalent)."""
        import asyncio

        log.debug("Starting monitor loop")
        loop = asyncio.get_running_loop()
        while True:
            started = loop.time()
            for i, dpid in enumerate(sorted(self.datapaths)):
                if dpid not in self.datapaths:
                    continue  # went down while we were yielding
                self._poll_one(dpid, time.time())
                if (i + 1) % self.POLL_SLICE == 0:
                    await asyncio.sleep(0)
            # one vectorized utilization flush per pass (see poll())
            _m_passes.inc()
            self.bus.publish(ev.EventStatsFlush())
            elapsed = loop.time() - started
            await asyncio.sleep(
                max(0.0, self.config.monitor_interval - elapsed)
            )

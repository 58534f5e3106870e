"""Open-loop multi-tenant load harness driver.

"Millions of users" is a throughput and tail-latency problem, and an
honest tail needs an **open-loop** generator: arrivals are scheduled
from the offered rate alone, never gated on completions, so when the
controller falls behind the schedule the backlog shows up as queueing
delay in every later sample instead of silently throttling the load
(the coordinated-omission trap a closed-loop driver falls into). Each
request's latency is ``completion_wall - scheduled_arrival``, measured
against the run's virtual schedule.

The driver fires packet-ins at a LIVE controller — the same bus, the
same coalescer windows, the same pipelined install plane and (wire
mode) the same byte codec a real deployment exercises — and reports
per-tenant routes/s and p50/p99/p999. Tenants come in two kinds
matching the Router's two-class coalescer queue:

- ``unicast`` — latency-sensitive single-pair lookups (plain ethernet
  packet-ins between the tenant's hosts);
- ``alltoall`` — bulk MPI pair storms: every ordered rank pair of the
  tenant's ranks as a reactive vMAC packet-in (the reference's serving
  model — one packet-in per pair), cycled for the run's duration.

Completion detection leans on the bus being synchronous: a published
packet-in either parks in the coalescer, is rejected at the admission
gate (visible as a per-tenant rejection-counter delta around the
publish), or completes inline (direct path / a high-water flush inside
the publish). Parked requests complete when the flush the driver ticks
(standing in for the fabric's idle edge) returns with the queue empty.

Counterpart of ``sdnmpi_tpu/control/loadgen.py``, host code copied with
its imports rewritten.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from sdnmpi_tpu_torch.protocol import openflow as of
from sdnmpi_tpu_torch.protocol.vmac import CollectiveType, VirtualMac


@dataclasses.dataclass
class TenantSpec:
    """One tenant's offered load.

    ``rate`` is requests per second, open-loop. ``kind`` selects the
    traffic shape (see module docstring). ``macs`` are the tenant's
    hosts (unicast pairs / MPI ranks in order); ``ranks`` maps position
    -> registered rank id for ``alltoall`` tenants."""

    name: str
    rate: float
    n_requests: int
    kind: str = "unicast"  # "unicast" | "alltoall"
    macs: tuple = ()
    ranks: tuple = ()


@dataclasses.dataclass
class TenantReport:
    tenant: str
    offered: int
    completed: int
    rejected: int
    routes_per_s: float
    p50_ms: float
    p99_ms: float
    p999_ms: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _percentiles(lat_s: list) -> tuple[float, float, float]:
    if not lat_s:
        return 0.0, 0.0, 0.0
    arr = np.asarray(lat_s) * 1e3
    p50, p99, p999 = np.percentile(arr, (50, 99, 99.9))
    return float(p50), float(p99), float(p999)


def register_ranks(fabric, config, macs) -> list[int]:
    """Register ``macs`` as MPI ranks 0..n-1 through the real
    announcement path (LAUNCH broadcasts, exactly like a job launcher
    would — reference: sdnmpi/process.py:53-119). Returns the ranks."""
    from sdnmpi_tpu_torch.protocol.announcement import Announcement, AnnouncementType

    ranks = list(range(len(macs)))
    for rank, mac in zip(ranks, macs):
        fabric.hosts[mac].send(of.Packet(
            eth_src=mac,
            eth_dst="ff:ff:ff:ff:ff:ff",
            eth_type=of.ETH_TYPE_IP,
            ip_proto=of.IPPROTO_UDP,
            udp_dst=config.announcement_port,
            payload=Announcement(AnnouncementType.LAUNCH, rank).encode(),
        ))
    return ranks


class LoadGen:
    """Drive a live controller with an open-loop multi-tenant schedule.

    ``run`` owns one run: it pre-builds the merged arrival schedule,
    replays it against the bus (never skipping a late arrival — the
    lateness IS the measurement), ticks the coalescer flush as the idle
    edge, and returns ``{tenant: TenantReport}``."""

    def __init__(self, controller, fabric, tick_s: float = 0.002) -> None:
        self.controller = controller
        self.fabric = fabric
        #: idle-edge cadence: arrivals due within one tick inject
        #: back-to-back, then one flush drains the window — the sim
        #: stand-in for the southbound's burst-drained idle callback
        self.tick_s = tick_s

    # -- schedule ----------------------------------------------------------

    def _requests_for(self, t: TenantSpec) -> list[tuple]:
        """The tenant's request stream: ``(dpid, in_port, pkt)`` tuples
        cycled over its pair set, deterministic per spec."""
        hosts = self.fabric.hosts
        out = []
        if t.kind == "unicast":
            pairs = [
                (a, b) for a in t.macs for b in t.macs if a != b
            ]
            for i in range(t.n_requests):
                src, dst = pairs[i % len(pairs)]
                h = hosts[src]
                out.append((h.dpid, h.port_no, of.Packet(
                    eth_src=src, eth_dst=dst, payload=b"lg",
                )))
        elif t.kind == "alltoall":
            ranks = t.ranks or tuple(range(len(t.macs)))
            pairs = [
                (i, j)
                for i in range(len(ranks))
                for j in range(len(ranks))
                if i != j
            ]
            for i in range(t.n_requests):
                si, di = pairs[i % len(pairs)]
                src = t.macs[si]
                vmac = VirtualMac(
                    CollectiveType.ALLTOALL, ranks[si], ranks[di]
                ).encode()
                h = hosts[src]
                out.append((h.dpid, h.port_no, of.Packet(
                    eth_src=src, eth_dst=vmac, eth_type=of.ETH_TYPE_IP,
                )))
        else:
            raise ValueError(f"unknown tenant kind {t.kind!r}")
        return out

    def schedule(self, tenants: list[TenantSpec]) -> list[tuple]:
        """Merged open-loop arrival schedule:
        ``(sched_t, tenant_name, dpid, in_port, pkt)`` sorted by time.
        Per-tenant arrivals are uniform at the offered rate, phase-
        shifted per tenant so same-rate tenants interleave instead of
        colliding on every tick."""
        events = []
        for k, t in enumerate(tenants):
            gap = 1.0 / t.rate if t.rate > 0 else 0.0
            phase = gap * (k + 1) / (len(tenants) + 1)
            reqs = self._requests_for(t)
            for i, (dpid, port, pkt) in enumerate(reqs):
                events.append((phase + i * gap, t.name, dpid, port, pkt))
        events.sort(key=lambda e: e[0])
        return events

    # -- run ---------------------------------------------------------------

    def run(
        self,
        tenants: list[TenantSpec],
        pace: bool = True,
        now: Optional[callable] = None,
    ) -> dict[str, TenantReport]:
        """Replay the merged schedule; returns per-tenant reports.

        ``pace=False`` injects as fast as the controller drains
        (saturation mode, for throughput ceilings). Latency anchors to
        the scheduled arrival when pacing — lateness against the
        schedule IS the open-loop queueing measurement — and to the
        injection instant in saturation mode, where the schedule is
        deliberately outrun and only time-in-system is meaningful."""
        from sdnmpi_tpu_torch.control import events as ev

        router = self.controller.router
        bus = self.controller.bus
        admission = router.admission
        for t in tenants:
            # bind the tenant's MACs to its NAME unconditionally: the
            # completion accounting below attributes rejections by
            # reading the per-tenant counter around each publish, and
            # an unassigned MAC would reject under its own label —
            # turning every drop into a phantom "completed" route
            for mac in t.macs:
                admission.assign(mac, t.name)
            if t.kind == "alltoall":
                # a vMAC pair whose rank never registered is dropped
                # SILENTLY by the Router (unresolved rank) — that is a
                # harness misconfiguration, not load, so fail loudly
                # instead of corrupting the report
                for rank in t.ranks or range(len(t.macs)):
                    if not bus.request(
                        ev.RankResolutionRequest(int(rank))
                    ).mac:
                        raise ValueError(
                            f"tenant {t.name!r}: rank {rank} is not "
                            "registered (run register_ranks first)"
                        )
        events = self.schedule(tenants)
        lat: dict[str, list] = {t.name: [] for t in tenants}
        rejected: dict[str, int] = {t.name: 0 for t in tenants}
        outstanding: list[tuple[str, float]] = []

        clock = time.perf_counter if now is None else now
        t0 = clock()

        # SLO plane feed: the harness owns the arrival
        # schedule, so IT measures the latency a tenant experiences —
        # schedule-anchored lateness, queueing-before-park included
        # (the open-loop half the Router's park-to-install feed cannot
        # see). While the run drives, the harness takes OWNERSHIP of
        # its tenants' feed (slo.harness_feed) so the Router does not
        # also record a park-to-install sample per served request —
        # double-counted good observations would halve the burn
        # fraction. None when the controller has no SLO plane.
        slo = getattr(self.controller, "slo", None)
        fed: set = set()
        if slo is not None:
            fed = {t.name for t in tenants} - slo.harness_feed
            slo.harness_feed |= fed

        def drain(t_done: float) -> None:
            if outstanding and not router._pending:
                for name, sched_t in outstanding:
                    lat[name].append(t_done - sched_t)
                    if slo is not None:
                        slo.observe(name, t_done - sched_t)
                outstanding.clear()

        try:
            for sched_t, name, dpid, port, pkt in events:
                if pace:
                    ahead = sched_t - (clock() - t0)
                    if ahead > 0:
                        # flush whatever is parked before going idle:
                        # the real fabric's idle edge fires between
                        # bursts
                        if router._pending:
                            router.flush_routes()
                        drain(clock() - t0)
                        time.sleep(ahead)
                rej0 = admission.rejections(name)
                t_inject = clock() - t0
                bus.publish(
                    ev.EventPacketIn(dpid, port, pkt, of.OFP_NO_BUFFER)
                )
                t_now = clock() - t0
                if admission.rejections(name) > rej0:
                    rejected[name] += 1
                else:
                    outstanding.append(
                        (name, sched_t if pace else t_inject)
                    )
                # a high-water flush inside the publish (or the direct
                # uncoalesced path) completed everything parked so far
                drain(t_now)
                if router._pending and (
                    t_now - sched_t >= self.tick_s or not pace
                ):
                    router.flush_routes()
                    drain(clock() - t0)
            if router._pending:
                router.flush_routes()
            drain(clock() - t0)
        finally:
            if slo is not None:
                slo.harness_feed -= fed
        elapsed = max(clock() - t0, 1e-9)

        reports = {}
        for t in tenants:
            p50, p99, p999 = _percentiles(lat[t.name])
            reports[t.name] = TenantReport(
                tenant=t.name,
                offered=t.n_requests,
                completed=len(lat[t.name]),
                rejected=rejected[t.name],
                routes_per_s=len(lat[t.name]) / elapsed,
                p50_ms=p50, p99_ms=p99, p999_ms=p999,
            )
        return reports

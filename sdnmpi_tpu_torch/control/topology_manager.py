"""Topology manager app.

Equivalent of the reference's ``TopologyManager``
(reference: sdnmpi/topology.py:59-202): owns the TopologyDB, ingests
discovery events, installs per-switch bootstrap flows (broadcast ->
controller at the broadcast priority; IPv6-multicast drop installed
reactively), answers route queries, and performs controlled network-wide
broadcasts out of edge ports only.

Upgrades over the reference:
- ``FindAllRoutesRequest`` works (the reference's was dead-broken,
  topology.py:48,147).
- ``FindRoutesBatchRequest`` resolves a whole collective's pairs in one
  oracle call.
- Per-link utilization (fed by the Monitor's EventPortStats) is kept here
  beside the topology, ready for congestion-aware scoring.

Counterpart of ``sdnmpi_tpu/control/topology_manager.py`` on the port's
oracle: the TopologyDB runs backend ``"torch"`` on ``Config.device``, and
with ``Config.util_plane`` (the default) the Monitor's samples also
stage into the device utilization plane (``oracle/utilplane.py``) that
the oracle's balanced, adaptive and collective calls read.
"""

from __future__ import annotations

import logging

from sdnmpi_tpu_torch.config import Config, DEFAULT_CONFIG
from sdnmpi_tpu_torch.control import events as ev
from sdnmpi_tpu_torch.control.bus import EventBus
from sdnmpi_tpu_torch.core.topology_db import TopologyDB
from sdnmpi_tpu_torch.protocol import openflow as of
from sdnmpi_tpu_torch.utils.mac import BROADCAST_MAC, is_ipv6_multicast
from sdnmpi_tpu_torch.utils.metrics import REGISTRY

log = logging.getLogger("TopologyManager")

# device-side congestion analytics: one jitted top-k pass per
# EventStatsFlush over the published utilization plane, decoded to the
# report served by CongestionReportRequest; these gauges are the
# scrape-able headline figures
_m_hot_bps = REGISTRY.gauge(
    "congestion_hot_link_bps",
    "measured bps of the fabric's hottest directed link (device top-k "
    "pass per Monitor flush)",
)
_m_hot_collectives = REGISTRY.gauge(
    "congestion_hot_collectives",
    "installed collectives whose routed blocks ride a current top-k hot "
    "link",
)
_m_host_sampled = REGISTRY.gauge(
    "congestion_host_sampled",
    "1 when the congestion report is served from the Monitor's host "
    "samples (Config.hier_oracle skips the dense device UtilPlane), "
    "0 when the jitted device top-k pass serves it",
)


class TopologyManager:
    name = "TopologyManager"

    def __init__(
        self,
        bus: EventBus,
        southbound,
        config: Config = DEFAULT_CONFIG,
    ) -> None:
        self.bus = bus
        self.southbound = southbound
        self.config = config
        self.topologydb = TopologyDB(
            backend=config.oracle_backend,
            device=config.device,
            pad_multiple=config.switch_pad_multiple,
            max_diameter=config.max_diameter,
            mesh_devices=config.mesh_devices,
            shard_oracle=config.shard_oracle,
            ring_exchange=config.ring_exchange,
            delta_repair_threshold=config.delta_repair_threshold,
            route_cache=config.route_cache,
            route_cache_max_entries=config.route_cache_max_entries,
            hier_oracle=config.hier_oracle,
            hier_pod_target=config.hier_pod_target,
            hier_fused=config.hier_fused,
            hier_warm=config.hier_warm,
        )
        #: (src_dpid, src_port) -> latest utilization of that directed
        #: link in bps: max of the sender's tx stream and the receiver's
        #: rx stream (the reference logs both, sdnmpi/monitor.py:79-88;
        #: ingesting both means a one-sided counter stall cannot hide a
        #: hot link). Pruned when links/switches leave, so a dead link's
        #: last sample can never keep biasing the congestion base.
        self.link_util: dict[tuple[int, int], float] = {}
        self._tx_util: dict[tuple[int, int], float] = {}
        self._rx_util: dict[tuple[int, int], float] = {}
        #: device-resident twin of link_util (oracle/utilplane.py):
        #: samples stage here too and flush to a persistent [V, V]
        #: tensor once per Monitor pass, so the oracle's base cost needs
        #: no per-call host rebuild. The host dict stays authoritative
        #: for snapshots and RPC. None on the pure-Python backend, under
        #: the hierarchical oracle, or when Config.util_plane is off.
        self.util_plane = None
        if (
            config.oracle_backend == "torch" and config.util_plane
            and not config.hier_oracle
        ):
            from sdnmpi_tpu_torch.oracle.utilplane import UtilPlane

            self.util_plane = UtilPlane(
                config.util_ewma_alpha,
                stale_horizon_s=config.util_stale_horizon_s,
            )
        #: (dst_dpid, dst_port) -> (src_dpid, src_port) of the directed
        #: link arriving there, for attributing rx samples
        self._link_rev: dict[tuple[int, int], tuple[int, int]] = {}

        bus.subscribe(ev.EventDatapathUp, self._datapath_up)
        bus.subscribe(ev.EventSwitchEnter, lambda e: self.topologydb.add_switch(e.switch))
        bus.subscribe(ev.EventPortAdd, lambda e: self.topologydb.add_switch(e.switch))
        bus.subscribe(ev.EventSwitchLeave, self._switch_leave)
        bus.subscribe(ev.EventPortDelete, self._port_delete)
        bus.subscribe(ev.EventLinkAdd, self._link_add)
        bus.subscribe(ev.EventLinkDelete, self._link_delete)
        bus.subscribe(ev.EventHostAdd, lambda e: self.topologydb.add_host(e.host))
        bus.subscribe(ev.EventPacketIn, self._packet_in)
        bus.subscribe(ev.EventPortStats, self._port_stats)
        bus.subscribe(ev.EventStatsFlush, self._stats_flush)

        bus.provide(ev.CurrentTopologyRequest, self._current_topology)
        bus.provide(ev.FindRouteRequest, self._find_route)
        bus.provide(ev.FindAllRoutesRequest, self._find_all_routes)
        bus.provide(ev.FindRoutesBatchRequest, self._find_routes_batch)
        bus.provide(ev.DispatchRoutesBatchRequest, self._dispatch_routes_batch)
        bus.provide(ev.UtilEpochRequest, self._util_epoch)
        bus.provide(ev.FindCollectiveRoutesRequest, self._find_routes_collective)
        bus.provide(ev.BroadcastRequest, self._broadcast_request)
        bus.provide(ev.CongestionReportRequest, self._congestion_report)

        #: latest device-side congestion analytics: refreshed
        #: per EventStatsFlush once the utilization plane is bound;
        #: served over the bus / mirrored into the telemetry snapshot
        self.congestion: dict = {}
        #: fabric audit plane (wired by the Controller): its
        #: per-flow byte attribution becomes the congestion report's
        #: measured-vs-modeled block. None = no measured column.
        self.audit = None

    # -- bootstrap flows (reference: sdnmpi/topology.py:94-108) -----------

    def _datapath_up(self, event: ev.EventDatapathUp) -> None:
        mod = of.FlowMod(
            match=of.Match(dl_dst=BROADCAST_MAC),
            actions=(of.ActionOutput(of.OFPP_CONTROLLER),),
            priority=self.config.priority_broadcast,
        )
        self.southbound.flow_mod(event.dpid, mod)

    def _install_multicast_drop(self, dpid: int, dst: str) -> None:
        # reactive drop rule for IPv6 multicast (reference: topology.py:82-92)
        mod = of.FlowMod(
            match=of.Match(dl_dst=dst),
            actions=(),
            priority=self.config.priority_control,
        )
        self.southbound.flow_mod(dpid, mod)

    # -- packet-in (reference: sdnmpi/topology.py:110-131) ----------------

    def _packet_in(self, event: ev.EventPacketIn) -> None:
        dst = event.pkt.eth_dst
        if is_ipv6_multicast(dst):
            self._install_multicast_drop(event.dpid, dst)
            return
        if dst != BROADCAST_MAC:
            return
        # announcement packets belong to the ProcessManager
        if event.pkt.udp_dst == self.config.announcement_port:
            return
        self._do_broadcast(event.pkt, event.dpid, event.in_port)

    # -- request handlers -------------------------------------------------

    def _current_topology(self, req: ev.CurrentTopologyRequest) -> ev.CurrentTopologyReply:
        return ev.CurrentTopologyReply(self.topologydb)

    def _find_route(self, req: ev.FindRouteRequest) -> ev.FindRouteReply:
        return ev.FindRouteReply(self.topologydb.find_route(req.src_mac, req.dst_mac))

    def _find_all_routes(self, req: ev.FindAllRoutesRequest) -> ev.FindAllRoutesReply:
        fdbs, truncated = self.topologydb.find_all_routes(
            req.src_mac, req.dst_mac,
            max_paths=self.config.max_enumerated_paths,
        )
        return ev.FindAllRoutesReply(fdbs, truncated)

    def _find_routes_batch(
        self, req: ev.FindRoutesBatchRequest
    ) -> ev.FindRoutesBatchReply:
        if req.policy == "balanced":
            fdbs, max_congestion = self.topologydb.find_routes_batch_balanced(
                req.pairs,
                link_util=self.routing_util(),
                alpha=self.config.congestion_alpha,
                chunk=self.config.ecmp_chunk,
                link_capacity=self.config.link_capacity_bps,
                ecmp_ways=self.config.ecmp_ways,
                rounds=self.config.balance_rounds,
                dag_threshold=self.config.dag_flow_threshold,
            )
            return ev.FindRoutesBatchReply(fdbs, max_congestion)
        if req.policy == "adaptive":
            fdbs, n_detours, max_congestion = (
                self.topologydb.find_routes_batch_adaptive(
                    req.pairs,
                    link_util=self.routing_util(),
                    ugal_candidates=self.config.ugal_candidates,
                    ugal_bias=self.config.ugal_bias,
                    alpha=self.config.congestion_alpha,
                    link_capacity=self.config.link_capacity_bps,
                    ecmp_ways=self.config.ecmp_ways,
                )
            )
            if n_detours:
                log.info("UGAL detoured %d of %d pairs", n_detours, len(req.pairs))
            return ev.FindRoutesBatchReply(fdbs, max_congestion)
        if req.policy != "shortest":
            log.warning(
                "unknown routing policy %r: falling back to shortest-path",
                req.policy,
            )
        return ev.FindRoutesBatchReply(self.topologydb.find_routes_batch(req.pairs))

    def _dispatch_routes_batch(
        self, req: ev.DispatchRoutesBatchRequest
    ) -> ev.DispatchRoutesBatchReply:
        """Split-phase leg of _find_routes_batch: launch, don't decode.
        Policy knobs are resolved from config exactly like the blocking
        handler, so a dispatched window routes identically to the same
        pairs through FindRoutesBatchRequest."""
        cfg = self.config
        if req.dirty is not None and req.policy == "shortest":
            # delta-narrowed churn re-scoring: the dirty set rides to
            # the oracle as a mask tensor and the window's touched
            # array feeds the drain-attribution telemetry
            # (control/router.py router_reval_flows_drained_total)
            return ev.DispatchRoutesBatchReply(
                self.topologydb.find_routes_batch_delta_dispatch(
                    req.pairs, req.dirty
                )
            )
        kwargs = {}
        if req.policy == "balanced":
            kwargs = dict(
                link_util=self.routing_util(),
                alpha=cfg.congestion_alpha,
                chunk=cfg.ecmp_chunk,
                link_capacity=cfg.link_capacity_bps,
                ecmp_ways=cfg.ecmp_ways,
                rounds=cfg.balance_rounds,
                dag_threshold=cfg.dag_flow_threshold,
            )
        elif req.policy == "adaptive":
            kwargs = dict(
                link_util=self.routing_util(),
                ugal_candidates=cfg.ugal_candidates,
                ugal_bias=cfg.ugal_bias,
                alpha=cfg.congestion_alpha,
                link_capacity=cfg.link_capacity_bps,
                ecmp_ways=cfg.ecmp_ways,
            )
        return ev.DispatchRoutesBatchReply(
            self.topologydb.find_routes_batch_dispatch(
                req.pairs, policy=req.policy, **kwargs
            )
        )

    def _util_epoch(self, req: ev.UtilEpochRequest) -> ev.UtilEpochReply:
        return ev.UtilEpochReply(
            self.util_plane.epoch if self.util_plane is not None else 0
        )

    def _find_routes_collective(
        self, req: ev.FindCollectiveRoutesRequest
    ) -> ev.FindCollectiveRoutesReply:
        cfg = self.config
        kwargs = dict(
            link_util=self.routing_util(),
            alpha=cfg.congestion_alpha,
            link_capacity=cfg.link_capacity_bps,
            ecmp_ways=cfg.ecmp_ways,
            rounds=cfg.balance_rounds,
        )
        if req.policy == "adaptive":
            kwargs["ugal_candidates"] = cfg.ugal_candidates
            kwargs["ugal_bias"] = cfg.ugal_bias
        if req.schedule is not None:
            # phase-scheduler leg: the reply's routes is a
            # PhasedFlowProgram with every phase's device program
            # already dispatched — the Router reaps and installs phase
            # k while phases k+1..K compute
            return ev.FindCollectiveRoutesReply(
                self.topologydb.find_routes_collective_phased(
                    req.macs, req.src_idx, req.dst_idx,
                    policy=req.policy, n_phases=int(req.schedule),
                    **kwargs,
                )
            )
        routes = self.topologydb.find_routes_collective(
            req.macs, req.src_idx, req.dst_idx, policy=req.policy, **kwargs
        )
        return ev.FindCollectiveRoutesReply(routes)

    def _broadcast_request(self, req: ev.BroadcastRequest) -> ev.BroadcastReply:
        self._do_broadcast(req.pkt, req.src_dpid, req.src_in_port)
        return ev.BroadcastReply()

    # -- broadcast (reference: sdnmpi/topology.py:150-177) ----------------

    def _do_broadcast(self, pkt: of.Packet, src_dpid: int, src_in_port: int) -> None:
        """Flood to every edge port in the network — any switch port
        without an inter-switch link (and below the reserved range) —
        excluding the ingress port, exactly the reference's flood set
        (topology.py:157-177, ``_is_edge_port`` at :163-168). Flooding
        only *discovered-host* ports would strand a host that has never
        sent a packet: it could never receive the broadcast that
        bootstraps it."""
        for dpid in sorted(self.topologydb.switches):
            switch = self.topologydb.switches[dpid]
            inter = {
                link.src.port_no
                for link in self.topologydb.links.get(dpid, {}).values()
            }
            ports = sorted(
                p.port_no
                for p in getattr(switch, "ports", [])
                if p.port_no not in inter and p.port_no < of.OFPP_MAX
            )
            if dpid == src_dpid:
                ports = [p for p in ports if p != src_in_port]
            if not ports:
                continue
            actions = tuple(of.ActionOutput(p) for p in ports)
            self.southbound.packet_out(dpid, of.PacketOut(data=pkt, actions=actions))

    # -- discovery ingest + utilization hygiene ---------------------------

    def _link_add(self, event) -> None:
        link = event.link
        self.topologydb.add_link(link)
        self._link_rev[(link.dst.dpid, link.dst.port_no)] = (
            link.src.dpid, link.src.port_no,
        )

    def _link_delete(self, event) -> None:
        link = event.link
        self.topologydb.delete_link(link)
        self._link_rev.pop((link.dst.dpid, link.dst.port_no), None)
        self._drop_util((link.src.dpid, link.src.port_no))

    def _switch_leave(self, event) -> None:
        dpid = event.switch.dp.id
        # a southbound that only reports the disconnect (a real OF
        # channel drop, control/southbound.py) leaves the dead switch's
        # links in the DB — prune them through the normal delete events
        # so the RPC mirror and flow revalidation fire. The simulated
        # fabric already published these (control/fabric.py
        # remove_switch), in which case nothing is left to prune.
        self._prune_links(
            lambda link: dpid in (link.src.dpid, link.dst.dpid)
        )
        self.topologydb.delete_switch(event.switch)
        for key in [k for k in self.link_util if k[0] == dpid]:
            self._drop_util(key)
        self._link_rev = {
            d: s for d, s in self._link_rev.items()
            if d[0] != dpid and s[0] != dpid
        }

    def _port_delete(self, event) -> None:
        """A port died (real southbound's OFPT_PORT_STATUS delete /
        link-down): prune every link riding it, and drop it from the
        switch's port set — a dead port with no links would otherwise
        read as an edge port and receive every broadcast."""
        key = (event.dpid, event.port_no)
        self._prune_links(
            lambda link: (link.src.dpid, link.src.port_no) == key
            or (link.dst.dpid, link.dst.port_no) == key
        )
        self._drop_util(key)
        sw = self.topologydb.switches.get(event.dpid)
        if sw is not None:
            from sdnmpi_tpu_torch.core.topology_db import Switch

            self.topologydb.add_switch(Switch.make(
                event.dpid,
                [p for p in sw.ports if p.port_no != event.port_no],
            ))

    def _prune_links(self, dead) -> None:
        stale = [
            link
            for dst_map in self.topologydb.links.values()
            for link in dst_map.values()
            if dead(link)
        ]
        for link in stale:
            self.bus.publish(ev.EventLinkDelete(link))
        if stale:
            self.bus.publish(ev.EventTopologyChanged())

    def _drop_util(self, key: tuple[int, int]) -> None:
        self.link_util.pop(key, None)
        self._tx_util.pop(key, None)
        self._rx_util.pop(key, None)
        if self.util_plane is not None:
            # staged-but-unflushed samples die with the link; the
            # device slot itself is zeroed through the delta-log repair
            # seam on the plane's next sync
            self.util_plane.drop(key)

    # -- utilization ingest -----------------------------------------------

    def routing_util(self):
        """The utilization input the oracle receives: the device plane
        when enabled, the raw host dict otherwise."""
        return self.util_plane if self.util_plane is not None else self.link_util

    def restore_link_util(self, samples: dict[tuple[int, int], float]) -> None:
        """Checkpoint restore: seed the host dict AND stage the device
        plane, so a resumed controller routes on warm utilization
        without waiting a Monitor interval."""
        self.link_util.update(samples)
        if self.util_plane is not None:
            for key, bps in samples.items():
                self.util_plane.stage(key, bps)

    def _stats_flush(self, event: ev.EventStatsFlush) -> None:
        """Monitor end-of-pass edge: one vectorized scatter of the
        pass's staged samples into the device plane, then one jitted
        congestion-analytics pass over the published epoch. Before the
        plane is bound (no routing call has built tensors yet) samples
        simply stay staged — the first base-cost evaluation flushes
        them. Under ``Config.hier_oracle`` there deliberately IS no
        device plane (the dense [V, V] tensor is the ceiling hier
        escapes) — the congestion report is served from the same host
        sample dict the hier composer steers on instead of staying
        silently empty."""
        p = self.util_plane
        if p is not None:
            if p.sync(self.topologydb):
                p.flush()
                self._refresh_congestion()
        elif (
            self.config.hier_oracle
            and self.config.util_plane
            and self.config.oracle_backend == "torch"
        ):
            self._refresh_congestion_host()

    def _congestion_report(
        self, req: ev.CongestionReportRequest
    ) -> ev.CongestionReportReply:
        return ev.CongestionReportReply(self.congestion)

    def _refresh_congestion(self) -> None:
        """Device-side congestion analytics, one pass per
        flush: top-k hot links (jitted top-k over the published [V*V]
        snapshot — fixed shape, zero recompiles across churn), the
        per-collective attribution (which installed collectives' blocks
        ride those links, via the install-time directed-link index),
        and the oracle's discrete-vs-fractional congestion figures."""
        p = self.util_plane
        if p is None or not p.bound:
            return
        hot = p.hot_links(self.config.congestion_topk)
        _m_host_sampled.set(0.0)
        self.congestion = self._assemble_congestion(hot, epoch=p.epoch)

    def _refresh_congestion_host(self) -> None:
        """Congestion analytics under the hierarchical oracle: hier deliberately skips the dense device UtilPlane,
        so the top-k pass runs over the Monitor's HOST sample dict —
        the exact view the hier composer's border steering consumes —
        and the report additionally aggregates per POD (the granularity
        hier routes at). The dict is host-sized (one entry per live
        directed link), so a host sort is the right tool here; the
        report shape matches the device path's, plus ``pods`` and
        ``source`` so consumers can tell which pass served it."""
        samples = self.link_util
        if not samples:
            return
        import heapq

        db = self.topologydb
        k = max(1, int(self.config.congestion_topk))
        # O(E log k) selection, and the dst side resolves only for the
        # k winners by scanning their OWN switch's link dict — never an
        # O(E) map rebuild per flush (hier exists for 65k-switch
        # fabrics; this runs on every Monitor pass)
        top = heapq.nlargest(k, samples.items(), key=lambda kv: kv[1])
        hot = [
            {
                "src": dpid,
                "dst": next(
                    (d for d, link in db.links.get(dpid, {}).items()
                     if link.src.port_no == port),
                    -1,
                ),
                "port": port, "bps": float(bps),
            }
            for (dpid, port), bps in top
            if bps > 0.0
        ]
        # pod aggregation: per-pod egress load (the per-switch sums the
        # hier steering folds, aggregated one level up), hottest first.
        # The PodMap is the DB's annotation when the generator emitted
        # one, else the partitioner map the hier oracle resolved at its
        # last refresh (discovered fabrics); before any refresh there
        # is no pod structure yet and the block is skipped.
        pods: list[dict] = []
        podmap = getattr(db, "podmap", None)
        if podmap is None:
            oracle = getattr(db, "_oracle", None)
            podmap = getattr(
                getattr(oracle, "_hier", None), "podmap", None
            )
        if podmap is not None:
            by_pod: dict[int, float] = {}
            for (dpid, _port), bps in samples.items():
                pod = podmap.pod_of.get(dpid)
                if pod is not None and bps > 0.0:
                    by_pod[pod] = by_pod.get(pod, 0.0) + float(bps)
            pods = [
                {"pod": p, "bps": round(v, 3)}
                for p, v in sorted(by_pod.items(), key=lambda kv: -kv[1])
            ][:k]
        _m_host_sampled.set(1.0)
        report = self._assemble_congestion(hot, epoch=0)
        report["source"] = "host_samples"
        if pods:
            report["pods"] = pods
        self.congestion = report

    def _assemble_congestion(self, hot: list[dict], epoch: int) -> dict:
        """Assemble the congestion block from decoded top-k entries:
        headline gauges, per-collective (and per-phase) attribution
        through the install-time link index, and the oracle's same-
        batch discrete/fractional figures. Shared by the device top-k
        pass and the hier host-sample pass so the two report shapes
        can never drift."""
        _m_hot_bps.set(hot[0]["bps"] if hot else 0.0)
        colls: list[dict] = []
        if hot:
            try:
                table = self.bus.request(
                    ev.CurrentCollectivesRequest()
                ).collectives
            except LookupError:
                table = ()  # minimal stacks without a Router
            hot_keys = {(h["src"], h["dst"]): h["bps"] for h in hot}
            for install in table:
                if not install.links:
                    continue
                ride = [k for k in hot_keys if k in install.links]
                if ride:
                    entry = {
                        "cookie": install.cookie,
                        "coll_type": install.coll_type,
                        "n_pairs": install.n_pairs,
                        "hot_links": len(ride),
                        "bps": sum(hot_keys[k] for k in ride),
                    }
                    # phase-grain attribution: a scheduled
                    # install resolves the hot link not just to the
                    # collective but to the PHASE(S) riding it
                    if install.phase_links is not None:
                        phases = sorted({
                            p for k in ride
                            for p in install.phase_links.get(k, ())
                        })
                        entry["n_phases"] = install.n_phases
                        entry["phases"] = phases
                    colls.append(entry)
            colls.sort(key=lambda c: -c["bps"])
        _m_hot_collectives.set(len(colls))
        oracle = getattr(self.topologydb, "_oracle", None)
        report = {
            "epoch": epoch,
            "top": hot,
            "collectives": colls,
            "discrete_max": getattr(
                oracle, "last_discrete_congestion", 0.0
            ),
            "fractional_max": getattr(
                oracle, "last_fractional_congestion", 0.0
            ),
            # the oracle only records a ratio when both figures came
            # from the SAME DAG-balanced batch — recomputing it here
            # would pair a later shortest/greedy pass's discrete figure
            # with a stale fractional bound
            "ratio": getattr(oracle, "last_congestion_ratio", 0.0),
        }
        if self.audit is not None:
            # measured-vs-modeled: the audit plane's per-flow
            # byte attribution beside every install's modeled congestion
            # — the fabric's observed truth against the scheduler's model
            report["measured"] = self.audit.report()
        return report

    def _port_stats(self, event: ev.EventPortStats) -> None:
        key = (event.dpid, event.port_no)
        self._tx_util[key] = event.tx_bps
        self._refresh_util(key)
        # the rx counter of this port measures the link ARRIVING here;
        # credit it to that link's source side (reference rx logging:
        # sdnmpi/monitor.py:79-88)
        src = self._link_rev.get(key)
        if src is not None:
            self._rx_util[src] = event.rx_bps
            self._refresh_util(src)

    def _refresh_util(self, key: tuple[int, int]) -> None:
        value = max(
            self._tx_util.get(key, 0.0), self._rx_util.get(key, 0.0)
        )
        self.link_util[key] = value
        if self.util_plane is not None:
            self.util_plane.stage(key, value)

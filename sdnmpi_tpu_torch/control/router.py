"""Router app — packet-in dispatcher and flow installer.

Equivalent of the reference's ``Router`` (reference: sdnmpi/router.py:37-195):
filters LLDP/broadcast/IPv6-multicast packet-ins, routes normal unicast via
``FindRouteRequest``, decodes SDN-MPI virtual MACs and resolves ranks for
MPI packets, installs one flow per hop with de-duplication against the
SwitchFDB, rewrites virtual -> real destination MAC on the last hop, sends
the triggering packet out of the ingress switch, and falls back to a
controlled broadcast when no route exists.

Upgrade over the reference: flow lifecycle management. The reference
installs permanent flows and never removes them (SURVEY §2 defects — stale
routes survive link failures and process exits). Here, topology mutations
trigger revalidation of every installed (src, dst) flow against a fresh
oracle batch — stale hops are deleted from the switches, surviving routes
are eagerly reinstalled along their new path — and an MPI process exit
tears down the flows addressed to its rank's virtual MAC.

Counterpart of ``sdnmpi_tpu/control/router.py`` on the port's oracle:
the window path installs the oracle's ``WindowRoutes`` arrays as the
reference does, and a collective of at least
``Config.block_install_threshold`` pairs takes the block install, whose
routes come from one ``find_routes_collective`` call (kernel K2's set-up
and K2 on the balanced and adaptive policies). A topology change
revalidates by the delta-narrowed leg (``Config.delta_reval``, the
oracle's in-place repair), and with ``Config.schedule_collectives`` a
block-installed collective installs phase by phase (``sched/``).
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np

from sdnmpi_tpu_torch.config import Config, DEFAULT_CONFIG
from sdnmpi_tpu_torch.control import events as ev
from sdnmpi_tpu_torch.control.bus import EventBus
from sdnmpi_tpu_torch.control.recovery import InstallVerdict, RecoveryPlane
from sdnmpi_tpu_torch.core.collective_table import CollectiveInstall, CollectiveTable
from sdnmpi_tpu_torch.core.switch_fdb import SwitchFDB
from sdnmpi_tpu_torch.protocol import openflow as of
from sdnmpi_tpu_torch.protocol.vmac import CollectiveType, VirtualMac, is_sdn_mpi_addr
from sdnmpi_tpu_torch.utils.mac import BROADCAST_MAC, int_to_mac, is_ipv6_multicast
from sdnmpi_tpu_torch.utils.metrics import LATENCY_BUCKETS_S, REGISTRY, SIZE_BUCKETS
from sdnmpi_tpu_torch.utils.tracing import NULL_SPAN, start_span

log = logging.getLogger("Router")


def _mac_of(key: int, memo: dict) -> str:
    """Memoized ``int_to_mac`` — the ONE MAC-key materialization both
    the phased install (desired-store rows) and `_mac_rows`
    (teardown/rollback rows) go through, so the strings can never
    diverge and break the exact-match delete contract."""
    s = memo.get(key)
    if s is None:
        s = memo[key] = int_to_mac(key)
    return s


def _vmac_luts(
    coll_type: int, ranks_arr: np.ndarray, macs_str: list,
) -> tuple:
    """Member MAC keys + per-endpoint vMAC part LUTs for a collective —
    the ONE preamble the flat block install and the phased install
    share, so the encoding call shape can never drift between the legs
    (their flow tables must stay bit-identical on the differential).
    The LUTs come from the codec that owns the ABI
    (vmac = src_lut[si] | dst_lut[di]; the base byte is baked into
    both, OR-ing it twice is idempotent)."""
    from sdnmpi_tpu_torch.protocol.vmac import encode_batch_ints
    from sdnmpi_tpu_torch.utils.mac import macs_to_ints

    zero = np.zeros(len(ranks_arr), np.int64)
    return (
        macs_to_ints(macs_str),
        encode_batch_ints(coll_type, ranks_arr, zero),
        encode_batch_ints(coll_type, zero, ranks_arr),
    )


def _mac_rows(arr: np.ndarray, memo: dict) -> list:
    """Materialize a phased install's [N, 3] (dpid, src key, dst key)
    int rows back into the (dpid, src, dst) MAC-string rows
    ``_del_flows_window`` tears down by — ``memo`` is shared across
    phases so each distinct MAC key converts once."""
    return [
        (d, _mac_of(s, memo), _mac_of(t, memo))
        for d, s, t in zip(
            arr[:, 0].tolist(), arr[:, 1].tolist(), arr[:, 2].tolist()
        )
    ]

# -- pipeline telemetry: every stage of the route->install
# pipeline records into the process-wide registry; the RPC mirror and
# the Prometheus exposition read the same instruments.
_m_packet_ins = REGISTRY.counter(
    "router_packet_ins_total", "unicast/MPI packet-ins dispatched to routing"
)
_m_window_occupancy = REGISTRY.histogram(
    "coalescer_window_occupancy", SIZE_BUCKETS,
    "parked route lookups per flushed coalescer window",
)
_m_window_age = REGISTRY.histogram(
    "coalescer_window_age_seconds", LATENCY_BUCKETS_S,
    "park-to-window-cut age of each window's oldest member",
)
_m_queue_depth = REGISTRY.gauge(
    "coalescer_queue_depth", "route lookups parked right now"
)
_m_windows = REGISTRY.counter(
    "pipeline_windows_total", "route windows resolved (batched or serial)"
)
_m_inflight = REGISTRY.gauge(
    "pipeline_inflight_windows", "dispatched-but-unreaped route windows"
)
_m_reap_s = REGISTRY.histogram(
    "pipeline_reap_seconds", LATENCY_BUCKETS_S,
    "host blocked in RouteWindow.reap (device wait + decode)",
)
_m_install_s = REGISTRY.histogram(
    "pipeline_install_seconds", LATENCY_BUCKETS_S,
    "window FlowMod materialization + batched install",
)
_m_e2e_s = REGISTRY.histogram(
    "install_e2e_seconds", LATENCY_BUCKETS_S,
    "coalescer flush end-to-end (first dispatch -> last install) — the "
    "live twin of bench config 10's install_e2e_ms",
)
_m_overlap_gain = REGISTRY.gauge(
    "pipeline_overlap_gain",
    "serial-equivalent wall / end-to-end wall of the last flush burst "
    "(>1 means device compute overlapped host decode+install — the "
    "live twin of bench config 10's overlap_gain). The serial "
    "equivalent counts each window's in-flight interval (dispatch "
    "return -> reap start) as device time a serial pass would have "
    "waited out, so it is an upper-bound estimate: exact when the "
    "device is busy the whole interval, optimistic when it finished "
    "early",
)
_m_routed = REGISTRY.counter(
    "router_routes_resolved_total", "route lookups that found a path"
)
_m_unroutable = REGISTRY.counter(
    "router_routes_unroutable_total", "route lookups with no path"
)
_m_flows_installed = REGISTRY.counter(
    "router_flows_installed_total", "switch-level flow entries installed"
)
_m_flows_deleted = REGISTRY.counter(
    "router_flows_deleted_total", "switch-level flow entries torn down"
)
_m_teardown_batches = REGISTRY.counter(
    "router_teardown_batches_total",
    "revalidation/exit teardown bursts sent as batched OFPFC_DELETEs",
)
_m_revalidations = REGISTRY.counter(
    "router_revalidations_total", "flow revalidation passes that ran"
)
_m_revalidations_skipped = REGISTRY.counter(
    "router_revalidations_skipped_total",
    "revalidation passes skipped by the epoch gate",
)
_m_reval_drained = REGISTRY.counter(
    "router_reval_flows_drained_total",
    "re-scored flows whose NEW path moved off the dirtied switches "
    "entirely (the delta window's device-computed touched verdict): "
    "how much traffic a flap drains away from the failed region",
)
# delta-revalidation stage decomposition: the live twins of
# bench config 8's repair/rescore/diff/install medians — the repair
# stage is the oracle's own oracle_repair timing (utils/tracing.STATS);
# the three control-plane stages record here per chunk, with matching
# spans on BOTH the pipelined path and the serial / full-pass fallbacks
# so traces stay comparable across escape hatches.
_m_reval_rescore_s = REGISTRY.histogram(
    "reval_rescore_seconds", LATENCY_BUCKETS_S,
    "per-chunk re-scoring wall (delta dispatch -> window reaped)",
)
_m_reval_diff_s = REGISTRY.histogram(
    "reval_diff_seconds", LATENCY_BUCKETS_S,
    "per-chunk hop-diff wall (reaped window vs installed state)",
)
_m_reval_install_s = REGISTRY.histogram(
    "reval_install_seconds", LATENCY_BUCKETS_S,
    "per-chunk changed-span teardown + reinstall wall",
)
_m_reval_affected = REGISTRY.histogram(
    "reval_affected_flows", SIZE_BUCKETS,
    "flows re-scored per revalidation pass (the delta-narrowed blast "
    "radius; full passes count everything installed)",
)
_m_recovery_redrive_s = REGISTRY.histogram(
    "recovery_redrive_seconds", LATENCY_BUCKETS_S,
    "wall of one recovery re-drive (retry-queue pop: deletes + resync)",
)
# collective phase scheduler: phase progress of scheduled
# installs — the telemetry snapshot (and its RPC mirror) carries these
# beside the per-phase EventCollectivePhaseInstalled broadcasts.
_m_sched_programs = REGISTRY.counter(
    "sched_programs_total", "phased flow programs installed"
)
_m_sched_phases = REGISTRY.counter(
    "sched_phases_total", "collective phases installed (all programs)"
)
_m_sched_phase_install_s = REGISTRY.histogram(
    "sched_phase_install_seconds", LATENCY_BUCKETS_S,
    "one phase's reap + FlowMod materialization + batched install "
    "(phases k+1..K compute on device while this runs)",
)
_m_sched_completion = REGISTRY.gauge(
    "sched_program_completion",
    "modeled completion of the last scheduled program: sum over phases "
    "of the phase's discrete max-link load (phases serialize; the "
    "bottleneck link bounds each phase's duration) — the live twin of "
    "bench config 12's completion figure",
)
_m_sched_max_phase = REGISTRY.gauge(
    "sched_program_max_phase_congestion",
    "hottest single phase of the last scheduled program — the figure "
    "comparable to a flat install's max_congestion",
)


@dataclasses.dataclass
class _PendingRoute:
    """One packet-in's route lookup parked in the coalescer: the match
    pair, the true destination (MPI virtual-MAC flows), and everything
    needed to finish the packet's handling after the batched reply.
    ``span`` is the packet-in's root trace span (NULL_SPAN when tracing
    is off); ``park`` times the coalescer wait."""

    src: str
    dst: str  # match destination (virtual MAC for MPI flows)
    true_dst: str | None  # rewrite target; None = plain unicast
    dpid: int
    in_port: int
    pkt: of.Packet
    buffer_id: int
    span: object = NULL_SPAN
    park: object = NULL_SPAN
    #: monotonic park time — each flushed window's age histogram sample
    #: is measured from ITS oldest member, not the queue's first park
    t_parked: float = 0.0
    #: coalescer class: True for collective-member MPI
    #: lookups (an alltoall storm's per-pair packet-ins), False for
    #: latency-sensitive traffic (plain unicast, MPI point-to-point).
    #: Window composition takes latency-sensitive entries first, so a
    #: bulk storm parks BEHIND the pairs users are waiting on.
    bulk: bool = False


class Router:
    name = "Router"

    def __init__(
        self,
        bus: EventBus,
        southbound,
        config: Config = DEFAULT_CONFIG,
    ) -> None:
        self.bus = bus
        self.southbound = southbound
        self.config = config
        self.fdb = SwitchFDB()
        #: block-installed collectives (array-native proactive path)
        self.collectives = CollectiveTable()
        #: live datapaths (reference: router.py:69-81 keeps self.dps)
        self.dps: set[int] = set()
        #: route-request coalescer (Config.coalesce_routes): packet-in
        #: lookups park here and resolve as ONE padded batched oracle
        #: call per flush instead of one device dispatch each — the
        #: device round-trip amortizes across the burst, and the padded
        #: batch rides the oracle's bucketed batch shapes. The live switch
        #: is this attribute, not the config flag: the composition root
        #: (Controller) arms it only when the southbound provides an
        #: idle edge to flush from, so a lone packet can never strand
        #: in the queue waiting for a companion that never comes.
        self.coalesce: bool = False
        self._pending: list[_PendingRoute] = []
        self._pending_t0 = 0.0
        self._flushing = False
        #: revalidation epoch gate: the TopologyDB version and UtilPlane
        #: epoch as of the last completed revalidation pass. A repeat
        #: EventTopologyChanged with neither advanced is a no-op, and
        #: the delta log between passes narrows re-routing to the flows
        #: whose installed paths touch a dirtied switch.
        self._reval_version: int | None = None
        self._reval_util_epoch: int = -1
        #: failure-domain recovery plane: desired-flow store,
        #: pending-barrier table, bounded retry queue. The store is
        #: always maintained (it is just bookkeeping); the reconcile /
        #: retry / anti-entropy behaviors gate on Config.recovery_plane.
        self.recovery = RecoveryPlane(config)
        self.recovery.on_exhausted = self._resync_datapath
        #: per-tenant admission gate (control/admission.py):
        #: every packet-in passes through it BEFORE any routing work.
        #: Config.admission_rate == 0 (the default) admits everything.
        from sdnmpi_tpu_torch.control.admission import AdmissionControl

        self.admission = AdmissionControl(
            config.admission_rate, config.admission_burst
        )
        #: SLO plane (control/slo.py): set by the Controller
        #: when Config.slo_targets is non-empty. None (the default)
        #: keeps the per-window cost at one attribute load + is-None
        #: test — the unarmed hot-path contract.
        self.slo = None
        #: fabric audit plane (control/audit.py): set by the
        #: Controller when the southbound can answer flow stats. The
        #: Router only ever asks it to verify a wiped switch.
        self.audit = None
        #: rate-shaped reconcile: datapath-up reconciles past
        #: Config.reconcile_max_per_flush park here (FIFO) and drain on
        #: following recovery ticks — a power-cycled pod redialing at
        #: once must not re-drive every desired set in one burst
        self._reconcile_pending: list[int] = []
        self._reconcile_spent = 0
        #: jitter-deferred wipe-resync republishes:
        #: (due, dpid) pairs drained by recovery_tick
        self._resync_due: list[tuple[float, int]] = []

        bus.subscribe(ev.EventDatapathUp, self._datapath_up)
        bus.subscribe(ev.EventDatapathDown, self._datapath_down)
        bus.subscribe(ev.EventBarrierAck, lambda e: self.recovery.ack(e.dpid, e.xid))
        bus.subscribe(ev.EventStatsFlush, lambda e: self.recovery_tick())
        bus.subscribe(ev.EventPacketIn, self._packet_in)
        bus.subscribe(ev.EventTopologyChanged, lambda e: self._revalidate_flows())
        bus.subscribe(ev.EventProcessDelete, self._process_delete)
        bus.subscribe(ev.EventFlowRemoved, self._flow_removed)
        bus.provide(ev.CurrentFDBRequest, self._current_fdb)
        bus.provide(ev.CurrentCollectivesRequest, self._current_collectives)

    # -- flow plumbing ----------------------------------------------------

    def _add_flow(
        self,
        dpid: int,
        src: str,
        dst: str,
        out_port: int,
        actions: tuple[of.Action, ...] = (),
    ):
        # match on (dl_src, dl_dst) exactly like the reference
        # (router.py:49-62); for MPI flows dst is the *virtual* MAC so the
        # whole path forwards on it and only the last hop rewrites
        mod = of.FlowMod(
            match=of.Match(dl_src=src, dl_dst=dst),
            actions=actions + (of.ActionOutput(out_port),),
            priority=self.config.priority_default,
            idle_timeout=self.config.flow_idle_timeout,
            hard_timeout=self.config.flow_hard_timeout,
        )
        return self.southbound.flow_mod(dpid, mod)

    def _send_window(self, kd, burst: of.FlowModBatch):
        """Ship one dpid-grouped FlowModBatch through the richest send
        entry point the southbound offers (whole-window byte spans >
        per-switch batches). Returns the southbound's
        :class:`InstallVerdict`, or None for duck-typed southbounds
        without the verdict contract (the fire-and-forget legacy, which
        the recovery plane treats as a no-op)."""
        window_send = getattr(self.southbound, "flow_mods_window", None)
        if window_send is not None:
            # one batched encode for the whole window; each switch
            # gets its contiguous byte span (southbound slices it)
            return window_send(kd, burst)
        from sdnmpi_tpu_torch.utils.arrays import group_spans

        verdict = None
        for lo, hi in group_spans(kd):
            v = self.southbound.flow_mods_batch(
                int(kd[lo]), of.FlowModBatch(
                    src=burst.src[lo:hi],
                    dst=burst.dst[lo:hi],
                    out_port=burst.out_port[lo:hi],
                    rewrite=(
                        None if burst.rewrite is None
                        else burst.rewrite[lo:hi]
                    ),
                    priority=burst.priority,
                    idle_timeout=burst.idle_timeout,
                    hard_timeout=burst.hard_timeout,
                    command=burst.command,
                )
            )
            if isinstance(v, InstallVerdict):
                if verdict is None:
                    verdict = InstallVerdict()
                verdict.sent += v.sent
                verdict.dropped += v.dropped
                verdict.barriers += v.barriers
        return verdict

    def _del_flow(self, dpid: int, src: str, dst: str):
        mod = of.FlowMod(
            match=of.Match(dl_src=src, dl_dst=dst),
            actions=(),
            priority=self.config.priority_default,
            command=of.OFPFC_DELETE,
        )
        _m_flows_deleted.inc()
        return self.southbound.flow_mod(dpid, mod)

    def _del_flows_window(self, rows: list[tuple[int, str, str]]) -> None:
        """Tear down a burst of (dpid, src, dst) exact matches through
        the window installer: the whole burst materializes as ONE
        ``OFPFC_DELETE`` :class:`~sdnmpi_tpu_torch.protocol.openflow.FlowModBatch`
        and serializes in one batched wire encode
        (``encode_flow_mods_spans`` — the encoder always supported the
        command; this is the first caller), with each switch receiving
        its contiguous byte span. Revalidation after a link flap and
        rank-exit teardowns are delete *storms* — per-mod scalar
        encodes cost what the install batching already eliminated
        on the add side. Dead datapaths are skipped (same rule as the
        scalar leg); ``pipelined_install=False`` or a batchless
        southbound falls back to scalar ``_del_flow`` per row — the
        differential escape hatch, byte-identical on the wire."""
        # the rows leave the DESIRED store unconditionally (dead-dpid
        # rows too: a crashed switch's redial must not resurrect them)
        for dpid, src, dst in rows:
            self.recovery.desired.remove(dpid, src, dst)
        live = [r for r in rows if r[0] in self.dps]
        if not live:
            return
        if (
            not self.config.pipelined_install
            or not hasattr(self.southbound, "flow_mods_batch")
        ):
            failed: dict[int, set] = {}
            for dpid, src, dst in live:
                if self._del_flow(dpid, src, dst) is False:
                    failed.setdefault(dpid, set()).add((src, dst))
            if failed and self.config.recovery_plane:
                self.recovery.note_send(
                    InstallVerdict(dropped=sorted(failed)),
                    delete_rows=failed,
                )
            return

        from sdnmpi_tpu_torch.utils.mac import macs_to_ints

        kd = np.array([r[0] for r in live], np.int64)
        order = np.argsort(kd, kind="stable")
        kd = kd[order]
        burst = of.FlowModBatch(
            src=macs_to_ints([r[1] for r in live])[order],
            dst=macs_to_ints([r[2] for r in live])[order],
            out_port=np.zeros(len(live), np.int32),  # DELETE: no actions
            rewrite=None,
            priority=self.config.priority_default,
            command=of.OFPFC_DELETE,
        )
        _m_flows_deleted.inc(len(live))
        _m_teardown_batches.inc()
        verdict = self._send_window(kd, burst)
        if self.config.recovery_plane:
            # a dropped teardown re-drives as a teardown (not a resync):
            # the retry entry carries the exact (src, dst) rows
            delete_rows: dict[int, set] = {}
            for dpid, src, dst in live:
                delete_rows.setdefault(dpid, set()).add((src, dst))
            self.recovery.note_send(verdict, delete_rows=delete_rows)

    def _add_flows_for_path(
        self,
        fdb: list[tuple[int, int]],
        src: str,
        dst: str,
        true_dst: str | None = None,
    ) -> None:
        """Install one flow per hop (reference: router.py:83-104)."""
        failed: list[int] = []
        for idx, (dpid, out_port) in enumerate(fdb):
            if self.fdb.exists(dpid, src, dst):
                continue
            if dpid not in self.dps:
                # don't record hops we couldn't install: recording them
                # would dedup-suppress the install forever once the
                # datapath returns
                continue
            self.fdb.update(dpid, src, dst, out_port)
            _m_flows_installed.inc()
            self.bus.publish(ev.EventFDBUpdate(dpid, src, dst, out_port))

            last = idx == len(fdb) - 1
            rewrite = true_dst if (true_dst and last) else None
            self.recovery.desired.record(dpid, src, dst, out_port, rewrite)
            if rewrite:
                # virtual -> real MAC rewrite on the final hop
                # (reference: router.py:98-102)
                ok = self._add_flow(
                    dpid, src, dst, out_port, (of.ActionSetDlDst(true_dst),)
                )
            else:
                ok = self._add_flow(dpid, src, dst, out_port)
            if ok is False:
                failed.append(dpid)
        if failed and self.config.recovery_plane:
            # dropped scalar installs enter the same bounded retry queue
            # the batched windows use (resync re-drives the desired set)
            self.recovery.note_send(
                InstallVerdict(dropped=sorted(set(failed)))
            )

    def _send_packet_out(
        self,
        fdb: list[tuple[int, int]],
        dpid: int,
        pkt: of.Packet,
        buffer_id: int = of.OFP_NO_BUFFER,
    ) -> None:
        """Emit the triggering packet from the ingress switch only,
        reusing the switch-side buffer when the packet-in carried one —
        the frame is not re-sent over the control channel (reference:
        router.py:106-123, buffer handling at :111-118)."""
        for entry_dpid, out_port in fdb:
            if entry_dpid == dpid:
                buffered = buffer_id != of.OFP_NO_BUFFER
                out = of.PacketOut(
                    data=None if buffered else pkt,
                    actions=(of.ActionOutput(out_port),),
                    buffer_id=buffer_id,
                )
                self.southbound.packet_out(dpid, out)
                break

    # -- packet-in dispatch (reference: router.py:125-160) ----------------

    def _packet_in(self, event: ev.EventPacketIn) -> None:
        pkt = event.pkt
        src, dst = pkt.eth_src, pkt.eth_dst

        if pkt.eth_type == of.ETH_TYPE_LLDP:
            return
        if dst == BROADCAST_MAC:
            return  # broadcasts are the TopologyManager's job
        if is_ipv6_multicast(dst):
            return
        if is_sdn_mpi_addr(dst):
            return self._mpi_packet_in(event)

        if not self.admission.admit(src):
            return  # over the tenant's admitted rate: drop at the door

        log.info("Packet in at %s (%s) %s -> %s", event.dpid, event.in_port, src, dst)

        _m_packet_ins.inc()
        sp = start_span(
            "packet_in", dpid=event.dpid, in_port=event.in_port,
            src=src, dst=dst,
        )
        if self.coalesce:
            return self._enqueue_route(src, dst, None, event, span=sp)
        fdb = self.bus.request(ev.FindRouteRequest(src, dst)).fdb
        if fdb:
            _m_routed.inc()
            self._add_flows_for_path(fdb, src, dst)
            self._send_packet_out(fdb, event.dpid, pkt, event.buffer_id)
        else:
            _m_unroutable.inc()
            self.bus.request(ev.BroadcastRequest(pkt, event.dpid, event.in_port))
        sp.end(routable=bool(fdb))

    # -- MPI packets (reference: router.py:166-195) -----------------------

    def _mpi_packet_in(self, event: ev.EventPacketIn) -> None:
        pkt = event.pkt
        if not self.admission.admit(pkt.eth_src):
            # over the tenant's admitted rate: drop at the door — before
            # the vMAC decode, the per-packet log line, rank resolution
            # or any other per-request work, so a storm of rejects
            # costs the control loop near nothing
            return
        vmac = VirtualMac.decode(pkt.eth_dst)
        log.info(
            "SDNMPI communication from rank %s to rank %s (collective %s)",
            vmac.src_rank,
            vmac.dst_rank,
            vmac.coll_type,
        )

        true_dst = self.bus.request(ev.RankResolutionRequest(vmac.dst_rank)).mac
        if not true_dst:
            return  # unresolved rank -> drop (reference: router.py:186-187)

        _m_packet_ins.inc()
        sp = start_span(
            "packet_in", dpid=event.dpid, in_port=event.in_port,
            src=pkt.eth_src, dst=pkt.eth_dst, mpi=True,
        )
        # collective-member lookups are the BULK coalescer class: a
        # storm of them must not starve latency-sensitive singles
        bulk = vmac.coll_type != CollectiveType.P2P
        if self.coalesce:
            self._enqueue_route(
                pkt.eth_src, pkt.eth_dst, true_dst, event, span=sp,
                bulk=bulk,
            )
        else:
            fdb = self.bus.request(ev.FindRouteRequest(pkt.eth_src, true_dst)).fdb
            if fdb:
                _m_routed.inc()
                self._add_flows_for_path(fdb, pkt.eth_src, pkt.eth_dst, true_dst)
                self._send_packet_out(fdb, event.dpid, pkt, event.buffer_id)
            else:
                _m_unroutable.inc()
            sp.end(routable=bool(fdb))

        if self.config.proactive_collectives and vmac.coll_type != CollectiveType.P2P:
            self._install_collective(vmac)

    # -- route-request coalescing (no reference equivalent) ---------------

    def _enqueue_route(
        self, src: str, dst: str, true_dst: str | None,
        event: ev.EventPacketIn, span=NULL_SPAN, bulk: bool = False,
    ) -> None:
        """Park one packet-in's route lookup for batched resolution.

        Flush triggers: the pending batch reaching
        ``Config.coalesce_max_batch``, or ``Config.coalesce_window_s``
        elapsing since the batch opened. The southbound's idle edge
        (Fabric.on_idle -> :meth:`flush_routes`) bounds the wait: a
        burst is always resolved before control returns to the caller
        that injected it, so coalescing never strands a packet."""
        now = time.monotonic()
        if not self._pending:
            self._pending_t0 = now
        self._pending.append(_PendingRoute(
            src, dst, true_dst, event.dpid, event.in_port, event.pkt,
            event.buffer_id, span=span, park=span.child("coalesce_park"),
            t_parked=now, bulk=bulk,
        ))
        _m_queue_depth.set(len(self._pending))
        if not self._flushing and (
            len(self._pending) >= self.config.coalesce_max_batch
            or time.monotonic() - self._pending_t0
            >= self.config.coalesce_window_s
        ):
            self.flush_routes()

    def flush_routes(self) -> None:
        """Resolve every pending route lookup, one batched oracle call
        per ``coalesce_max_batch`` slice, then finish each parked packet
        exactly as the direct path would (install + packet-out, or
        controlled broadcast for routeless unicast). Loops until the
        queue drains: packet-outs re-entering the data plane may park
        new lookups mid-flush.

        With ``Config.pipelined_install`` the windows are
        *double-buffered* through the oracle's split-phase API
        (DispatchRoutesBatchRequest): window k+1's device program is
        dispatched BEFORE window k is reaped, so k+1 computes on device
        while the host decodes, materializes, and installs k — the
        device never idles between windows of a burst. Install order is
        preserved (k always installs before k+1 is reaped)."""
        if self._flushing or not self._pending:
            # idle edges fire constantly; an empty flush must not
            # observe a meaningless e2e sample
            return
        self._flushing = True
        t_flush0 = time.perf_counter()
        stage_wall = 0.0  # dispatch + reap + install walls
        hidden_wall = 0.0  # in-flight device intervals the host overlapped
        last_window_span = 0  # e2e exemplar: the burst's last window

        def _reap_timed(batch, handle, wsp, t_dispatched):
            """Reap window ``handle`` (timed, spanned) and finish its
            batch. The interval between the window's dispatch return
            and this reap is device compute the host overlapped with
            other work — a serial pass would have waited it out, so it
            feeds the overlap-gain numerator."""
            nonlocal stage_wall, hidden_wall
            t0 = time.perf_counter()
            hidden_wall += t0 - t_dispatched
            rsp = wsp.child("reap")
            try:
                wr = handle.reap()
            finally:
                # a raising reap (device error surfacing through the
                # window) must not leave the in-flight gauge pinned or
                # the spans open — the controller outlives the window
                rsp.end()
                dt = time.perf_counter() - t0
                _m_reap_s.observe(dt)
                _m_inflight.dec()
            t0 = time.perf_counter()
            try:
                self._finish_batch(batch, wr, wsp)
            finally:
                wsp.end()
                stage_wall += dt + (time.perf_counter() - t0)

        try:
            prev: tuple | None = None  # (batch, window, wsp, t_dispatched)
            while self._pending or prev is not None:
                batch = self._next_window()
                _m_queue_depth.set(len(self._pending))
                window = None
                wsp = NULL_SPAN
                if batch:
                    _m_window_occupancy.observe(len(batch))
                    # age of THIS window's oldest member (not the whole
                    # queue's t0: later windows of one flush parked later)
                    _m_window_age.observe(
                        time.monotonic() - batch[0].t_parked
                    )
                    _m_windows.inc()
                    # window span: tree-parented to the first parked
                    # packet; the rest of the fan-in is recorded as
                    # span_link records (many packet-ins -> one window)
                    wsp = batch[0].span.child(
                        "route_window", n_pairs=len(batch)
                    )
                    last_window_span = wsp.id or last_window_span
                    for p in batch:
                        p.park.end()
                        if p is not batch[0]:
                            wsp.link(p.span)
                    pairs = [(p.src, p.true_dst or p.dst) for p in batch]
                    dsp = wsp.child("dispatch")
                    t0 = time.perf_counter()
                    window = self._dispatch_window(pairs)
                    t_dispatched = time.perf_counter()
                    stage_wall += t_dispatched - t0
                    dsp.end(split_phase=window is not None)
                    if window is None:
                        # no split-phase provider on this bus (or
                        # pipelining off): serial resolve-then-install
                        if prev is not None:
                            _reap_timed(*prev)
                            prev = None
                        reply = self.bus.request(
                            ev.FindRoutesBatchRequest(pairs)
                        )
                        from sdnmpi_tpu_torch.oracle.batch import WindowRoutes

                        t0 = time.perf_counter()
                        self._finish_batch(
                            batch, WindowRoutes.from_fdbs(reply.fdbs), wsp
                        )
                        wsp.end()
                        stage_wall += time.perf_counter() - t0
                        continue
                    _m_inflight.inc()
                # window k+1 is now in flight: reap + install window k
                # while the device chews on k+1
                if prev is not None:
                    _reap_timed(*prev)
                prev = (
                    (batch, window, wsp, t_dispatched) if batch else None
                )
        finally:
            self._flushing = False
            e2e = time.perf_counter() - t_flush0
            # the flush's spans are all closed by now, so the ambient
            # CURRENT_SPAN is gone — attribute the e2e sample to the
            # burst's last window span explicitly (README's "explain
            # this p99 spike" walkthrough starts from this exemplar)
            _m_e2e_s.observe(e2e, exemplar=last_window_span)
            if e2e > 0:
                # live twin of bench config 10's overlap_gain: the
                # serial-equivalent wall (host stages + the in-flight
                # device intervals a serial pass would have waited out)
                # over the achieved end-to-end wall. ~1.0 = serial;
                # >1 = device compute overlapped host decode+install
                _m_overlap_gain.set((stage_wall + hidden_wall) / e2e)

    def _next_window(self) -> list[_PendingRoute]:
        """Compose the next coalescer window, priority-aware.

        The window is capped at ``Config.coalesce_max_batch`` —
        overflow stays parked and spills into the NEXT window of the
        same flush loop, in arrival order, never one oversized window
        (routes parked mid-flush by re-entering packet-outs join the
        spill the same way; pinned by tests/test_serving.py). Within
        the cap, latency-sensitive entries (plain unicast, MPI
        point-to-point) are taken BEFORE bulk collective-member
        lookups, so an alltoall storm's backlog cannot push a single-
        pair request to the back of the flush; a single-class queue
        degenerates to plain arrival-order slicing (the
        behavior, byte-identical)."""
        cap = max(1, self.config.coalesce_max_batch)
        pending = self._pending
        if len(pending) <= cap:
            batch = pending[:]
            pending.clear()
            return batch
        sel = [i for i, p in enumerate(pending) if not p.bulk][:cap]
        if len(sel) < cap:
            room = cap - len(sel)
            if self.config.coalesce_wfq_weights:
                bulk_idx = self._wfq_bulk(pending, room)
            else:
                bulk_idx = []
                for i, p in enumerate(pending):
                    if p.bulk:
                        bulk_idx.append(i)
                        if len(bulk_idx) == room:
                            break
            sel = sorted(sel + bulk_idx)
        taken = set(sel)
        batch = [pending[i] for i in sel]
        # ONE compaction pass (in place — flush/census/enqueue all hold
        # this list): per-index deletes would make each flush O(cap x
        # backlog) on exactly the storm backlog this queue exists for
        pending[:] = [p for i, p in enumerate(pending) if i not in taken]
        return batch

    def _wfq_bulk(self, pending, room: int) -> list[int]:
        """Weighted fair split of a window's bulk room across tenants
        (Config.coalesce_wfq_weights): the room is
        allocated to the bulk tenants PRESENT in the backlog
        proportionally to their weights (unlisted tenants weigh 1.0)
        by largest-remainder rounding — deterministic, ties to the
        lexicographically-first tenant — and each tenant's allocation
        is served in its own arrival order. A tenant with less backlog
        than its share donates the surplus to the others, so no slot
        is wasted; a single-tenant backlog degenerates to the plain
        arrival-order fill byte-identically (pinned by
        tests/test_serving.py)."""
        weights_cfg = self.config.coalesce_wfq_weights
        groups: dict[str, list[int]] = {}
        for i, p in enumerate(pending):
            if p.bulk:
                groups.setdefault(
                    self.admission.tenant_of(p.src), []
                ).append(i)
        if not groups:
            return []
        weights = {
            t: max(float(weights_cfg.get(t, 1.0)), 1e-9) for t in groups
        }
        total_w = sum(weights.values())
        alloc = {
            t: min(len(groups[t]), int(room * weights[t] / total_w))
            for t in groups
        }
        used = sum(alloc.values())
        while used < room:
            best = None
            for t in sorted(groups):
                if alloc[t] >= len(groups[t]):
                    continue
                deficit = room * weights[t] / total_w - alloc[t]
                if best is None or deficit > best[0] + 1e-12:
                    best = (deficit, t)
            if best is None:
                break  # every tenant's backlog exhausted
            alloc[best[1]] += 1
            used += 1
        return [i for t in groups for i in groups[t][: alloc[t]]]

    def _dispatch_window(self, pairs, policy: str = "shortest", dirty=None):
        """Dispatch one window through the split-phase oracle API, or
        None when the serial path must be used (pipelining disabled, or
        a bus without the dispatch provider — e.g. minimal test
        stacks). ``dirty`` is the delta-narrowed revalidation's dirtied
        dpid set: the oracle re-scores the pairs with it as a device
        mask tensor and the reaped window carries per-pair ``touched``
        verdicts (events.DispatchRoutesBatchRequest)."""
        if not self.config.pipelined_install:
            return None
        try:
            return self.bus.request(
                ev.DispatchRoutesBatchRequest(pairs, policy=policy,
                                              dirty=dirty)
            ).window
        except LookupError:
            return None

    def _finish_batch(
        self, batch: list[_PendingRoute], wr, wsp=NULL_SPAN
    ) -> None:
        """Install one reaped window and finish its parked packets:
        vectorized FlowMod materialization + batched install for the
        whole window, then per-packet packet-out / broadcast fallback
        (the per-packet leg is inherently scalar — one PacketOut each)."""

        t0 = time.perf_counter()
        isp = wsp.child("install")
        routable = self._install_window(
            [(p.src, p.dst, p.true_dst) for p in batch], wr, parent=isp
        )
        isp.end(n_routable=int(np.count_nonzero(routable)))
        _m_install_s.observe(time.perf_counter() - t0)
        _m_routed.inc(int(np.count_nonzero(routable)))
        _m_unroutable.inc(len(batch) - int(np.count_nonzero(routable)))
        slo = self.slo
        if slo is not None:
            # per-tenant park-to-install latency for targeted tenants
            # (control/slo.py): the window is installed, so this is the
            # latency the tenant's rank experienced end to end
            slo.observe_batch(batch, time.monotonic())
        for k, p in enumerate(batch):
            p.span.end(routable=bool(routable[k]))
            if routable[k]:
                n = int(wr.hop_len[k])
                hops = wr.hop_dpid[k, :n]
                pos = np.nonzero(hops == p.dpid)[0]
                if not pos.size:
                    continue  # ingress switch not on the path
                buffered = p.buffer_id != of.OFP_NO_BUFFER
                self.southbound.packet_out(p.dpid, of.PacketOut(
                    data=None if buffered else p.pkt,
                    actions=(
                        of.ActionOutput(int(wr.hop_port[k, pos[0]])),
                    ),
                    buffer_id=p.buffer_id,
                ))
            elif p.true_dst is None:
                # routeless unicast falls back to controlled broadcast;
                # routeless MPI flows drop, exactly like the direct
                # path (reference: router.py:186)
                self.bus.request(
                    ev.BroadcastRequest(p.pkt, p.dpid, p.in_port)
                )

    def _install_window(self, entries, wr, parent=NULL_SPAN):
        """Install a whole window's flows from its WindowRoutes arrays.

        ``entries`` is ``[(src, dst, true_dst), ...]`` row-aligned with
        ``wr``. The hop rows are flattened and masked with array ops
        (live-datapath filter via ``np.isin``, last-hop rewrite
        selection with one ``np.where``); FDB dedup/bookkeeping stays a
        dict pass (it IS the dedup store), but builds no message
        objects; the surviving rows are grouped by switch with one
        ``np.argsort`` and the whole window ships as ONE
        :class:`~sdnmpi_tpu_torch.protocol.openflow.FlowModBatch` through
        ``southbound.flow_mods_window`` — a single batched wire encode
        whose per-switch byte spans the southbound flushes, instead of
        one FlowMod dataclass + ``struct.pack`` per hop. Southbounds
        with only the per-switch batch entry point get per-group
        bursts; ones with neither fall back to the scalar per-hop
        path. Returns the [F] bool routable mask."""

        ln = np.asarray(wr.hop_len)
        routable = ln > 0
        if not len(entries) or not routable.any():
            return routable
        if (
            not self.config.pipelined_install
            or not hasattr(self.southbound, "flow_mods_batch")
        ):
            # the genuine legacy leg — pipelined_install=False is the
            # differential escape hatch and must reach the scalar
            # per-hop FlowMod + per-message encode path, not just
            # serialize the resolution
            for k, (src, dst, true_dst) in enumerate(entries):
                if routable[k]:
                    self._add_flows_for_path(wr.fdb(k), src, dst, true_dst)
            return routable

        from sdnmpi_tpu_torch.utils.mac import int_to_mac, mac_to_int, macs_to_ints

        f, l = wr.hop_dpid.shape
        mask = np.arange(l)[None, :] < ln[:, None]
        pair_idx, hop_idx = np.nonzero(mask)
        dpid = wr.hop_dpid[pair_idx, hop_idx]
        port = wr.hop_port[pair_idx, hop_idx]
        last = hop_idx == ln[pair_idx] - 1
        src_keys = macs_to_ints([e[0] for e in entries])
        dst_keys = macs_to_ints([e[1] for e in entries])
        rew_keys = np.array(
            [mac_to_int(e[2]) if e[2] else -1 for e in entries], np.int64
        )
        m_src = src_keys[pair_idx]
        m_dst = dst_keys[pair_idx]
        m_rew = np.where(last, rew_keys[pair_idx], -1)
        dps = np.fromiter(self.dps, np.int64, len(self.dps))
        dps.sort()
        live = np.isin(dpid, dps)

        # dedup + FDB bookkeeping: dict ops only, one pass over the
        # flat rows. Hops on dead datapaths are not recorded (recording
        # them would dedup-suppress the install once the switch returns
        # — same rule as _add_flows_for_path).
        keep = np.zeros(len(dpid), bool)
        for i in np.nonzero(live)[0]:
            d = int(dpid[i])
            src, dst, _ = entries[pair_idx[i]]
            if self.fdb.exists(d, src, dst):
                continue
            p = int(port[i])
            self.fdb.update(d, src, dst, p)
            rw = int(m_rew[i])
            self.recovery.desired.record(
                d, src, dst, p, int_to_mac(rw) if rw >= 0 else None
            )
            self.bus.publish(ev.EventFDBUpdate(d, src, dst, p))
            keep[i] = True
        if keep.any():
            kd = dpid[keep]
            order = np.argsort(kd, kind="stable")
            kd = kd[order]
            burst = of.FlowModBatch(
                src=m_src[keep][order],
                dst=m_dst[keep][order],
                out_port=port[keep][order],
                rewrite=m_rew[keep][order],
                priority=self.config.priority_default,
                idle_timeout=self.config.flow_idle_timeout,
                hard_timeout=self.config.flow_hard_timeout,
            )
            _m_flows_installed.inc(len(kd))
            ssp = parent.child(
                "southbound_send", n_rows=len(kd),
                n_switches=int(np.count_nonzero(np.diff(kd)) + 1),
            )
            verdict = self._send_window(kd, burst)
            if self.config.recovery_plane:
                # dropped spans enter the bounded retry queue; barrier
                # xids arm the pending-ack table (barrier_rtt_seconds /
                # anti-entropy on timeout)
                self.recovery.note_send(verdict)
            ssp.end()
        return routable

    def _install_collective(self, vmac: VirtualMac) -> None:
        """Pre-route the whole collective in one load-balanced batch.

        The first packet of a collective reveals its type; every rank pair
        the collective's algorithm will send is routed in a single oracle
        call (spread across equal-cost paths, seeded with measured link
        utilization) and installed before those packets exist — the rest
        of the collective never touches the controller. The reference
        decodes the collective type but only logs it (router.py:182).

        Two install engines behind one decision: small collectives take
        the reference-shaped per-pair path (string MACs, exact per-pair
        dedup, one FDB event per hop); collectives with >=
        ``Config.block_install_threshold`` pairs take the array-native
        block path (int MAC keys, shared path blocks, one event per
        collective) — see :meth:`_install_collective_blocks`."""
        from sdnmpi_tpu_torch.collectives import collective_pairs

        rankdb = self.bus.request(ev.CurrentProcessAllocationRequest()).processes
        ranks = rankdb.ranks()
        n = len(ranks)
        if n < 2:
            return
        # Pattern generators work in index space 0..n-1; registered rank
        # ids need not be contiguous, so map through the sorted rank list.
        # Root inference from the kickoff packet: BCAST/SCATTER round 0 is
        # the root's own first send (src == root); GATHER is flat, so
        # every packet's dst is the root. Binomial REDUCE cannot be
        # inferred — its first round is n/2 parallel sends with different
        # destinations, so a wrong guess is (n-2)/n likely; REDUCE
        # therefore routes reactively instead of installing a mis-rooted
        # tree.
        if vmac.coll_type == CollectiveType.REDUCE:
            return
        root_rank = {
            CollectiveType.BCAST: vmac.src_rank,
            CollectiveType.SCATTER: vmac.src_rank,
            CollectiveType.GATHER: vmac.dst_rank,
        }.get(vmac.coll_type)
        kwargs = {}
        if root_rank is not None:
            if root_rank not in ranks:
                return
            kwargs["root"] = ranks.index(root_rank)
        try:
            rank_pairs = collective_pairs(vmac.coll_type, n, **kwargs)
        except ValueError:
            return  # pattern not applicable (e.g. non-power-of-two ranks)

        if len(rank_pairs) >= self.config.block_install_threshold:
            return self._install_collective_blocks(
                vmac.coll_type, ranks, root_rank, rank_pairs, rankdb
            )

        # ranks need not be contiguous 0..n-1; pattern indices map onto the
        # sorted registered ranks, and the vMACs carry the *actual* ids
        todo: list[tuple[str, str, str]] = []  # (src_mac, pair_vmac, true_dst)
        pairs: list[tuple[str, str]] = []
        installed = self.fdb.pairs()  # one scan, O(1) lookups in the loop
        for si, di in sorted({(int(s), int(d)) for s, d in rank_pairs}):
            if si == di:
                continue
            s_rank, d_rank = ranks[si], ranks[di]
            src_mac = rankdb.get_mac(s_rank)
            dst_mac = rankdb.get_mac(d_rank)
            if not src_mac or not dst_mac:
                continue
            pair_vmac = VirtualMac(vmac.coll_type, s_rank, d_rank).encode()
            if (src_mac, pair_vmac) in installed:
                continue
            todo.append((src_mac, pair_vmac, dst_mac))
            pairs.append((src_mac, dst_mac))
        if not pairs:
            return

        window = self._dispatch_window(
            pairs, policy=self.config.collective_policy
        )
        if window is not None:
            # split-phase + vectorized window install: the whole
            # collective's FlowMods materialize as struct arrays and
            # ship as per-switch batched bursts
            wr = window.reap()
            max_congestion = wr.max_congestion
            self._install_window(todo, wr)
        else:
            reply = self.bus.request(
                ev.FindRoutesBatchRequest(
                    pairs, policy=self.config.collective_policy
                )
            )
            max_congestion = reply.max_congestion
            for (src_mac, pair_vmac, dst_mac), fdb in zip(todo, reply.fdbs):
                if fdb:
                    self._add_flows_for_path(fdb, src_mac, pair_vmac, dst_mac)
        log.info(
            "proactive install: collective %s, %d flows, max link load %s",
            vmac.coll_type,
            len(pairs),
            max_congestion,
        )

    def _install_collective_blocks(
        self,
        coll_type: int,
        ranks: list[int],
        root_rank,
        rank_pairs,
        rankdb,
        policy: str | None = None,
    ) -> None:
        """Array-native proactive install: no per-pair Python objects.

        The pattern's [F, 2] index pairs are deduplicated, filtered, and
        routed through one ``FindCollectiveRoutesRequest``; MAC keys and
        vMACs are encoded in batch (int48 arrays); each ECMP sub-flow's
        shared transit path goes to the fabric as ONE ``FlowPathBlock``
        whose member arrays are views into the sorted pair arrays. The
        reference would have run 16.7M packet-in -> DFS -> per-hop
        FlowMod cycles for the same outcome (reference:
        sdnmpi/router.py:125-160, sdnmpi/util/topology_db.py:59-84)."""

        from sdnmpi_tpu_torch import native

        signature = (coll_type, root_rank, tuple(ranks))
        if self.collectives.get_by_signature(signature) is not None:
            return  # whole collective already installed
        policy = policy or self.config.collective_policy

        ranks_arr = np.asarray(ranks, dtype=np.int64)
        macs = [rankdb.get_mac(r) for r in ranks]
        # zero key marks "no MAC registered"; pairs touching one are
        # dropped below and the placeholder never reaches a switch
        present = np.array([bool(m) for m in macs])
        macs_str = [m or "00:00:00:00:00:00" for m in macs]
        n = len(ranks)

        src_idx = np.asarray(rank_pairs[:, 0], dtype=np.int64)
        dst_idx = np.asarray(rank_pairs[:, 1], dtype=np.int64)
        keep = (src_idx != dst_idx) & present[src_idx] & present[dst_idx]
        # dedup repeated pattern pairs (ring rounds repeat each neighbor
        # pair 2(n-1) times) — membership mask over the dense n^2 key
        # space, no comparison sort (np.unique costs seconds at 16.7M)
        seen = np.zeros(n * n, dtype=bool)
        if keep.all():
            seen[src_idx * n + dst_idx] = True
        else:
            seen[src_idx[keep] * n + dst_idx[keep]] = True
        key = np.nonzero(seen)[0]
        if not len(key):
            return
        src_idx, dst_idx = np.divmod(key, n)
        src_idx = src_idx.astype(np.int32)
        dst_idx = dst_idx.astype(np.int32)

        # phase-scheduler leg: with Config.schedule_collectives
        # the request carries schedule= (0 = auto phase count) and the
        # reply's routes is a PhasedFlowProgram whose per-phase device
        # programs are already dispatched; everything below then runs
        # per phase in _install_collective_phased. Default off: the
        # request is bit-identical to the pre-scheduler controller.
        schedule = (
            int(self.config.schedule_phases)
            if self.config.schedule_collectives else None
        )
        routes = self.bus.request(
            ev.FindCollectiveRoutesRequest(
                macs_str, src_idx, dst_idx, policy=policy,
                schedule=schedule,
            )
        ).routes
        if schedule is not None:
            return self._install_collective_phased(
                coll_type, ranks, root_rank, policy, macs_str,
                src_idx, dst_idx, routes,
            )

        # member-key production + counting sort by sub-flow, one native
        # pass; MAC keys + vMAC part LUTs through the preamble shared
        # with the phased leg (_vmac_luts owns the ABI comment)
        mac_keys, vmac_src_lut, vmac_dst_lut = _vmac_luts(
            coll_type, ranks_arr, macs_str
        )
        bounds, m_src, m_vmac, m_rew, m_fport = native.scatter_members(
            routes.pair_sub, src_idx, dst_idx, mac_keys,
            vmac_src_lut, vmac_dst_lut, mac_keys, routes.endpoint_port,
            0, routes.n_subflows,
        )

        cookie = self.collectives.next_cookie()
        # switch-level flow entries = sum over routable sub-flows of
        # members x path length (what the reference would install as
        # individual FlowMods)
        members_per_sub = np.diff(bounds)
        n_flows = int((members_per_sub * routes.hop_len).sum())
        if n_flows == 0:
            return  # nothing routable: don't record an empty install
        self.southbound.flow_block_set(
            of.FlowBlockSet(
                hop_dpid=routes.hop_dpid,
                hop_port=routes.hop_port,
                hop_len=routes.hop_len,
                bounds=bounds,
                src=m_src,
                dst=m_vmac,
                final_port=m_fport,
                rewrite=m_rew,
                priority=self.config.priority_default,
                cookie=cookie,
            )
        )

        # the dirty-set index for delta-narrowed revalidation: which
        # switches this collective's routed blocks actually ride (pad
        # rows are -1; unroutable sub-flows contribute nothing). One
        # np.unique over the hop arrays at install time buys skipping
        # whole-collective re-routes for every disjoint link flap later.
        hop_dpid = np.asarray(routes.hop_dpid)
        touched = frozenset(
            int(d) for d in np.unique(hop_dpid[hop_dpid >= 0])
        )
        # the directed-link index for congestion attribution:
        # consecutive hop pairs of each routed block, vectorized over
        # the same arrays — a hot link resolves to the collectives whose
        # blocks actually traverse it, not to everything in the fabric
        a, b = hop_dpid[:, :-1], hop_dpid[:, 1:]
        ridden = (a >= 0) & (b >= 0)
        links = frozenset(
            zip(a[ridden].astype(int).tolist(), b[ridden].astype(int).tolist())
        )
        self.collectives.add(
            CollectiveInstall(
                cookie, coll_type, tuple(ranks), root_rank,
                policy, macs_str, src_idx, dst_idx,
                n_pairs=len(src_idx), n_flows=n_flows,
                max_congestion=routes.max_congestion,
                switches=touched,
                links=links,
            )
        )
        self.bus.publish(
            ev.EventCollectiveInstalled(
                cookie, coll_type, len(src_idx), n_flows,
                routes.max_congestion,
            )
        )
        log.info(
            "proactive block install: collective %s, %d pairs, %d sub-flow "
            "blocks, %d switch flows, max link load %s",
            coll_type, len(src_idx), routes.n_subflows, n_flows,
            routes.max_congestion,
        )

    def _install_collective_phased(
        self,
        coll_type: int,
        ranks: list[int],
        root_rank,
        policy: str,
        macs_str: list[str],
        src_idx: np.ndarray,
        dst_idx: np.ndarray,
        program,
    ) -> None:
        """Install a scheduled collective's phased flow program,
        phase by phase through the window plane.

        Every phase's device program was dispatched back to back by the
        oracle before this method sees the program, so reaping phase k
        here overlaps phases k+1..K's device compute — phasing adds
        pipeline depth, not serial latency. Each phase's reaped
        :class:`CollectiveRoutes` materializes into member-level FlowMod
        rows with array ops (one ``np.repeat`` cascade over the member
        scatter — no per-pair Python in the hop math), ships as ONE
        batched window per phase, and registers its barrier xids with
        the recovery plane: the barrier acks ARE the phase boundary,
        draining asynchronously while the next phase reaps. Desired
        rows are recorded per switch with ``collective=True`` (the
        collective table owns their lifecycle, not the SwitchFDB), so a
        switch that crashes and redials MID-PROGRAM reconciles to
        exactly the phases installed so far. Per-phase rows and the
        per-phase directed-link index land in the
        :class:`CollectiveInstall` (teardown re-drives the rows;
        congestion attribution resolves a hot link to the phase riding
        it)."""
        from sdnmpi_tpu_torch import native

        ranks_arr = np.asarray(ranks, dtype=np.int64)
        mac_keys, vmac_src_lut, vmac_dst_lut = _vmac_luts(
            coll_type, ranks_arr, macs_str
        )
        dps = np.fromiter(self.dps, np.int64, len(self.dps))
        dps.sort()
        dps_set = set(dps.tolist())

        cookie = self.collectives.next_cookie()
        total_flows = 0
        switches: set[int] = set()
        links_all: set[tuple[int, int]] = set()
        phase_links: dict[tuple[int, int], list[int]] = {}
        # per-phase rows are ONE [N, 3] (dpid, src key, dst key) int
        # array, not N string tuples: a flagship-scale program retains
        # millions of rows for the install's lifetime so teardown can
        # re-derive exact matches, and the key arrays cost ~10x less —
        # MAC strings re-materialize in one memoized pass (_mac_rows)
        # at teardown/rollback
        phase_rows: list[tuple[int, np.ndarray]] = []
        phase_cong: list[float] = []
        # the current phase's shipped rows: a phase that fails
        # mid-program (device reap error, raising send) must not orphan
        # rows already on the switches and in the desired store with no
        # CollectiveInstall recorded to ever tear them down — the
        # rollback set is phase_rows plus this array
        arr_rows = np.empty((0, 3), np.int64)
        mac_memo: dict[int, str] = {}

        sp = start_span(
            "collective_program", cookie=cookie,
            n_phases=program.n_phases, n_pairs=program.n_pairs,
        )
        try:
            for plan in program.phases:
                t0 = time.perf_counter()
                psp = sp.child(
                    "collective_phase", phase=plan.phase,
                    n_pairs=plan.n_pairs,
                )
                try:
                    routes = plan.reap()
                    bounds, m_src, m_vmac, m_rew, m_fport = (
                        native.scatter_members(
                            routes.pair_sub,
                            src_idx[plan.pair_idx], dst_idx[plan.pair_idx],
                            mac_keys, vmac_src_lut, vmac_dst_lut, mac_keys,
                            routes.endpoint_port, 0, routes.n_subflows,
                        )
                    )
                    hop_dpid = np.asarray(routes.hop_dpid)
                    hop_port = np.asarray(routes.hop_port)
                    hop_len = np.asarray(routes.hop_len)
                    # member -> flat (member, hop) rows, all array ops:
                    # every member of sub-flow s contributes hop_len[s]
                    # rows riding s's shared transit path, with the
                    # member's own final port / rewrite on the last hop
                    m_sub = np.repeat(
                        np.arange(routes.n_subflows), np.diff(bounds)
                    )
                    rep = hop_len[m_sub]  # [M] rows per member
                    n_phase_flows = int(rep.sum())
                    if n_phase_flows == 0:
                        continue  # no routable member in this phase
                    row_m = np.repeat(np.arange(len(m_sub)), rep)
                    starts = np.zeros(len(m_sub), np.int64)
                    np.cumsum(rep[:-1], out=starts[1:])
                    hop_pos = np.arange(len(row_m)) - starts[row_m]
                    sub_r = m_sub[row_m]
                    r_dpid = hop_dpid[sub_r, hop_pos]
                    last = hop_pos == hop_len[sub_r] - 1
                    r_port = np.where(
                        last, m_fport[row_m], hop_port[sub_r, hop_pos]
                    ).astype(np.int32)
                    r_src = m_src[row_m]
                    r_dst = m_vmac[row_m]
                    r_rew = np.where(last, m_rew[row_m], -1)

                    live = np.isin(r_dpid, dps)
                    scalar = (
                        not self.config.pipelined_install
                        or not hasattr(self.southbound, "flow_mods_batch")
                    )
                    # every figure downstream — the flows metric, the
                    # phase/program events, CollectiveInstall.n_flows —
                    # counts LIVE rows only, consistent with the rows
                    # that actually ship, enter the desired store, and
                    # land in phase_rows for teardown/reconcile
                    n_live = int(live.sum())
                    failed: set[int] = set()
                    arr_rows = np.stack(
                        [
                            r_dpid[live].astype(np.int64),
                            r_src[live].astype(np.int64),
                            r_dst[live].astype(np.int64),
                        ],
                        axis=1,
                    )
                    # one bulk pass over the live rows — C-level int
                    # conversion (tolist), memoized MAC strings, ONE
                    # desired-store transaction — instead of a Python
                    # record() call per (member, hop) row
                    l_dpid = arr_rows[:, 0].tolist()
                    l_src = [
                        _mac_of(k, mac_memo)
                        for k in arr_rows[:, 1].tolist()
                    ]
                    l_dst = [
                        _mac_of(k, mac_memo)
                        for k in arr_rows[:, 2].tolist()
                    ]
                    l_port = r_port[live].tolist()
                    l_rew = [
                        _mac_of(k, mac_memo) if k >= 0 else None
                        for k in r_rew[live].tolist()
                    ]
                    self.recovery.desired.record_many(
                        l_dpid, l_src, l_dst, l_port, l_rew,
                        collective=True,
                    )
                    if scalar:
                        # the pipelined_install=False differential
                        # escape hatch (and batchless southbounds): one
                        # scalar FlowMod per row, permanent —
                        # byte-identical to the batched leg's rows
                        for d, src, dst, port, rewrite in zip(
                            l_dpid, l_src, l_dst, l_port, l_rew
                        ):
                            actions: tuple = (of.ActionOutput(port),)
                            if rewrite:
                                actions = (
                                    of.ActionSetDlDst(rewrite),
                                ) + actions
                            sent = self.southbound.flow_mod(d, of.FlowMod(
                                match=of.Match(dl_src=src, dl_dst=dst),
                                actions=actions,
                                priority=self.config.priority_default,
                            ))
                            if sent is False:
                                failed.add(d)
                    if n_live:
                        _m_flows_installed.inc(n_live)
                        if scalar:
                            verdict = (
                                InstallVerdict(dropped=sorted(failed))
                                if failed else None
                            )
                        else:
                            kd = r_dpid[live]
                            order = np.argsort(kd, kind="stable")
                            # no cookie on the wire: phased teardown and
                            # reconcile re-drive by exact (src, dst)
                            # match rows (phase_rows / desired store),
                            # and a recovery re-drive could not carry a
                            # cookie — rows stay byte-identical across
                            # fresh install, re-drive, and escape-hatch
                            # legs by carrying none anywhere
                            burst = of.FlowModBatch(
                                src=r_src[live][order],
                                dst=r_dst[live][order],
                                out_port=r_port[live][order],
                                rewrite=r_rew[live][order],
                                priority=self.config.priority_default,
                            )
                            verdict = self._send_window(kd[order], burst)
                        if self.config.recovery_plane:
                            # the phase boundary: its barrier xids arm
                            # the pending-ack table and drain while the
                            # next phase reaps (dropped scalar rows
                            # enter the same bounded retry queue)
                            self.recovery.note_send(verdict)

                    # reval index: the FULL ridden set, including
                    # switches whose rows were dead at install time —
                    # a later flap/redial of such a switch is exactly
                    # the delta that must re-route (and heal) this
                    # program, so it updates even for a phase that
                    # shipped NOTHING (all dpids dead needs the healing
                    # index most)
                    ridden_sw = hop_dpid[hop_dpid >= 0]
                    switches.update(
                        int(d) for d in np.unique(ridden_sw)
                    )
                    if not n_live:
                        # nothing shipped (every routed dpid left
                        # self.dps): no rows, no attribution, no phase
                        # event — the same rule as a phase with no
                        # routable member above
                        continue
                    total_flows += n_live
                    a, b = hop_dpid[:, :-1], hop_dpid[:, 1:]
                    ridden = (a >= 0) & (b >= 0)
                    # attribution index: only links a LIVE switch
                    # transmits on — a dead switch's rows never
                    # shipped, so no phase traffic leaves it, and the
                    # congestion report must not resolve a hot link to
                    # a phase with zero flows on it
                    links_p = {
                        lk
                        for lk in zip(
                            a[ridden].astype(int).tolist(),
                            b[ridden].astype(int).tolist(),
                        )
                        if lk[0] in dps_set
                    }
                    links_all.update(links_p)
                    for link in links_p:
                        phase_links.setdefault(link, []).append(plan.phase)
                    phase_rows.append((plan.phase, arr_rows))
                    arr_rows = np.empty((0, 3), np.int64)
                    phase_cong.append(float(routes.max_congestion))
                    _m_sched_phases.inc()
                    _m_sched_phase_install_s.observe(
                        time.perf_counter() - t0
                    )
                    self.bus.publish(
                        ev.EventCollectivePhaseInstalled(
                            cookie, plan.phase, program.n_phases,
                            plan.n_pairs, n_live,
                            float(routes.max_congestion),
                        )
                    )
                finally:
                    psp.end()
        except BaseException:
            # roll the partial program back: tear down every row already
            # shipped (they leave the desired store inside) so the
            # failure leaves no permanent flows that reconcile would
            # re-drive forever. Later phases' still-in-flight device
            # programs are simply abandoned — nothing of theirs reached
            # a switch.
            rollback = [
                row
                for _, arr in phase_rows
                for row in _mac_rows(arr, mac_memo)
            ]
            rollback.extend(_mac_rows(arr_rows, mac_memo))
            rollback = self._program_owned_rows(rollback)
            if rollback:
                self._del_flows_window(rollback)
            raise
        finally:
            sp.end(n_flows=total_flows)
        if total_flows == 0:
            return  # nothing routable: don't record an empty install

        max_phase = max(phase_cong, default=0.0)
        _m_sched_programs.inc()
        _m_sched_completion.set(float(sum(phase_cong)))
        _m_sched_max_phase.set(max_phase)
        self.collectives.add(
            CollectiveInstall(
                cookie, coll_type, tuple(ranks), root_rank,
                policy, macs_str, src_idx, dst_idx,
                n_pairs=len(src_idx), n_flows=total_flows,
                max_congestion=max_phase,
                switches=frozenset(switches),
                links=frozenset(links_all),
                n_phases=program.n_phases,
                phase_links={
                    link: tuple(sorted(set(ps)))
                    for link, ps in phase_links.items()
                },
                phase_rows=phase_rows,
            )
        )
        self.bus.publish(
            ev.EventCollectiveInstalled(
                cookie, coll_type, len(src_idx), total_flows, max_phase,
            )
        )
        log.info(
            "phased block install: collective %s, %d pairs, %d phases, "
            "%d switch flows, completion %s (max phase %s)",
            coll_type, len(src_idx), len(phase_rows), total_flows,
            sum(phase_cong), max_phase,
        )

    def _program_owned_rows(self, rows) -> list:
        """Filter a phased teardown/rollback burst down to the rows the
        program actually OWNS in the desired store: a reactive flow
        byte-identical to a phase row stays FDB-owned under the store's
        first-writer-wins rule, and deleting it here would yank a live
        FDB flow out from under its bookkeeping. Rows already gone from
        the store still delete (switch-side cleanup)."""
        desired = self.recovery.desired.flows
        out = []
        for d, s, t in rows:
            spec = desired.get(d, {}).get((s, t))
            if spec is None or spec.collective:
                out.append((d, s, t))
        return out

    def _remove_collective(self, install: CollectiveInstall) -> None:
        if install.n_phases and install.phase_rows is not None:
            # scheduled installs went through the window plane, not the
            # block plane: no cookie-recorded block entries exist — tear
            # down by the exact per-phase rows (one batched OFPFC_DELETE
            # window; the rows leave the desired store inside)
            memo: dict[int, str] = {}
            self._del_flows_window(
                self._program_owned_rows(
                    row
                    for _, arr in install.phase_rows
                    for row in _mac_rows(arr, memo)
                )
            )
        else:
            self.southbound.flow_blocks_delete(install.cookie)
        self.collectives.remove(install.cookie)
        self.bus.publish(ev.EventCollectiveRemoved(install.cookie))

    # -- flow lifecycle (no reference equivalent; SURVEY §2/§5) -----------

    def _flow_removed(self, event: ev.EventFlowRemoved) -> None:
        """A switch expired one of our flows (idle/hard timeout): drop
        the bookkeeping so the dedup cannot suppress a reinstall, and
        mirror the removal northbound. The switch already deleted its
        entry, so no FlowMod goes south. This is the handler for the
        OFPFF_SEND_FLOW_REM reply the reference requests but never
        consumes (reference: sdnmpi/router.py:61; SURVEY §2 defect)."""
        src, dst = event.match.dl_src, event.match.dl_dst
        if src is None or dst is None:
            return  # not one of the Router's exact-match flows
        if not self.fdb.exists(event.dpid, src, dst):
            return
        log.info(
            "flow expired on %s: %s -> %s (reason %d, %d pkts)",
            event.dpid, src, dst, event.reason, event.packet_count,
        )
        self.fdb.remove(event.dpid, src, dst)
        # the switch expired it on purpose: it is no longer desired
        # either (a reconcile must not resurrect a timed-out flow)
        self.recovery.desired.remove(event.dpid, src, dst)
        self.bus.publish(ev.EventFDBRemove(event.dpid, src, dst))

    def _publish_fdb_removes(self, rows: list[tuple[int, str, str]]) -> None:
        """Mirror a teardown northbound: ONE
        :class:`~sdnmpi_tpu_torch.control.events.EventFDBRemoveBatch` for a
        burst (a revalidation pass or rank exit tears down hundreds of
        rows — per-row events cost one RPC broadcast each), the
        pre-batch per-row :class:`EventFDBRemove` for a single removal.
        Per-row-only consumers attach via ``ev.subscribe_fdb_removes``
        (the compat shim expanding batches)."""
        if not rows:
            return
        if len(rows) == 1:
            self.bus.publish(ev.EventFDBRemove(*rows[0]))
        else:
            self.bus.publish(ev.EventFDBRemoveBatch(list(rows)))

    def _datapath_down(self, event: ev.EventDatapathDown) -> None:
        self.dps.discard(event.dpid)
        self._publish_fdb_removes([
            (event.dpid, src, dst)
            for (src, dst) in self.fdb.fdb.get(event.dpid, {})
        ])
        self.fdb.remove_switch(event.dpid)
        # pending barriers/retries are moot; the DESIRED set survives —
        # it is exactly what the reconciler re-drives on redial
        self.recovery.forget(event.dpid)

    # -- failure-domain recovery (no reference equivalent) --------

    def _datapath_up(self, event: ev.EventDatapathUp) -> None:
        self.dps.add(event.dpid)
        if not self.config.recovery_plane:
            return
        cap = self.config.reconcile_max_per_flush
        if cap > 0 and self._reconcile_spent >= cap:
            # mass-redial storm shaping: this
            # flush window's reconcile budget is spent — park the
            # reconcile; the anti-entropy tick drains the queue at the
            # same cap. The switch serves from its (possibly stale or
            # empty) table meanwhile; reconcile order is arrival order.
            self.recovery.note_reconcile_deferred()
            if event.dpid not in self._reconcile_pending:
                self._reconcile_pending.append(event.dpid)
            return
        self._reconcile_spent += 1
        if event.dpid in self._reconcile_pending:
            # a parked switch bounced and redialed with budget free:
            # this reconcile covers it — don't re-drive from the queue
            self._reconcile_pending.remove(event.dpid)
        self._reconcile_datapath(event.dpid)

    def _reconcile_datapath(self, dpid: int) -> None:
        """Re-drive a returning datapath's entire desired flow set.

        A switch that crashed and redialed comes back with an EMPTY
        flow table; one that merely lost its TCP session kept its flows
        (re-driving is then idempotent — OF 1.0 ADD replaces an
        identical match+priority entry). Either way the switch ends up
        byte-identical to a fresh install of the desired set, through
        the same batched ``flow_mods_window`` path, without waiting for
        packet-ins to fault the flows back in one at a time. Teardowns
        that were unconfirmed when the switch went away re-drive too
        (the lost-delete ledger): the bounced-switch case where stale
        flows survived in the kept table."""
        rows = self.recovery.desired.entries_for(dpid)
        self.recovery.forget(dpid)  # a redial obsoletes prior bookkeeping
        # forget() parked any unconfirmed teardowns; rows re-desired
        # since are covered by the reinstall (ADD replaces the entry)
        lost = [
            (s, d) for (s, d) in sorted(self.recovery.take_lost_deletes(dpid))
            if not self.recovery.desired.has(dpid, s, d)
        ]
        if (not rows and not lost) or dpid not in self.dps:
            return
        log.info(
            "reconciling datapath %#x: re-driving %d desired flows, "
            "%d lost teardowns", dpid, len(rows), len(lost),
        )
        sp = start_span(
            "reconcile", dpid=dpid, n_flows=len(rows), n_lost=len(lost)
        )
        try:
            if lost:
                verdict = self._send_deletes(dpid, lost)
                self.recovery.note_send(
                    verdict, delete_rows={dpid: set(lost)}
                )
            if not rows:
                return
            # the down-edge cleared this switch's FDB rows; restore the
            # bookkeeping the installs below re-create on the switch.
            # Rows installed by the phase scheduler's window plane
            # (spec.collective) re-drive like any other desired row but
            # carry NO SwitchFDB bookkeeping — the collective table
            # owns their lifecycle.
            for src, dst, spec in rows:
                if spec.collective:
                    continue
                if not self.fdb.exists(dpid, src, dst):
                    self.fdb.update(dpid, src, dst, spec.out_port)
                    self.bus.publish(
                        ev.EventFDBUpdate(dpid, src, dst, spec.out_port)
                    )
            self.recovery.note_reconcile(len(rows))
            verdict = self._send_desired(dpid, rows)
            self.recovery.note_send(verdict)
        finally:
            sp.end()

    def _send_deletes(self, dpid: int, rows) -> "InstallVerdict | None":
        """Tear down ``rows`` (``[(src, dst), ...]``) on one switch —
        the retry/reconcile twin of :meth:`_send_desired`, honoring the
        same ``pipelined_install`` escape hatch and batchless-southbound
        fallback as every other send site."""
        if (
            not self.config.pipelined_install
            or not hasattr(self.southbound, "flow_mods_batch")
        ):
            ok = True
            for src, dst in rows:
                if self._del_flow(dpid, src, dst) is False:
                    ok = False
            return InstallVerdict(
                sent=[dpid] if ok else [], dropped=[] if ok else [dpid]
            )

        from sdnmpi_tpu_torch.utils.mac import macs_to_ints

        return self._send_window(
            np.full(len(rows), dpid, np.int64),
            of.FlowModBatch(
                src=macs_to_ints([r[0] for r in rows]),
                dst=macs_to_ints([r[1] for r in rows]),
                out_port=np.zeros(len(rows), np.int32),
                rewrite=None,
                priority=self.config.priority_default,
                command=of.OFPFC_DELETE,
            ),
        )

    def _send_desired(self, dpid: int, rows) -> "InstallVerdict | None":
        """Install ``rows`` (``[(src, dst, FlowSpec), ...]``) on one
        switch through the batched window path; scalar fallback for the
        ``pipelined_install=False`` escape hatch and batchless
        southbounds."""
        if (
            not self.config.pipelined_install
            or not hasattr(self.southbound, "flow_mods_batch")
        ):
            ok = True
            for src, dst, spec in rows:
                actions = (
                    (of.ActionSetDlDst(spec.rewrite),) if spec.rewrite else ()
                )
                if spec.collective:
                    # phase-scheduler rows re-drive PERMANENT (their
                    # fresh install carries no timeouts), same as the
                    # batched leg's collective split below
                    sent = self.southbound.flow_mod(dpid, of.FlowMod(
                        match=of.Match(dl_src=src, dl_dst=dst),
                        actions=actions + (of.ActionOutput(spec.out_port),),
                        priority=self.config.priority_default,
                    ))
                else:
                    sent = self._add_flow(
                        dpid, src, dst, spec.out_port, actions
                    )
                ok = ok and sent is not False
            return InstallVerdict(
                sent=[dpid] if ok else [], dropped=[] if ok else [dpid]
            )

        from sdnmpi_tpu_torch.utils.mac import mac_to_int, macs_to_ints

        # collective rows (the phase scheduler's window plane) installed
        # permanent — splitting the burst keeps the re-drive
        # byte-identical to each row's fresh install when the config
        # carries flow timeouts
        verdict: InstallVerdict | None = None
        for collective in (False, True):
            part = [r for r in rows if r[2].collective is collective]
            if not part:
                continue
            burst = of.FlowModBatch(
                src=macs_to_ints([r[0] for r in part]),
                dst=macs_to_ints([r[1] for r in part]),
                out_port=np.array([r[2].out_port for r in part], np.int32),
                rewrite=np.array(
                    [mac_to_int(r[2].rewrite) if r[2].rewrite else -1
                     for r in part],
                    np.int64,
                ),
                priority=self.config.priority_default,
                idle_timeout=(
                    0 if collective else self.config.flow_idle_timeout
                ),
                hard_timeout=(
                    0 if collective else self.config.flow_hard_timeout
                ),
            )
            _m_flows_installed.inc(len(part))
            v = self._send_window(np.full(len(part), dpid, np.int64), burst)
            if isinstance(v, InstallVerdict):
                if verdict is None:
                    verdict = InstallVerdict()
                verdict.sent += v.sent
                verdict.dropped += v.dropped
                verdict.barriers += v.barriers
            elif verdict is None:
                verdict = v
        if isinstance(verdict, InstallVerdict):
            # restore the InstallVerdict contract across the split: the
            # dpid appears in exactly ONE of sent/dropped, once — both
            # parts failing must not list it twice (note_send would
            # burn two retry attempts per actual failure), and a
            # half-failed split needs the retry (dropped wins)
            dropped = set(verdict.dropped)
            verdict.dropped = sorted(dropped)
            verdict.sent = sorted(set(verdict.sent) - dropped)
        return verdict

    # -- audit-plane heal seams (control/audit.py) ---------------

    def audit_redrive(self, dpid: int, rows) -> None:
        """Targeted repair of confirmed missing / counter-dead rows:
        re-drive EXACTLY these desired rows (``[(src, dst, FlowSpec),
        ...]``) through the reconcile install path — OF 1.0 ADD
        replaces a corrupt entry in place, so one bad row costs one
        row's re-install, never a wipe. Verdicts feed the same
        recovery bookkeeping as any install."""
        if dpid not in self.dps or not rows:
            return
        sp = start_span("audit_redrive", dpid=dpid, n_rows=len(rows))
        try:
            self.recovery.note_reconcile(len(rows))
            verdict = self._send_desired(dpid, rows)
            if self.config.recovery_plane:
                self.recovery.note_send(verdict)
        finally:
            sp.end()

    def audit_delete(self, dpid: int, rows) -> None:
        """Targeted teardown of confirmed orphan rows (``[(src, dst),
        ...]`` — rows the fabric holds that no desired state ever
        recorded). A dropped teardown re-drives as a teardown through
        the recovery plane's delete-carrying retry."""
        if dpid not in self.dps or not rows:
            return
        sp = start_span("audit_delete", dpid=dpid, n_rows=len(rows))
        try:
            verdict = self._send_deletes(dpid, rows)
            if self.config.recovery_plane:
                self.recovery.note_send(
                    verdict, delete_rows={dpid: set(rows)}
                )
        finally:
            sp.end()

    def recovery_tick(self, now: float | None = None) -> None:
        """One anti-entropy pass (per EventStatsFlush — the Monitor's
        cadence, the same edge the utilization plane flushes on): expire
        un-acked barriers into resync retries, then re-drive every due
        retry. Bounded per switch by ``Config.install_retry_max``;
        exhaustion escalates to a full resync (:meth:`_resync_datapath`)
        instead of silent desired/installed divergence."""
        if not self.config.recovery_plane:
            return
        now = time.monotonic() if now is None else now
        # a fresh flush window: the reconcile budget renews and the
        # deferred-reconcile queue drains under the same cap, oldest
        # first (rate-shaped mass-redial recovery)
        self._reconcile_spent = 0
        cap = self.config.reconcile_max_per_flush
        while self._reconcile_pending and (
            cap <= 0 or self._reconcile_spent < cap
        ):
            dpid = self._reconcile_pending.pop(0)
            if dpid not in self.dps:
                continue  # went away again; reconcile-on-up will re-queue
            self._reconcile_spent += 1
            self._reconcile_datapath(dpid)
        if self._resync_due:
            # jitter-deferred wipe-resync republishes: the EventDatapathUp re-drive lands through the
            # same budgeted reconcile path above, staggered by the
            # seeded draw taken at escalation time
            ready = [x for x in self._resync_due if x[0] <= now]
            if ready:
                self._resync_due = [x for x in self._resync_due if x[0] > now]
                for _t, dpid in sorted(ready):
                    if dpid not in self.dps:
                        continue
                    self.bus.publish(ev.EventDatapathUp(dpid))
                    if self.audit is not None:
                        self.audit.request_verify(dpid)
        for dpid, (rows, resync) in self.recovery.expire_barriers(
            now, self.config.barrier_timeout_s
        ).items():
            # the window may or may not have applied — only a re-drive
            # (of the delete rows for a teardown window, of the desired
            # set otherwise) makes the switch's state known again
            if not self.recovery.schedule(
                dpid, now, deletes=rows, resync=resync
            ):
                self._resync_datapath(dpid, now)
        for dpid, retry in self.recovery.pop_due(now):
            if dpid not in self.dps:
                # reconcile-on-up owns dead datapaths; unconfirmed
                # teardowns park in the lost-delete ledger so a bounced
                # switch that KEPT its table still sheds them
                self.recovery.stash_lost_deletes(dpid, retry.deletes)
                continue
            self.recovery.note_retry()
            # the retry re-drive is a root span of its own (no request
            # tree to hang from): flight-recorder bundles show WHICH
            # switch was being re-driven when an anomaly froze
            sp = start_span(
                "recovery_retry", dpid=dpid, resync=retry.resync,
                n_deletes=len(retry.deletes),
            )
            t0 = time.perf_counter()
            ok = True
            deletes = [
                (s, d) for (s, d) in sorted(retry.deletes)
                # a pair re-installed since its dropped teardown is
                # covered by the reinstall (ADD replaced the entry);
                # deleting it now would wipe the fresh flow
                if not self.recovery.desired.has(dpid, s, d)
            ]
            try:
                if deletes:
                    verdict = self._send_deletes(dpid, deletes)
                    if verdict is not None:
                        self.recovery.note_send(
                            verdict, delete_rows={dpid: set(deletes)},
                            reschedule=False,
                        )
                        ok = ok and dpid not in verdict.dropped
                if retry.resync:
                    rows = self.recovery.desired.entries_for(dpid)
                    if rows:
                        self.recovery.note_reconcile(len(rows))
                        verdict = self._send_desired(dpid, rows)
                        if verdict is not None:
                            self.recovery.note_send(
                                verdict, reschedule=False
                            )
                            ok = ok and dpid not in verdict.dropped
                if ok:
                    self.recovery.succeed(dpid)
                elif not self.recovery.schedule(
                    now=now, dpid=dpid, deletes=set(deletes),
                    resync=retry.resync,
                ):
                    self._resync_datapath(dpid, now)
            finally:
                sp.end(ok=ok)
                _m_recovery_redrive_s.observe(time.perf_counter() - t0)

    def _resync_datapath(self, dpid: int, now: float | None = None) -> None:
        """Last-resort escalation after retry exhaustion: wipe the
        switch's flow table with an all-wildcard OFPFC_DELETE (the OF
        1.0 "forget everything" idiom) and republish EventDatapathUp so
        EVERY app re-drives its per-switch state — the TopologyManager
        its bootstrap flows, the ProcessManager its announcement trap,
        this Router the desired set — exactly as on a redial. The
        switch's state is then known-good again regardless of which
        windows it lost.

        The republish is staggered by one seeded jitter draw over the
        retry backoff base (a fabric-wide
        exhaustion storm — or a pair failover — must not re-drive
        every switch in lockstep); with a zero backoff base (the
        synchronous-test posture) it stays immediate."""
        if dpid not in self.dps:
            return
        self.recovery.note_resync()
        log.warning(
            "datapath %#x: retries exhausted; wiping and resyncing", dpid
        )
        # the escalation span: the chaos-soak acceptance asserts a
        # frozen bundle's span trees contain this stage
        sp = start_span("recovery_resync", dpid=dpid)
        try:
            self.southbound.flow_mod(dpid, of.FlowMod(
                match=of.Match(), actions=(), priority=0,
                command=of.OFPFC_DELETE,
            ))
            delay = self.recovery.jitter(self.config.install_retry_backoff_s)
            if delay > 0.0:
                now = time.monotonic() if now is None else now
                self._resync_due.append((now + delay, dpid))
                return  # recovery_tick republishes (+ verify) when due
            self.bus.publish(ev.EventDatapathUp(dpid))
        finally:
            sp.end()
        if self.audit is not None:
            # the escalation no longer trusts the wipe: the audit plane
            # verifies this switch ahead of its round-robin turn on the
            # next sweep (the flow-stats-based table verification)
            self.audit.request_verify(dpid)

    def _effective_dst(self, dst: str) -> str | None:
        """The MAC a flow actually targets: for MPI flows the dst is a
        virtual MAC and the real target is the rank's current host."""
        if not is_sdn_mpi_addr(dst):
            return dst
        try:
            vmac = VirtualMac.decode(dst)
        except ValueError:
            return dst
        return self.bus.request(ev.RankResolutionRequest(vmac.dst_rank)).mac

    def _reval_dirty_set(self):
        """Narrow the next revalidation pass through the epoch gate.

        Returns:
        - an empty set: nothing advanced since the last pass (repeat
          EventTopologyChanged with no TopologyDB version bump and no
          UtilPlane epoch publish) — skip the pass entirely;
        - a non-empty set of dpids: the delta log covers the gap with
          pure link *deletes*, so only flows whose installed paths
          touch one of these switches re-route. Delete narrowing is
          SOUND, not just safe: a pair's chosen shortest path changes
          under a delete only if it rode the deleted link, so its
          installed hops contain both endpoints and the pair is always
          narrowed in — narrowed and full passes leave bit-identical
          FDB/desired state (the differential fence,
          tests/test_delta_reval.py);
        - None: no basis to narrow (first pass, broken/overflowed
          delta log, host/switch membership deltas, the utilization
          plane moved under an unchanged graph, ``Config.delta_reval``
          off, or the gap contains a non-narrowable link ADD) — full
          pass. Adds fall back deliberately: a restored cable can
          shorten flows whose CURRENT detour avoids both of its
          endpoints entirely (a torus neighbor pair's around-the-ring
          detour), so endpoint narrowing would strand stale routes and
          break the narrowed-vs-full bit-identity the escape hatch
          guarantees. The ONE exception: an add interior to
          a single pod of a generator-certified PodMap narrows to that
          pod's member set — the proof lives with
          ``narrowed_dirty_set`` in core/topology_db.py.

        Precedence note: when the graph changed AND the utilization
        plane also moved, the link-delta narrowing still applies — the
        utilization epoch participates only in the skip/no-skip
        decision for an unchanged graph. Utilization-driven
        re-spreading of flows untouched by the link deltas is deferred
        (they would not have re-routed at all without a topology event,
        so this matches the pre-gate steady state); a pass that cannot
        be narrowed re-spreads everything as before.
        """
        try:
            db = self.bus.request(ev.CurrentTopologyRequest()).topology
        except LookupError:
            return None  # minimal stacks without a TopologyManager
        try:
            util_epoch = self.bus.request(ev.UtilEpochRequest()).epoch
        except LookupError:
            util_epoch = -1
        version = getattr(db, "version", None)
        if version is None:
            return None  # duck-typed stand-in without the epoch counter
        last_v, last_u = self._reval_version, self._reval_util_epoch
        self._reval_version = version
        self._reval_util_epoch = util_epoch
        if last_v is None:
            return None  # first pass: no baseline
        if version == last_v:
            # duplicate topology signal; skip unless utilization moved
            return set() if util_epoch == last_u else None
        if not self.config.delta_reval:
            return None  # escape hatch: always the full pass
        deltas_since = getattr(db, "deltas_since", None)
        deltas = deltas_since(last_v) if deltas_since else None
        if deltas is None:
            return None  # log broken (structural) or overflowed
        # ONE copy of the delta-narrowing kind rules, shared with the
        # route cache's invalidation sweep (the proofs live there).
        # The PodMap pair additionally narrows certified intra-pod
        # link ADDS to the pod's member set: an affected
        # flow necessarily has an endpoint inside the pod, and its
        # installed path rides that endpoint switch — always narrowed
        # in, so narrowed == full stays bit-identical.
        from sdnmpi_tpu_torch.core.topology_db import narrowed_dirty_set

        return narrowed_dirty_set(
            deltas, getattr(db, "podmap", None),
            db if hasattr(db, "live_border_set") else None,
        )

    def _revalidate_flows(self) -> None:
        """Recompute installed routes after a topology change; tear down
        hops that no longer lie on the chosen path and eagerly reinstall
        the surviving routes — the control-plane leg of the incremental
        churn dataflow.

        Epoch-gated and delta-narrowed end to end: a pass with neither
        the TopologyDB version nor the UtilPlane epoch advanced is a
        no-op; when the delta log covers the gap with pure link
        deltas (and ``Config.delta_reval``), only the flows whose
        installed paths touch a dirtied switch re-route, and
        block-installed collectives re-route only when the dirtied set
        intersects the switches their installed blocks actually ride.
        Surviving flows re-score through the oracle's delta entry point
        in PIPELINED dispatch/reap windows (window k+1's device compute
        overlaps window k's diff + install), per-pair hop diffs tear
        down and reinstall only the *changed spans*, and both the
        teardown and the reinstall ship as batched windows
        (``_del_flows_window`` / ``_install_window``) instead of scalar
        per-hop FlowMods. A cable flap costs O(affected flows), never a
        re-route of the fabric."""
        dirty = self._reval_dirty_set()
        if dirty is not None and not dirty:
            _m_revalidations_skipped.inc()
            return  # nothing advanced since the last pass
        _m_revalidations.inc()
        # one span tree per revalidation pass: root `reval`
        # with per-chunk reval_rescore/reval_diff/reval_install stages —
        # emitted identically by the pipelined path, the serial
        # (pipelined_install=False) fallback, and the link-add full
        # pass, so traces stay comparable across escape hatches
        rsp = start_span(
            "reval",
            narrowed=dirty is not None,
            n_dirty=0 if dirty is None else len(dirty),
        )
        try:
            self._revalidate_flows_spanned(dirty, rsp)
        finally:
            rsp.end()

    def _revalidate_flows_spanned(self, dirty, rsp) -> None:
        for install in self.collectives:
            if (
                dirty is not None
                and install.switches
                and dirty.isdisjoint(install.switches)
            ):
                continue  # none of its installed blocks ride a dirty switch
            self._remove_collective(install)
            self._reinstall_collective(install)

        flows: dict[tuple[str, str], dict[int, int]] = {}
        for dpid, src, dst, port in self.fdb.entries():
            flows.setdefault((src, dst), {})[dpid] = port
        if dirty is not None:
            flows = {
                pair: hops for pair, hops in flows.items()
                if not dirty.isdisjoint(hops)
            }
        if not flows:
            return

        doomed: list[tuple[int, str, str]] = []  # batched teardown burst
        resolved: list[tuple[tuple[str, str], str]] = []
        for src, dst in flows:
            effective = self._effective_dst(dst)
            if effective is None:
                # the rank behind this vMAC is gone: tear it all down
                for dpid, _ in flows[(src, dst)].items():
                    self.fdb.remove(dpid, src, dst)
                    doomed.append((dpid, src, dst))
                continue
            resolved.append(((src, dst), effective))
        self._publish_fdb_removes(doomed)
        self._del_flows_window(doomed)

        from sdnmpi_tpu_torch.oracle.batch import WindowRoutes

        _m_reval_affected.observe(len(resolved))

        def process(chunk, wr, csp=NULL_SPAN) -> None:
            """Diff + re-drive one reaped window: per-pair hop diffs
            pick the changed spans; the span teardown flushes as ONE
            batched OFPFC_DELETE window BEFORE the reinstall window (a
            rerouted pair's new flow shares the old one's (src, dst)
            match, so a delete landing after the install would wipe the
            fresh entry too), and the reinstall ships through the same
            vectorized window installer the packet-in path uses — the
            FDB dedup inside it keeps surviving hops untouched, so only
            changed spans reach the wire. ``csp`` is the chunk's span;
            the diff and install stages record as its children plus the
            reval_diff/install_seconds histograms."""
            chunk_doomed: list[tuple[int, str, str]] = []
            entries: list[tuple[str, str, str | None]] = []
            try:
                t0 = time.perf_counter()
                dsp = csp.child("reval_diff", n_pairs=len(chunk))
                try:
                    for k, ((src, dst), effective) in enumerate(chunk):
                        installed = flows[(src, dst)]
                        n = int(wr.hop_len[k])
                        new_hops = {
                            int(wr.hop_dpid[k, h]): int(wr.hop_port[k, h])
                            for h in range(n)
                        }
                        for dpid, port in installed.items():
                            if new_hops.get(dpid) != port:
                                self.fdb.remove(dpid, src, dst)
                                chunk_doomed.append((dpid, src, dst))
                        entries.append((
                            src, dst,
                            effective if is_sdn_mpi_addr(dst) else None,
                        ))
                finally:
                    dsp.end(n_changed=len(chunk_doomed))
                    _m_reval_diff_s.observe(time.perf_counter() - t0)
                t0 = time.perf_counter()
                isp = csp.child(
                    "reval_install", n_changed=len(chunk_doomed)
                )
                try:
                    self._publish_fdb_removes(chunk_doomed)
                    self._del_flows_window(chunk_doomed)
                    self._install_window(entries, wr, parent=isp)
                finally:
                    isp.end()
                    _m_reval_install_s.observe(time.perf_counter() - t0)
            finally:
                # a raising stage must not leak the chunk span open —
                # the anomaly bundle frozen FOR that failure needs the
                # (partial) revalidation tree completed, not buffered
                csp.end()
            if wr.touched is not None:
                # device-computed attribution: flows whose new path left
                # the dirty region entirely (they drained off the flap)
                _m_reval_drained.inc(
                    int(np.count_nonzero(~wr.touched & (wr.hop_len > 0)))
                )

        def reap_prev(prev) -> None:
            chunk, window, csp, resc, t_re = prev
            try:
                wr = window.reap()
            except BaseException:
                # raising reap: close the rescore + chunk spans (same
                # hardening the flush loop's fix applied)
                resc.end()
                _m_reval_rescore_s.observe(time.perf_counter() - t_re)
                csp.end()
                raise
            resc.end()
            _m_reval_rescore_s.observe(time.perf_counter() - t_re)
            process(chunk, wr, csp)

        # pipelined re-scoring: windows of coalesce_max_batch pairs
        # double-buffer through the delta dispatch API — window k+1
        # computes on device while window k diffs and installs
        step = max(1, self.config.coalesce_max_batch)
        prev: tuple | None = None  # (chunk, window, csp, rescore span, t0)
        for lo in range(0, len(resolved) + 1, step):
            chunk = resolved[lo : lo + step]
            window = None
            csp = resc = NULL_SPAN
            t_re = 0.0
            if chunk:
                pairs = [(src, eff) for (src, _), eff in chunk]
                csp = rsp.child("reval_window", n_pairs=len(chunk))
                resc = csp.child("reval_rescore")
                t_re = time.perf_counter()
                window = self._dispatch_window(pairs, dirty=dirty)
                if window is None:
                    # serial fallback (pipelining off / minimal stacks):
                    # blocking batch request, same stage spans and
                    # histograms as the pipelined leg
                    if prev is not None:
                        reap_prev(prev)
                        prev = None
                    reply = self.bus.request(
                        ev.FindRoutesBatchRequest(pairs)
                    )
                    resc.end()
                    _m_reval_rescore_s.observe(time.perf_counter() - t_re)
                    process(chunk, WindowRoutes.from_fdbs(reply.fdbs), csp)
                    continue
            if prev is not None:
                reap_prev(prev)
            prev = (chunk, window, csp, resc, t_re) if chunk else None
        if prev is not None:  # last partial chunk (len % step != 0):
            # the trailing empty range slot that would have flushed it
            # only exists when len(resolved) is a step multiple
            reap_prev(prev)

    def _reinstall_collective(self, install: CollectiveInstall) -> None:
        """Re-route a previously installed collective against the current
        topology/process state (used by revalidation and restore). The
        rankdb is re-consulted so moved ranks get their new MACs, and
        ranks that exited since the install are dropped — only the LIVE
        rank subset is reinstalled (pattern pairs touching a dead rank
        are filtered and the survivors remapped onto the live rank
        list), so the new install's record and signature describe what
        is actually on the switches instead of leaking dead ranks."""
        rankdb = self.bus.request(ev.CurrentProcessAllocationRequest()).processes
        alive = np.array(
            [bool(rankdb.get_mac(r)) for r in install.ranks], bool
        )
        if int(alive.sum()) < 2:
            return
        src_idx = np.asarray(install.src_idx)
        dst_idx = np.asarray(install.dst_idx)
        ranks = list(install.ranks)
        if not alive.all():
            keep = alive[src_idx] & alive[dst_idx]
            if not keep.any():
                return
            remap = (np.cumsum(alive) - 1).astype(np.int32)
            src_idx = remap[src_idx[keep]]
            dst_idx = remap[dst_idx[keep]]
            ranks = [r for r, a in zip(ranks, alive) if a]
        self._install_collective_blocks(
            install.coll_type,
            ranks,
            install.root if install.root in ranks else None,
            np.stack([src_idx, dst_idx], axis=1),
            rankdb,
            policy=install.policy,
        )

    def _process_delete(self, event: ev.EventProcessDelete) -> None:
        """Tear down flows addressed to the exited rank's virtual MAC."""
        for install in self.collectives.with_rank(event.rank):
            self._remove_collective(install)
        doomed = []
        for dpid, src, dst, _ in list(self.fdb.entries()):
            if not is_sdn_mpi_addr(dst):
                continue
            try:
                vmac = VirtualMac.decode(dst)
            except ValueError:
                continue
            if vmac.dst_rank == event.rank:
                doomed.append((dpid, src, dst))
        for dpid, src, dst in doomed:
            self.fdb.remove(dpid, src, dst)
        # one EventFDBRemoveBatch + one batched OFPFC_DELETE window for
        # the whole rank exit (the RPC mirror gets one message, not one
        # per torn-down row)
        self._publish_fdb_removes(doomed)
        self._del_flows_window(doomed)

    def reinstall_pairs(self, pairs: list[tuple[str, str]]) -> None:
        """Re-route and install flows for (src, dst) match pairs — used by
        checkpoint restore, where only the pair set is trusted: paths are
        recomputed against the current topology and pushed to the live
        switches, so bookkeeping and switch state stay coherent."""
        resolved: list[tuple[str, str, str]] = []
        for src, dst in pairs:
            effective = self._effective_dst(dst)
            if effective:
                resolved.append((src, dst, effective))
        if not resolved:
            return
        fdbs = self.bus.request(
            ev.FindRoutesBatchRequest([(s, e) for s, _, e in resolved])
        ).fdbs
        for (src, dst, effective), fdb in zip(resolved, fdbs):
            if fdb:
                true_dst = effective if is_sdn_mpi_addr(dst) else None
                self._add_flows_for_path(fdb, src, dst, true_dst)

    # -- snapshots --------------------------------------------------------

    def window_census(self) -> dict:
        """What is mid-air in the install pipeline right now — the
        flight recorder folds this into every frozen bundle
        so an anomaly shows its in-flight context, not just its
        counters."""
        return {
            "pending_routes": len(self._pending),
            "flushing": self._flushing,
            "inflight_windows": _m_inflight.value,
            "pending_barriers": len(self.recovery._pending),
            "retry_queue": sorted(self.recovery._retries),
            "desired_flows": self.recovery.desired.total(),
            "collectives": len(self.collectives),
        }

    def _current_fdb(self, req: ev.CurrentFDBRequest) -> ev.CurrentFDBReply:
        return ev.CurrentFDBReply(self.fdb)

    def _current_collectives(
        self, req: "ev.CurrentCollectivesRequest"
    ) -> "ev.CurrentCollectivesReply":
        return ev.CurrentCollectivesReply(self.collectives)

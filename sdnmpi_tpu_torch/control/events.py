"""Event and request/reply types for the control-plane bus.

Mirrors the reference's Ryu event vocabulary: discovery events
(ryu.topology.event consumed at reference: sdnmpi/topology.py:184-202),
datapath lifecycle (EventOFPStateChange, reference: sdnmpi/router.py:69-81),
packet-in, and the app-level request/reply pairs
(reference: sdnmpi/topology.py:12-56, sdnmpi/process.py:15-50,
sdnmpi/router.py:16-34).

Two deliberate upgrades over the reference:
- ``FindAllRoutesRequest`` actually works here (the reference's reply class
  crashes on an undefined variable and its handler replies with the wrong
  type — sdnmpi/topology.py:48,147).
- ``FindRoutesBatchRequest`` resolves an entire collective's rank-pair
  batch in one oracle call — the request the device backend exists for.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from sdnmpi_tpu_torch.protocol.openflow import Packet


class Event:
    """Base class for async pub/sub events."""


class Request:
    """Base class for sync request/reply exchanges; ``dst`` names the
    app that answers, as in Ryu's send_request addressing."""

    dst: str


class Reply:
    pass


# -- datapath / discovery -------------------------------------------------


@dataclasses.dataclass
class EventDatapathUp(Event):
    dpid: int


@dataclasses.dataclass
class EventDatapathDown(Event):
    dpid: int


@dataclasses.dataclass
class EventSwitchEnter(Event):
    switch: Any


@dataclasses.dataclass
class EventSwitchLeave(Event):
    switch: Any


@dataclasses.dataclass
class EventPortAdd(Event):
    """A known switch grew a port (Ryu's EventPortAdd plays this role).
    Carries the switch's refreshed entity so TopologyDB can upsert its
    port set; deliberately distinct from EventSwitchEnter so the RPC
    mirror does not re-broadcast ``add_switch`` for every cabling change
    (the reference's feed announces a switch once,
    sdnmpi/rpc_interface.py:56-60)."""

    switch: Any


@dataclasses.dataclass
class EventPortDelete(Event):
    """A switch lost a port (cable pulled / admin down): the real
    southbound maps OFPT_PORT_STATUS deletes here (Ryu's EventPortDelete
    role). TopologyManager prunes every link riding the port."""

    dpid: int
    port_no: int


@dataclasses.dataclass
class EventLinkAdd(Event):
    link: Any


@dataclasses.dataclass
class EventLinkDelete(Event):
    link: Any


@dataclasses.dataclass
class EventHostAdd(Event):
    host: Any


@dataclasses.dataclass
class EventTopologyChanged(Event):
    """Coalesced "the graph changed" signal, published once per logical
    mutation (a link with both directed halves, a switch with all its
    links) so flow revalidation runs once, not once per sub-event."""


@dataclasses.dataclass
class EventPacketIn(Event):
    dpid: int
    in_port: int
    pkt: Packet
    buffer_id: int


# -- topology manager (reference: sdnmpi/topology.py:12-56) ---------------


@dataclasses.dataclass
class CurrentTopologyRequest(Request):
    dst = "TopologyManager"


@dataclasses.dataclass
class CurrentTopologyReply(Reply):
    topology: Any


@dataclasses.dataclass
class FindRouteRequest(Request):
    dst = "TopologyManager"
    src_mac: str
    dst_mac: str


@dataclasses.dataclass
class FindRouteReply(Reply):
    fdb: list


@dataclasses.dataclass
class FindAllRoutesRequest(Request):
    dst = "TopologyManager"
    src_mac: str
    dst_mac: str


@dataclasses.dataclass
class FindAllRoutesReply(Reply):
    fdbs: list
    #: True when enumeration stopped at Config.max_enumerated_paths —
    #: ``fdbs`` is a prefix of the (possibly exponential) full path set
    truncated: bool = False


@dataclasses.dataclass
class FindRoutesBatchRequest(Request):
    dst = "TopologyManager"
    pairs: list  # [(src_mac, dst_mac), ...]
    #: routing policy for the batch:
    #: - "shortest": deterministic next-hop paths (cached APSP)
    #: - "balanced": load-aware ECMP spread, seeded with the measured
    #:   link utilization the Monitor feeds the TopologyManager
    #: - "adaptive": UGAL min/non-min — flows may detour through a
    #:   Valiant intermediate when the minimal DAG is congested
    policy: str = "shortest"


@dataclasses.dataclass
class FindRoutesBatchReply(Reply):
    fdbs: list
    #: max directed-link load of the batch's chosen paths (balanced mode)
    max_congestion: float = 0.0


@dataclasses.dataclass
class DispatchRoutesBatchRequest(Request):
    """Split-phase route resolution: the oracle's device program for the
    batch is *launched* and the reply returns immediately with an
    in-flight :class:`~sdnmpi_tpu_torch.oracle.batch.RouteWindow`; the caller
    reaps (host decode) later, overlapping the next window's device
    compute — the dispatch leg of the pipelined install plane
    (control/router.py flush_routes). Same pair/policy contract as
    :class:`FindRoutesBatchRequest`."""

    dst = "TopologyManager"
    pairs: list  # [(src_mac, dst_mac), ...]
    policy: str = "shortest"
    #: dirtied-switch dpid set of the delta-narrowed churn dataflow
    #: (None = plain batch). With ``policy="shortest"`` the oracle
    #: re-scores the pairs against the incrementally-repaired APSP with
    #: the set as a device mask tensor, and the reaped window's
    #: ``touched`` array marks pairs whose new path crosses it — the
    #: Router's drain-attribution telemetry
    #: (TopologyDB.find_routes_batch_delta_dispatch).
    dirty: Any = None


@dataclasses.dataclass
class DispatchRoutesBatchReply(Reply):
    window: Any  # oracle.batch.RouteWindow -> WindowRoutes


@dataclasses.dataclass
class UtilEpochRequest(Request):
    """Published-epoch counter of the device utilization plane (0 when
    no plane is configured). Flow revalidation reads it to skip
    recomputes when neither the topology nor the utilization state
    moved since its last pass (control/router.py)."""

    dst = "TopologyManager"


@dataclasses.dataclass
class UtilEpochReply(Reply):
    epoch: int


@dataclasses.dataclass
class FindCollectiveRoutesRequest(Request):
    """Array-native whole-collective routing: ``macs`` lists the N unique
    endpoints once, ``src_idx``/``dst_idx`` are [F] int indices into it.
    Replaces F per-pair queries with one request whose reply is a
    ``CollectiveRoutes`` (oracle/batch.py) — no per-pair Python objects
    anywhere on the path. This is the scaled form of the seam the
    reference serves one pair at a time (sdnmpi/topology.py:138-142)."""

    dst = "TopologyManager"
    macs: list
    src_idx: Any  # [F] int array
    dst_idx: Any  # [F] int array
    policy: str = "balanced"
    #: device-side phase scheduler leg: not-None routes the
    #: collective as a *phased flow program* — the pair set packs into
    #: phases on device (sdnmpi_tpu_torch/sched) and the reply's ``routes``
    #: is a ``PhasedFlowProgram`` whose per-phase windows are already
    #: dispatched (reap phase k while k+1..K compute). 0 = auto phase
    #: count, > 0 = that many (pow2-rounded). None = the flat
    #: single-shot batch, bit-identical to the pre-scheduler path.
    schedule: Any = None


@dataclasses.dataclass
class FindCollectiveRoutesReply(Reply):
    routes: Any  # oracle.batch.CollectiveRoutes


@dataclasses.dataclass
class BroadcastRequest(Request):
    dst = "TopologyManager"
    pkt: Packet
    src_dpid: int
    src_in_port: int


@dataclasses.dataclass
class BroadcastReply(Reply):
    pass


# -- process manager (reference: sdnmpi/process.py:15-50) -----------------


@dataclasses.dataclass
class EventProcessAdd(Event):
    rank: int
    mac: str


@dataclasses.dataclass
class EventProcessDelete(Event):
    rank: int


@dataclasses.dataclass
class RankResolutionRequest(Request):
    dst = "ProcessManager"
    rank: int


@dataclasses.dataclass
class RankResolutionReply(Reply):
    mac: Optional[str]


@dataclasses.dataclass
class CurrentProcessAllocationRequest(Request):
    dst = "ProcessManager"


@dataclasses.dataclass
class CurrentProcessAllocationReply(Reply):
    processes: Any


# -- router (reference: sdnmpi/router.py:16-34) ---------------------------


@dataclasses.dataclass
class EventFDBUpdate(Event):
    dpid: int
    src: str
    dst: str
    port: int


@dataclasses.dataclass
class EventFlowRemoved(Event):
    """A switch expired a flow (idle/hard timeout) and reported it —
    the OFPFF_SEND_FLOW_REM reply the reference requests on every
    install but never handles (reference: sdnmpi/router.py:61; SURVEY
    §2 defect). The Router consumes it to keep SwitchFDB coherent."""

    dpid: int
    match: Any  # protocol.openflow.Match
    priority: int
    reason: int  # protocol.ofwire.OFPRR_*
    duration_sec: float = 0.0
    packet_count: int = 0
    byte_count: int = 0


@dataclasses.dataclass
class EventBarrierAck(Event):
    """A datapath answered the OFPT_BARRIER_REQUEST terminating one of
    its batched install spans (OpenFlow 1.0 §5.3.7: the switch has
    finished processing everything sent before the barrier). The
    recovery plane (control/recovery.py) treats it as the install's
    end-to-end receipt: ack -> barrier_rtt_seconds sample; no ack
    within Config.barrier_timeout_s -> anti-entropy resync."""

    dpid: int
    xid: int


@dataclasses.dataclass
class EventFDBRemove(Event):
    """Emitted when the router tears down a stale flow (no reference
    equivalent — the reference never removes flows, see SURVEY §2)."""

    dpid: int
    src: str
    dst: str


@dataclasses.dataclass
class EventFDBRemoveBatch(Event):
    """One teardown *burst* — a revalidation pass or rank exit tears
    down hundreds of rows at once, and per-row :class:`EventFDBRemove`
    publishes cost one RPC broadcast each. The Router publishes bursts
    as ONE of these (``rows`` is ``[(dpid, src, dst), ...]``); single
    removals (flow expiry, datapath down of a lone flow) keep the
    per-row event. Subscribers that only understand per-row removals
    attach through :func:`subscribe_fdb_removes` — the compat shim that
    expands batches for them."""

    rows: list  # [(dpid, src, dst), ...]


def subscribe_fdb_removes(bus, handler) -> None:
    """Compat shim: deliver every FDB removal — batched or per-row — to
    a per-row ``handler(EventFDBRemove)``. Existing per-row consumers
    subscribe here instead of to :class:`EventFDBRemove` alone and see
    the exact pre-batching event stream."""
    bus.subscribe(EventFDBRemove, handler)
    bus.subscribe(
        EventFDBRemoveBatch,
        lambda e: [handler(EventFDBRemove(*row)) for row in e.rows],
    )


@dataclasses.dataclass
class EventCollectiveInstalled(Event):
    """A whole collective's flows were block-installed proactively (no
    reference equivalent — the reference decodes the collective type but
    only logs it, sdnmpi/router.py:182). ``cookie`` identifies the
    install for teardown; counts summarize what per-pair FDB events
    would have reported one at a time."""

    cookie: int
    coll_type: int
    n_pairs: int
    n_flows: int  # switch-level flow entries across all blocks
    max_congestion: float


@dataclasses.dataclass
class EventCollectivePhaseInstalled(Event):
    """One phase of a scheduled collective's phased flow program hit
    the wire — the phase-boundary event: its install window
    has been sent (and its barrier xids registered with the recovery
    plane; the ack drains asynchronously while phase+1 reaps).
    ``phase`` ascends 0..n_phases-1 in program order; the final phase
    is followed by the program-level :class:`EventCollectiveInstalled`."""

    cookie: int
    phase: int
    n_phases: int
    n_pairs: int  # rank pairs routed in this phase
    n_flows: int  # switch-level flow entries this phase installed
    max_congestion: float  # the phase's discrete max-link load


@dataclasses.dataclass
class EventCollectiveRemoved(Event):
    cookie: int


@dataclasses.dataclass
class CurrentFDBRequest(Request):
    dst = "Router"


@dataclasses.dataclass
class CurrentFDBReply(Reply):
    fdb: Any


@dataclasses.dataclass
class CurrentCollectivesRequest(Request):
    dst = "Router"


@dataclasses.dataclass
class CurrentCollectivesReply(Reply):
    collectives: Any  # core.collective_table.CollectiveTable


# -- telemetry ------------------------------------------------------------


@dataclasses.dataclass
class TelemetryRequest(Request):
    """Snapshot of the control-plane telemetry registry (counters,
    gauges, histograms, oracle latency summary). Provided by the
    Controller; the RPC mirror requests one per Monitor pass
    (EventStatsFlush) and broadcasts it as ``update_telemetry`` so the
    visualizer and the Prometheus text exposition (api/telemetry.py)
    always report the same values from the same registry."""

    dst = "Controller"


@dataclasses.dataclass
class TelemetryReply(Reply):
    telemetry: dict


@dataclasses.dataclass
class SpanTreeRequest(Request):
    """Resolve one span id to the completed span tree containing it —
    the pull half of exemplar resolution: a Prometheus
    histogram bucket's exemplar span id comes back as the full request
    trace from the flight recorder. Provided by the Controller;
    ``tree`` is None when the id fell out of the bounded ring (or no
    recorder is armed)."""

    dst = "Controller"
    span_id: int


@dataclasses.dataclass
class SpanTreeReply(Reply):
    tree: Optional[dict]


@dataclasses.dataclass
class FlightDumpRequest(Request):
    """Freeze a diagnostic bundle NOW (trigger="manual") — the pull-
    mode twin of the anomaly triggers' automatic freeze. Provided by
    the Controller; the bundle is {} when no recorder is armed."""

    dst = "Controller"


@dataclasses.dataclass
class FlightDumpReply(Reply):
    bundle: dict


@dataclasses.dataclass
class TimelineRequest(Request):
    """The metrics timeline's queryable history
    (utils/timeline.py): ``{series: {name: [[ts, value], ...]}, ...}``
    over the bounded multi-resolution ring — minutes of per-flush
    metric history beside the flight recorder's short trigger window.
    ``names`` filters to specific series (None = everything). Provided
    by the Controller; the ``timeline()`` pull RPC rides it."""

    names: Optional[list] = None
    dst = "Controller"


@dataclasses.dataclass
class TimelineReply(Reply):
    timeline: dict


@dataclasses.dataclass
class TrafficMatrixRequest(Request):
    """The published measured traffic matrix
    (oracle/trafficplane.py): per-tenant src->dst byte rates recovered
    from the audit plane's flow-stats deltas, pod-aggregated under the
    hierarchical oracle. Provided by the Controller; the
    ``traffic_matrix()`` pull RPC rides it. Cells are
    ``[tenant, src_endpoint, dst_endpoint, bps]``; mode is "off" when
    the plane is disabled."""

    dst = "Controller"


@dataclasses.dataclass
class TrafficMatrixReply(Reply):
    matrix: dict


@dataclasses.dataclass
class CongestionReportRequest(Request):
    """The device-side congestion analytics of the latest Monitor pass:
    top-k hot links, per-collective attribution (which
    installed collectives ride them), and the discrete-vs-fractional
    congestion figures. Provided by the TopologyManager; {} before the
    first analytics pass (or without a utilization plane)."""

    dst = "TopologyManager"


@dataclasses.dataclass
class CongestionReportReply(Reply):
    report: dict


@dataclasses.dataclass
class EventAnomaly(Event):
    """The flight recorder froze a diagnostic bundle: an anomaly
    trigger fired (latency threshold, p99 regression, recovery
    escalation, barrier timeout). ``summary`` is the bundle minus its
    bulky members (span trees / snapshots stay in the recorder and the
    dump file at ``path``); the RPC mirror broadcasts it as an
    ``anomaly`` notification."""

    trigger: str
    summary: dict
    path: Optional[str] = None


# -- monitor --------------------------------------------------------------


@dataclasses.dataclass
class EventPortStats(Event):
    """Per-port throughput sample (the reference logs these as TSV,
    sdnmpi/monitor.py:87-88; here they also feed the congestion tensor)."""

    dpid: int
    port_no: int
    rx_pps: float
    rx_bps: float
    tx_pps: float
    tx_bps: float


@dataclasses.dataclass
class EventStatsFlush(Event):
    """End of one Monitor sampling pass: every EventPortStats of the
    pass has been published. Utilization consumers use this edge to
    flush their staged samples as ONE vectorized batch (the device
    utilization plane scatters once per pass, not once per port)."""


# -- active/active replica pair --------------------------------


@dataclasses.dataclass
class EventPeerLeaseExpired(Event):
    """A peer replica's lease lapsed (no heartbeat for the timeout):
    this controller is about to adopt its shards. Flight-recorder
    breadcrumb for the failover timeline."""

    replica: int


@dataclasses.dataclass
class EventShardAdopted(Event):
    """One shard of the switch partition changed hands: ``replica``
    now serves ``shard`` at the bumped fencing ``epoch`` — every
    subsequent FlowMod to the shard carries the new epoch cookie."""

    shard: int
    epoch: int
    replica: int


@dataclasses.dataclass
class EventSnapshotColdStart(Event):
    """A checkpoint restore was abandoned (version or digest mismatch)
    and the controller is starting cold instead of crash-looping —
    reactive discovery re-teaches it the fabric."""

    reason: str


@dataclasses.dataclass
class ReplicaStatusRequest(Request):
    """The replica plane's replication/failover posture: ownership
    map, sequence numbers, lag, lease state. Provided by the
    Controller; the ``replica_status`` pull RPC rides it. Mode is
    "off" on a single controller (``--replica-peer`` unset)."""

    dst = "Controller"


@dataclasses.dataclass
class ReplicaStatusReply(Reply):
    status: dict

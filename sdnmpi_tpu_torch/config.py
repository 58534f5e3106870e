"""Framework configuration.

The reference scatters its knobs across hard-coded constants (UDP port 61000
at sdnmpi/process.py:70,103 and sdnmpi/topology.py:128; flow priorities
0xffff/0xfffe at sdnmpi/process.py:78 and sdnmpi/topology.py:91,107;
MONITOR_INTERVAL at sdnmpi/monitor.py:24) and selects behavior by which apps
``ryu-manager`` loads. Here everything is one dataclass.

Counterpart of ``sdnmpi_tpu/config.py``, field for field and default
for default, with two changes: ``oracle_backend`` is ``"torch"`` (the
port's oracle) or ``"py"``, and ``device`` names where the torch oracle
(and the measured traffic matrix) runs.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass
class Config:
    # --- wire protocol ---------------------------------------------------
    #: UDP destination port of the MPI process announcement sideband
    #: (reference: sdnmpi/process.py:70).
    announcement_port: int = 61000

    # --- flow priorities (reference: process.py:78, topology.py:91,107) --
    #: announcement -> controller and IPv6-multicast drop rules
    priority_control: int = 0xFFFF
    #: broadcast -> controller rule
    priority_broadcast: int = 0xFFFE
    #: normal unicast path rules (OFP_DEFAULT_PRIORITY in the reference,
    #: sdnmpi/router.py:60)
    priority_default: int = 0x8000

    # --- monitoring ------------------------------------------------------
    #: seconds between port-stats polls (reference: sdnmpi/monitor.py:24)
    monitor_interval: float = 1.0

    # --- flow lifecycle --------------------------------------------------
    #: idle/hard timeouts for installed routing flows, in seconds
    #: (0 = permanent — the reference's only mode, sdnmpi/router.py:59).
    #: Nonzero values make switches expire flows and report
    #: EventFlowRemoved, which the Router consumes to keep the FDB
    #: coherent — cashing the OFPFF_SEND_FLOW_REM the reference sets
    #: but never handles (SURVEY §2 defect).
    flow_idle_timeout: int = 0
    flow_hard_timeout: int = 0

    # --- oracle ----------------------------------------------------------
    #: routing backend: "torch" (device tensors, batched) or "py"
    #: (pure-Python BFS used for differential testing)
    oracle_backend: Literal["torch", "py"] = "torch"
    #: device of the torch oracle: "cuda" (the default; raises without
    #: a card) or "cpu", which runs every kernel's plain version
    device: str = "cuda"
    #: pad switch count to the next multiple of this
    switch_pad_multiple: int = 8
    #: upper bound on shortest-path hop count (RouteOracle/apsp_distances);
    #: the BFS exits earlier when the frontier converges, so
    #: this is a safety bound, not a cost. 0 = no bound (iterate up to V).
    max_diameter: int = 0
    #: maximum hops materialized when reconstructing a path into an fdb
    max_path_len: int = 32
    #: cap on FindAllRoutes equal-cost path enumeration — the path count
    #: is exponential in rich DAGs (a k-ary fat-tree pair alone has
    #: (k/2)^2), so the walk stops here and FindAllRoutesReply.truncated
    #: reports that the list is partial
    max_enumerated_paths: int = 1024
    #: weight of link utilization when scoring congestion-aware routes
    congestion_alpha: float = 1.0
    #: keep the measured-utilization state device-resident
    #: (oracle/utilplane.py): Monitor samples scatter into a persistent
    #: [V, V] tensor maintained through the topology delta log, and the
    #: balanced/adaptive/collective base cost becomes a pure device
    #: expression — no per-call host rebuild or [V, V] upload. Only
    #: meaningful with the torch backend; False falls back to the host
    #: dict rebuild (the differential-testing path).
    util_plane: bool = True
    #: EWMA weight of each fresh Monitor sample folded into the
    #: device-resident utilization plane: ``u' = (1-a)*u + a*sample``.
    #: 1.0 (default) is pure replacement — bit-identical to the host
    #: rebuild from the raw sample dict; lower values smooth bursty
    #: counters at the cost of reaction latency. Applied per flushed
    #: sample batch (the Monitor's own delta cadence), not per second.
    util_ewma_alpha: float = 1.0
    #: nominal link capacity used to normalize the Monitor's bps samples
    #: into flow-equivalent units before they enter the balancer's score
    link_capacity_bps: float = 10e9
    #: how many parallel sub-flows an aggregated (edge, edge) switch pair
    #: is split into for ECMP spreading in balanced batch routing
    ecmp_ways: int = 4
    #: when an MPI packet of a known collective arrives, pre-route and
    #: install flows for EVERY rank pair of that collective in one
    #: load-balanced oracle batch (the north-star behavior; the reference
    #: routes one pair per packet-in)
    proactive_collectives: bool = True
    #: device chunk size for the balanced-routing scan
    ecmp_chunk: int = 4096
    #: sub-flow count at or above which balanced batches route through
    #: the DAG balancer + path sampler (kernel K2) (oracle/dag.py, the
    #: flagship fast path) instead of the greedy scanner
    dag_flow_threshold: int = 512
    #: congestion-reweighting rounds of the DAG balancer
    balance_rounds: int = 2
    #: shard the flagship DAG balancer + sampler over the first N local
    #: devices (shardplane.route_collective_sharded): the traffic's
    #: destination axis and the flow batch split across the mesh with
    #: one psum per balance round. 0 = single-device. Hash streams are
    #: keyed by global flow id, so sampled paths match the single-device
    #: engine exactly when link loads sum exactly in f32 (idle fabrics,
    #: dyadic splits); under measured utilization the psum's reduction
    #: order can differ by ulps from the single-device matmul, which may
    #: flip a near-tied Gumbel choice (see shardplane/routes.py contract).
    mesh_devices: int = 0
    #: promote the mesh from a DAG-engine accelerator to the
    #: FULL pod-scale sharded oracle backend (sdnmpi_tpu_torch/shardplane): the refresh's APSP distance AND next-hop tensors
    #: row-shard across every device of the ``mesh_devices`` mesh, and
    #: the shortest-path window extraction joins the balanced/adaptive/
    #: collective legs in partitioning its flow batch over the mesh —
    #: with per-host readback staying packed (compact WindowRoutes
    #: struct arrays, never an [F, V] gather). Requires
    #: ``mesh_devices`` > 0 (ignored with a warning otherwise). Default
    #: OFF: the single-chip oracle path is byte-identical to the
    #: pre-shardplane controller (pinned by tests/test_shardplane.py).
    shard_oracle: bool = False
    #: shardplane exchange through kernel K3 (kernels/ring.py): the
    #: row-sharded [V, V] distance/next-hop tensors are re-replicated by
    #: the all-gather kernel with distances packed to a 2-byte wire
    #: (bit-exact for hop counts <= 256 — every generator topology).
    #: Requires ``shard_oracle`` (ignored with a warning otherwise).
    #: Default OFF; with the knob ON routes stay bit-identical to the
    #: gather path (tests/test_torch_shardplane.py pins both).
    ring_exchange: bool = False
    #: hierarchical two-level oracle (oracle/hier.py +
    #: shardplane/hier.py): replace every dense [V, V] plane with
    #: dense per-pod blocks (the topology's PodMap annotation, or a
    #: partitioner fallback) plus a compressed border-skeleton layer
    #: composed at route time — O(pods x pod_size^2) memory instead of
    #: O(V^2), which is what routes a 65k-switch fabric on an 8-chip
    #: slice (bench config 15). Path LENGTHS stay bit-identical to the
    #: dense oracle (next-hop ties may differ; the fence in
    #: tests/test_hier.py); with ``mesh_devices`` the pod blocks and
    #: border rows shard one block-shard per device, and
    #: ``ring_exchange`` moves the border-distance plane over the
    #: ring. Default OFF: the dense oracle path is
    #: byte-identical (pinned).
    hier_oracle: bool = False
    #: partitioner pod-size target for fabrics without a PodMap
    #: annotation (0 = ~sqrt(V) auto — balances pod blocks against the
    #: border skeleton)
    hier_pod_target: int = 0
    #: fused hier serving path: composition (the three-way
    #: min + border steering) runs as ONE jitted kernel over the
    #: concatenated border-row plane, and paths materialize through
    #: the batched host walk (oracle/hierpath.py) instead of per-pair
    #: chases. Bit-identical routes either way (fenced); False is the
    #: scalar escape hatch. No CLI flag — config/TopologyDB knob only.
    hier_fused: bool = True
    #: precompile the hier pow2 program ladder (row-sweep rungs +
    #: composition buckets) during warm_serving, so steady hier serving
    #: never traces (pairs with ``warm_serving`` and the
    #: persistent compile cache)
    hier_warm: bool = True
    #: persist the hier border-distance row plane through api/snapshot
    #: beside the route-cache memo (topology-digest guarded on
    #: restore); a restarted controller inherits the warm level-2
    #: plane instead of re-sweeping it
    hier_snapshot: bool = True
    #: rank-pair count at or above which a proactive collective install
    #: uses the array-native block path (int MAC keys, shared
    #: FlowPathBlocks, one event per collective) instead of the
    #: reference-shaped per-pair path (string MACs, per-pair dedup,
    #: per-hop FDB events)
    block_install_threshold: int = 4096
    #: routing policy for proactive collective batches: "balanced"
    #: (load-aware ECMP — right for fat-trees) or "adaptive" (UGAL
    #: min/non-min — right for low-diameter topologies like dragonfly)
    #: or "shortest" (deterministic next-hop paths)
    collective_policy: Literal["balanced", "adaptive", "shortest"] = "balanced"
    #: device-side collective phase scheduler
    #: (sdnmpi_tpu_torch/sched): decompose each block-installed collective
    #: into K link-load-balanced phases (greedy packing over the
    #: UtilPlane's per-switch load, on the device) and install the resulting
    #: phased flow program phase by phase through the pipelined install
    #: plane with barrier-acked phase boundaries — the scheduled
    #: program's summed max-link congestion approaches the flat batch's
    #: fractional bound (~1.11x vs ~1.5x single-shot at the config-3
    #: shape). Default OFF: the single-shot install path is
    #: bit-identical to the pre-scheduler controller (pinned by
    #: differential test).
    schedule_collectives: bool = False
    #: requested phase count for scheduled collectives (pow2-rounded up,
    #: see sched.choose_n_phases); 0 = auto (K=4, K=2 for collectives
    #: with too few traffic groups to fill 4 phases)
    schedule_phases: int = 0
    #: UGAL: Valiant intermediate candidates sampled per flow
    ugal_candidates: int = 4
    #: UGAL: detour hysteresis — a detour must beat the minimal DAG cost
    #: by more than this to be taken (idle fabrics route 100% minimal)
    ugal_bias: float = 1.0
    #: incremental path oracle: when the TopologyDB's delta log covers
    #: the gap since the oracle's cached version with at most this many
    #: link-level deltas, the cached distance/next-hop tensors are
    #: REPAIRED in place (oracle/incremental.py — one-pivot relaxation
    #: for adds, column-restricted Jacobi re-relaxation for removes)
    #: instead of rerunning the full Floyd–Warshall-style recompute.
    #: Above the threshold — or when the delta log was broken by a
    #: structural mutation — the full kernel runs. 0 disables repair.
    delta_repair_threshold: int = 8
    #: end-to-end incremental churn dataflow: flow
    #: revalidation after a topology delta narrows to the flows whose
    #: installed paths touch a dirtied switch, re-scores them through
    #: the oracle's delta entry point (dirty set as a device mask
    #: tensor, batch riding the incrementally-repaired APSP), diffs
    #: per-pair hop spans, and re-drives only the changed spans through
    #: the batched install windows. False restores the full
    #: re-route-everything pass (the differential-testing escape hatch:
    #: narrowed and full passes must leave bit-identical FDB + desired
    #: state — asserted in tests/test_delta_reval.py).
    delta_reval: bool = True
    #: coalesce concurrent route lookups (unicast + MPI packet-ins)
    #: into one padded batched oracle call instead of one device
    #: dispatch per packet-in. Flushed when the southbound goes idle
    #: (Fabric.on_idle), when the pending batch reaches
    #: ``coalesce_max_batch``, or when ``coalesce_window_s`` elapses
    #: between enqueues. Off by default: direct per-packet replies
    #: preserve the reference's synchronous packet-in contract.
    coalesce_routes: bool = False
    #: pending-route count that forces an immediate coalescer flush
    coalesce_max_batch: int = 256
    #: max seconds a pending route lookup may wait for more batch
    #: companions before an enqueue triggers the flush itself
    coalesce_window_s: float = 0.005
    #: split-phase pipelined install plane (control/router.py): coalesced
    #: windows resolve through the oracle's non-blocking dispatch API
    #: (DispatchRoutesBatchRequest), window k+1's device compute overlaps
    #: window k's host decode + install, and each window's FlowMods are
    #: materialized as numpy struct arrays feeding the batched wire
    #: encoder (protocol/ofwire.encode_flow_mods_batch) — one send per
    #: switch instead of one per hop. False restores the serial
    #: resolve-then-install loop (the differential-testing path).
    pipelined_install: bool = True
    # --- serving plane ----------------------------------------
    #: memoized route cache in front of the oracle
    #: (oracle/routecache.py): completed route windows and collective
    #: results keyed by (policy, UtilPlane epoch, pair-set digest) and
    #: invalidated through the TopologyDB delta log — a link flap
    #: evicts only entries whose stored routes rode the deleted link;
    #: adds and membership changes clear. A hit bypasses the oracle
    #: dispatch entirely and feeds the install plane the stored window,
    #: bit-identical to a miss by construction. False restores the
    #: uncached dispatch path byte-identically (the differential escape
    #: hatch, pinned by tests/test_routecache.py).
    route_cache: bool = True
    #: LRU capacity of the route cache (entries; evictions counted in
    #: route_cache_evictions_total)
    route_cache_max_entries: int = 4096
    #: per-tenant admission rate for packet-ins, requests/second
    #: (control/admission.py): each tenant (source MACs grouped by
    #: Router.admission.assign; ungrouped MACs tenant as themselves)
    #: refills one token bucket at this rate and requests past it drop
    #: at the door, so one tenant's alltoall storm cannot grow the
    #: route queue without bound for everyone else. 0 (default) admits
    #: everything — the pre-serving-plane behavior.
    admission_rate: float = 0.0
    #: token-bucket burst depth of the admission gate (requests a
    #: quiet tenant may fire back-to-back before rate limiting bites)
    admission_burst: float = 32.0
    #: weighted fair queueing between BULK tenants in the two-class
    #: coalescer: tenant name -> weight. When a
    #: window's latency-sensitive entries leave room for bulk
    #: (collective-member) lookups, the room is split across the bulk
    #: tenants PRESENT in the backlog proportionally to their weights
    #: (unlisted tenants weigh 1.0), each tenant served in its own
    #: arrival order — one tenant's alltoall storm can no longer
    #: monopolize every bulk slot of every window. The
    #: latency-sensitive class is untouched, and the empty default is
    #: byte-identical to the arrival-order bulk fill (pinned by
    #: tests/test_serving.py).
    coalesce_wfq_weights: dict = dataclasses.field(default_factory=dict)
    #: persistent kernel build directory ("" = the package's own
    #: kernels/build/): the CUDA kernels built with nvcc are written
    #: there under a digest of their source and flags, and a restarted
    #: controller loads them instead of building again
    #: (oracle/engine.enable_compile_cache)
    compile_cache_dir: str = ""
    #: run RouteOracle.warm_serving at launch: build the kernels and
    #: run the serving path (APSP refresh + the window-extraction
    #: buckets) against the booted topology BEFORE the first request
    #: arrives (with compile_cache_dir, loading the built kernels)
    warm_serving: bool = False

    # --- SLO plane (control/slo.py) -----------------------------
    #: per-tenant serving objectives: ``{tenant: (p99_ms,
    #: availability)}`` (CLI: repeatable ``--slo-target
    #: tenant:p99_ms[:avail]``). Non-empty arms the SLO plane: the
    #: Router feeds ``slo_route_latency_seconds{tenant=...}`` at window
    #: completion for targeted tenants, and (with the flight recorder)
    #: one multi-window burn-rate trigger per tenant freezes a
    #: diagnostic bundle naming the burning tenant and the dominant
    #: pipeline stage. Empty (default) costs the Router one is-None
    #: test per window — the unarmed contract.
    slo_targets: dict = dataclasses.field(default_factory=dict)
    #: burn-rate factor both windows must exceed for the SLO trigger
    #: to fire (burn 1.0 = spending the error budget exactly on
    #: schedule; the SRE workbook's fast-window factors are O(10))
    slo_burn_factor: float = 8.0
    #: slow-window depth in Monitor flushes (the fast window is always
    #: the last flush interval): both windows are flush-cadence-
    #: relative, so the alert scales with the Monitor interval instead
    #: of assuming wall-clock minutes
    slo_slow_flushes: int = 12

    # --- metrics timeline (utils/timeline.py) -------------------
    #: keep the bounded multi-resolution ring of compact registry rows
    #: (one per EventStatsFlush): minutes of queryable metric history
    #: at bounded memory, served by the ``timeline()`` pull RPC and
    #: exported as Perfetto counter tracks beside the span slices.
    #: Distinct from the flight recorder's short trigger-baseline
    #: window. False drops the per-flush row entirely.
    metrics_timeline: bool = True
    #: rows per timeline resolution level (3 levels, decimation 4:
    #: level 0 holds this many flushes at full cadence, level 2 covers
    #: 16x the span at 1/16 the resolution)
    timeline_points: int = 512

    # --- anomaly-armed profiler capture (utils/devprof.py) ------
    #: directory for anomaly-armed ``torch.profiler`` capture windows
    #: ("" = off): when a flight-recorder trigger fires, the device
    #: profiler records for ``profile_capture_s`` seconds — the
    #: profile OF the incident, with zero steady-state overhead
    #: (--profile-dump DIR)
    profile_dump_dir: str = ""
    #: capture-window length in seconds (closed on the next Monitor
    #: flush past the deadline)
    profile_capture_s: float = 3.0

    #: backpressure cap for batched FlowMod sends: a per-switch burst is
    #: written to the wire in slices of at most this many bytes, with
    #: the stalled-peer write-buffer check re-run between slices — one
    #: giant install cannot overshoot the disconnect threshold by more
    #: than a slice, and once a peer is cut the remainder of its burst
    #: is dropped instead of written into the dead transport
    #: (control/southbound.py)
    install_highwater: int = 256 * 1024
    #: wall-clock seconds after which a link with no fresh Monitor
    #: sample decays toward zero in the device utilization plane (its
    #: value halves on each flush past the horizon) — a silently dying
    #: monitor must not pin its last reading into the balancer forever
    #: (oracle/utilplane.py). 0 disables decay (keep-last-sample
    #: semantics, bit-identical to the host dict rebuild).
    util_stale_horizon_s: float = 0.0

    # --- fabric audit plane (control/audit.py) ------------------
    #: continuous ground-truth audit of the fabric: per EventStatsFlush
    #: a shard of the switch space answers OFPST_FLOW, the replies
    #: canonicalize, and the audit diffs them against the
    #: DesiredFlowStore three ways (missing desired rows, orphan rows
    #: the store never recorded, counter-dead rows that should carry
    #: traffic), healing confirmed divergence through the
    #: reconcile path as TARGETED re-drives (one row, not a wipe).
    #: Only arms when the southbound can answer flow stats. False
    #: restores the trust-the-install posture byte-identically.
    fabric_audit: bool = True
    #: switches audited per EventStatsFlush (the sweep's pacing cursor,
    #: the install_highwater round-robin idiom at the stats plane: a
    #: 1024-switch fabric audits in bounded per-flush slices instead of
    #: one burst). 0 = the whole fabric every flush.
    audit_switches_per_flush: int = 64
    #: consecutive sweeps a suspected divergence must survive before it
    #: is CONFIRMED (counted + healed + bundle-frozen). 2 (default)
    #: absorbs one-sweep transients — a packet-out-bypassed first
    #: packet, an install racing the sweep; 1 confirms table-visible
    #: kinds (missing/orphan) immediately. Counter-dead always needs
    #: >= 2 sightings: one flat-while-pair-advanced interval is what
    #: ordinary traffic cessation looks like.
    audit_confirm_sweeps: int = 2

    # --- measured traffic plane + route sentinel ---------------
    #: device-resident per-tenant src->dst byte-rate matrix
    #: (oracle/trafficplane.py) fed by the audit plane's per-row counter
    #: deltas — one jitted bucket-padded EWMA scatter per sweep, the
    #: UtilPlane idiom applied to MEASURED traffic. Pod-aggregated under
    #: ``hier_oracle`` so the matrix scales to the 65k-switch fabric.
    #: Arms only when the audit plane armed (it is the ingest source).
    traffic_plane: bool = True
    #: EWMA fold of each flush's measured rates into the matrix
    #: (``r' = (1 - a) * r + a * sample``). 1.0 (default) is pure
    #: replacement — the matrix equals the last sweep interval's
    #: measured rates bit-exactly (the soak fence); < 1 smooths bursts.
    traffic_ewma_alpha: float = 1.0
    #: installed routes re-scored per stats flush by the shadow
    #: route-quality sentinel (control/sentinel.py): a round-robin
    #: sample is re-routed through the oracle's balanced batch dispatch
    #: (pow2-bucketed — bounded trace space) and the measured matrix is
    #: projected onto installed vs fresh paths. 0 = the whole installed
    #: population every flush.
    sentinel_sample_per_flush: int = 64
    #: measured-vs-modeled divergence ratio (hottest measured link load
    #: under the INSTALLED path assignment / under a fresh oracle
    #: optimum for the same measured traffic) at which the sentinel
    #: confirms the routes no longer fit the traffic: counts
    #: ``sentinel_divergence_total{tenant}`` and freezes a flight
    #: bundle naming the worst (tenant, collective, pod-pair).
    sentinel_divergence_factor: float = 2.0
    #: let the sentinel re-drive the worst diverging pair through the
    #: install plane when divergence confirms. Default OFF: the channel
    #: observes only and never mutates routing unless the operator opts in.
    sentinel_heal: bool = False

    # --- recovery plane (control/recovery.py) --------------------
    #: master switch for the failure-domain recovery plane: desired-flow
    #: reconciliation on EventDatapathUp, the bounded install retry
    #: queue, and the anti-entropy pass per EventStatsFlush. False
    #: restores the fire-and-forget legacy (the differential-testing
    #: path); the desired store is still maintained either way, so
    #: flipping the flag live loses no state.
    recovery_plane: bool = True
    #: terminate every batched install window with an
    #: OFPT_BARRIER_REQUEST per switch span — the barrier reply is the
    #: install's end-to-end receipt (EventBarrierAck -> the
    #: barrier_rtt_seconds histogram); a window whose ack never arrives
    #: is re-driven by the anti-entropy pass. False sends bare windows
    #: (the pre-recovery wire byte stream).
    install_barriers: bool = True
    #: seconds an install window may await its barrier ack before the
    #: anti-entropy pass treats it as lost and resyncs the switch
    barrier_timeout_s: float = 2.0
    #: cap on datapath-up reconciles served per Monitor flush window:
    #: a power-cycled pod
    #: redialing all at once otherwise re-drives every switch's desired
    #: set in one synchronous burst and floods the install plane.
    #: Reconciles past the cap defer to following flush ticks
    #: (reconcile_deferred_total counts them, FIFO order preserved).
    #: 0 = unshaped (reconcile immediately on EventDatapathUp).
    reconcile_max_per_flush: int = 0
    #: bounded retries per switch for dropped/un-acked install windows;
    #: exhaustion escalates to a full datapath resync (table wipe +
    #: EventDatapathUp re-drive) instead of silent divergence
    install_retry_max: int = 4
    #: base of the retry queue's exponential backoff (doubles per
    #: attempt, +25% seeded jitter so a fabric-wide fault does not
    #: re-drive every switch in lockstep)
    install_retry_backoff_s: float = 0.25
    #: controller-side echo keepalive period for real TCP datapaths
    #: (control/southbound.py): a half-open peer otherwise stays
    #: "connected" forever and EventDatapathDown never fires. 0
    #: disables probing.
    echo_interval_s: float = 15.0
    #: seconds without an OFPT_ECHO_REPLY before a probed datapath is
    #: aborted (echo_timeouts_total counts the kills)
    echo_timeout_s: float = 45.0

    # --- active/active controller pair (control/replica.py) -----
    #: peer controller's RPC WebSocket URL ("" = single controller: no
    #: replica plane is constructed and the serving path is unchanged —
    #: the default-off acceptance pin)
    replica_peer: str = ""
    #: replicas in the pair (the ownership partition's modulus); the
    #: plane is built for N but the shipped transports wire a pair
    replica_count: int = 2
    #: this replica's index in the mesh's (process_index, id) order;
    #: -1 derives it from the torch.distributed rank (ownership.mesh_replica_index)
    replica_index: int = -1
    #: lease heartbeat period, riding the EventStatsFlush/echo cadence
    replica_lease_interval_s: float = 1.0
    #: silence after which a peer's lease is declared expired and its
    #: shards are adopted (epoch bump + reconcile-on-adopt)
    replica_lease_timeout_s: float = 3.0
    #: jitter base for reconcile-on-adopt republishes (seeded draw via
    #: recovery.jitter, uniform in [0, base/4)): a pair-wide failover
    #: de-synchronizes instead of thundering-herding the fabric
    replica_adopt_backoff_s: float = 2.0
    #: targeted peer-row re-drives per replica tick; 0 = unshaped
    replica_redrive_per_tick: int = 0

    # --- api -------------------------------------------------------------
    #: WebSocket JSON-RPC mirror bind address (reference serves
    #: /v1.0/sdnmpi/ws via Ryu's WSGI server, sdnmpi/rpc_interface.py:104)
    rpc_host: str = "127.0.0.1"
    rpc_port: int = 8080
    rpc_path: str = "/v1.0/sdnmpi/ws"

    #: run the monitor app (reference: run_router_no_monitor.sh omits it)
    enable_monitor: bool = True

    #: run the LLDP discovery app (the reference's --observe-links flag,
    #: run_router.sh:2): the controller floods LLDP probes and learns
    #: links/hosts from packet-ins instead of trusting direct entity
    #: events — pair with Fabric(discovery="packet")
    observe_links: bool = False
    #: periodic LLDP reprobe period in real-switch mode (--listen),
    #: seconds; a lost probe frame otherwise never heals because
    #: discovery is event-driven (Ryu refloods on a timer too).
    #: 0 disables.
    lldp_reprobe_interval: float = 15.0

    # --- congestion analytics (oracle/utilplane.py) --------------
    #: hottest directed links decoded per Monitor flush by the jitted
    #: device top-k pass (the CongestionReportRequest payload and the
    #: per-collective attribution input). Static jit argument — keep it
    #: stable within a process.
    congestion_topk: int = 8

    # --- flight recorder (utils/flight.py) -----------------------
    #: arm the in-memory flight recorder: the last N completed span
    #: trees + a rolling registry-snapshot window + a bus-event tail,
    #: with anomaly triggers freezing diagnostic bundles. Arming also
    #: arms per-bucket histogram exemplars (a latency spike's bucket
    #: resolves to the span tree of its latest observation). False
    #: restores the old posture: spans exist only with --trace-log.
    flight_recorder: bool = True
    #: completed span trees the recorder retains (bounded ring)
    flight_max_trees: int = 64
    #: directory diagnostic bundles are dumped to as JSON files
    #: ("" = keep bundles in memory only; the pull-mode ``flight_dump``
    #: RPC and the bench --flight-dump hook still see them)
    flight_dump_dir: str = ""
    #: histogram-threshold anomaly trigger: a fresh observation of any
    #: route/install/re-route latency histogram (install_e2e_seconds,
    #: reval_*_seconds, barrier_rtt_seconds) provably at/above this
    #: many seconds freezes a bundle. 0 disables the latency trigger.
    flight_latency_threshold_s: float = 0.0
    #: p99-regression anomaly trigger: the last Monitor interval's
    #: estimated p99 of those histograms exceeding factor x the rolling
    #: baseline freezes a bundle. 0 disables.
    flight_p99_factor: float = 0.0

    # --- tracing / profiling (SURVEY §5: reference has none) -------------
    #: JSONL structured trace log path ("" = disabled); records oracle
    #: invocations with wall times (utils/tracing.py)
    trace_log: str = ""
    #: Perfetto / chrome://tracing JSON written on shutdown from an
    #: in-memory span collector (api/traceview.py) — the span trees on
    #: a real timeline. "" = disabled.
    trace_dump: str = ""
    #: JSONL control-plane event log ("" = disabled): every bus event as
    #: one JSON line via a bus tap (utils/event_log.py) — the full
    #: causal record, the fourth observability channel beyond the
    #: reference's three (SURVEY §5)
    event_log: str = ""
    #: torch.profiler trace output dir ("" = disabled); wraps the run in
    #: a device profile written as a Chrome trace
    profile_dir: str = ""
    #: rotate the JSONL event log when it reaches this many bytes: the
    #: full file moves to ``<path>.1`` (replacing the previous rotation)
    #: and a fresh one opens, bounding a long-running controller's event
    #: history to ~2x this size. 0 = never rotate (grow unboundedly,
    #: the pre-rotation behavior).
    event_log_max_bytes: int = 0
    #: broadcast a ``update_telemetry`` JSON-RPC notification (the
    #: metrics-registry snapshot + oracle latency summary) to attached
    #: RPC clients once per Monitor pass (EventStatsFlush) — the live
    #: feed twin of the Prometheus text exposition (api/telemetry.py);
    #: both read the same registry. False silences the feed (snapshot
    #: requests still work).
    rpc_telemetry: bool = True


DEFAULT_CONFIG = Config()

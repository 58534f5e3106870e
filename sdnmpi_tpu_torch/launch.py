"""Controller launcher — the CLI face of the framework.

Equivalent of the reference's launch scripts
(reference: run_router.sh / run_router_debug.sh / run_router_no_monitor.sh,
which select Ryu apps and logging configs): three profiles map 1:1 —

    normal      INFO logging, monitor on          (run_router.sh)
    debug       DEBUG logging, monitor on         (run_router_debug.sh)
    no-monitor  INFO logging, monitor off         (run_router_no_monitor.sh)

The monitor's TSV stream goes to ``log/monitor.log`` like the reference's
logging.ini routes the Monitor logger (logging.ini:16-29); everything
else goes to stderr.

Since the southbound is the simulated fabric, the launcher also owns
topology construction (``--topo linear:4``, ``fattree:8``,
``dragonfly:8,32``, ``torus:4,4``) and an optional ``--demo`` traffic
generator that registers MPI ranks and fires a collective through the
fabric so a connected visualizer has something to watch.

Counterpart of ``sdnmpi_tpu/launch.py``: ``python -m sdnmpi_tpu_torch``
(or the ``sdnmpi-tpu-torch`` script) takes every flag of the
reference's parser under the same name, with these differences
(ROADMAP C):

- ``--backend`` takes ``torch`` (the default) or ``py``, and
  ``--device`` (default ``cuda``) is the only way to run the torch
  oracle on the CPU;
- ``--distributed HOST:PORT,NPROC,RANK`` brings up a ``gloo``
  ``torch.distributed`` group (``shardplane.mesh.init_multihost``)
  before anything is built; with ``--shard-oracle`` every process then
  holds an arc of one shard mesh (``--mesh-devices``, split evenly) and
  runs the same controller on the same inputs;
- the WebSocket mirror needs the ``websockets`` package (the ``rpc``
  extra): without it, a launch without ``--no-rpc`` fails at once
  instead of losing the mirror in a background task.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib.util
import logging
import pathlib

from sdnmpi_tpu_torch.config import Config
from sdnmpi_tpu_torch.control.controller import Controller
from sdnmpi_tpu_torch.topogen import (
    dragonfly,
    fattree,
    host_mac,
    linear,
    ring,
    torus,
    torus2d,
)

log = logging.getLogger("launch")

def parse_topo(spec: str):
    kind, _, args = spec.partition(":")
    nums = [int(x) for x in args.split(",") if x] if args else []
    if kind == "linear":
        return linear(*(nums or [4]))
    if kind == "ring":
        return ring(*(nums or [4]))
    if kind == "fattree":
        return fattree(*(nums or [4]))
    if kind == "dragonfly":
        return dragonfly(*(nums or [4, 4]))
    if kind == "torus":
        nums = nums or [4, 4]
        # 2 dims keep the historical torus2d naming; 3+ dims go N-d
        return torus2d(*nums) if len(nums) == 2 else torus(tuple(nums))
    raise SystemExit(f"unknown topology {spec!r}")


def setup_logging(profile: str, log_dir: str = "log") -> None:
    level = logging.DEBUG if profile == "debug" else logging.INFO
    logging.basicConfig(
        level=level, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    # split the Monitor TSV stream into its own file, like logging.ini
    pathlib.Path(log_dir).mkdir(exist_ok=True)
    monitor_logger = logging.getLogger("Monitor")
    handler = logging.FileHandler(pathlib.Path(log_dir) / "monitor.log")
    handler.setFormatter(logging.Formatter("%(message)s"))
    monitor_logger.addHandler(handler)
    monitor_logger.propagate = False


def run_demo(controller: Controller, fabric, n_ranks: int) -> None:
    """Register ranks and fire an alltoall so there is state to mirror."""
    from sdnmpi_tpu_torch.protocol import openflow as of
    from sdnmpi_tpu_torch.protocol.announcement import Announcement, AnnouncementType
    from sdnmpi_tpu_torch.protocol.vmac import CollectiveType, VirtualMac

    n = min(n_ranks, len(fabric.hosts))
    if n < 2:
        log.warning("demo needs at least 2 ranks (have %d); skipping", n)
        return
    for rank in range(n):
        mac = host_mac(rank)
        fabric.hosts[mac].send(
            of.Packet(
                eth_src=mac,
                eth_dst="ff:ff:ff:ff:ff:ff",
                eth_type=of.ETH_TYPE_IP,
                ip_proto=of.IPPROTO_UDP,
                udp_dst=controller.config.announcement_port,
                payload=Announcement(AnnouncementType.LAUNCH, rank).encode(),
            )
        )
    vmac = VirtualMac(CollectiveType.ALLTOALL, 0, 1 % n).encode()
    fabric.hosts[host_mac(0)].send(
        of.Packet(eth_src=host_mac(0), eth_dst=vmac, eth_type=of.ETH_TYPE_IP)
    )
    flows = sum(len(t) for t in controller.router.fdb.fdb.values())
    log.info("demo: %d ranks, alltoall kicked off, %d flows installed", n, flows)


def run_serving_load(controller, fabric, args) -> dict:
    """``--tenants`` mode: drive the booted controller with the
    open-loop multi-tenant harness (control/loadgen.py) and log one
    report line per tenant. Hosts are split round-robin into tenants;
    every tenant offers ``--offered-rate`` unicast lookups/s for the
    run."""
    from sdnmpi_tpu_torch.control.loadgen import LoadGen, TenantSpec

    macs = sorted(fabric.hosts)
    n = max(1, min(args.tenants, len(macs) // 2))
    groups = [macs[i::n] for i in range(n)]
    duration = args.duration if args.duration > 0 else 5.0
    tenants = []
    for i, group in enumerate(groups):
        if len(group) < 2:
            continue
        name = f"tenant{i}"
        for mac in group:
            controller.router.admission.assign(mac, name)
        tenants.append(TenantSpec(
            name=name, rate=args.offered_rate,
            n_requests=max(1, int(args.offered_rate * duration)),
            macs=tuple(group),
        ))
    if not tenants:
        log.warning("--tenants: not enough hosts for a tenant; skipping")
        return {}
    reports = LoadGen(controller, fabric).run(tenants)
    for r in reports.values():
        log.info(
            "serving load %s: %.0f routes/s (offered %d, completed %d, "
            "rejected %d) p50 %.2f ms p99 %.2f ms p999 %.2f ms",
            r.tenant, r.routes_per_s, r.offered, r.completed,
            r.rejected, r.p50_ms, r.p99_ms, r.p999_ms,
        )
    return reports


def config_from_args(args) -> Config:
    listen = getattr(args, "listen", None)
    if listen and not args.observe_links:
        # LLDP discovery is the ONLY link/host source in real-switch
        # mode (the simulated fabric's direct announcements don't exist)
        log.info("--listen implies --observe-links; enabling discovery")
    replica_index, replica_count = parse_ownership(
        getattr(args, "ownership", None)
    )
    return Config(
        oracle_backend=args.backend,
        device=getattr(args, "device", "cuda"),
        enable_monitor=args.profile != "no-monitor",
        rpc_host=args.rpc_host,
        rpc_port=args.rpc_port,
        collective_policy=args.policy,
        trace_log=args.trace_log or "",
        profile_dir=args.profile_dir or "",
        observe_links=args.observe_links or bool(listen),
        lldp_reprobe_interval=args.lldp_reprobe,
        flow_idle_timeout=args.flow_idle_timeout,
        flow_hard_timeout=args.flow_hard_timeout,
        mesh_devices=args.mesh_devices,
        shard_oracle=getattr(args, "shard_oracle", False),
        ring_exchange=getattr(args, "ring_exchange", False),
        hier_oracle=getattr(args, "hier_oracle", False),
        hier_pod_target=getattr(args, "hier_pod_target", 0),
        hier_warm=getattr(args, "hier_warm", True),
        hier_snapshot=getattr(args, "hier_snapshot", True),
        event_log=args.event_log or "",
        event_log_max_bytes=getattr(args, "event_log_max_bytes", 0),
        recovery_plane=not getattr(args, "no_recovery", False),
        reconcile_max_per_flush=getattr(
            args, "reconcile_max_per_flush", 0
        ),
        install_barriers=not getattr(args, "no_install_barriers", False),
        install_retry_max=getattr(args, "install_retry_max", 4),
        install_retry_backoff_s=getattr(args, "install_retry_backoff", 0.25),
        echo_interval_s=getattr(args, "echo_interval", 15.0),
        echo_timeout_s=getattr(args, "echo_timeout", 45.0),
        fabric_audit=not getattr(args, "no_fabric_audit", False),
        audit_switches_per_flush=getattr(
            args, "audit_switches_per_flush", 64
        ),
        traffic_plane=not getattr(args, "no_traffic_plane", False),
        sentinel_sample_per_flush=getattr(
            args, "sentinel_sample_per_flush", 64
        ),
        sentinel_divergence_factor=getattr(
            args, "sentinel_divergence_factor", 2.0
        ),
        sentinel_heal=getattr(args, "sentinel_heal", False),
        route_cache=getattr(args, "route_cache", True),
        schedule_collectives=getattr(args, "schedule_phases", None)
        is not None,
        schedule_phases=getattr(args, "schedule_phases", None) or 0,
        delta_reval=not getattr(args, "no_delta_reval", False),
        trace_dump=getattr(args, "trace_dump", None) or "",
        flight_recorder=not getattr(args, "no_flight_recorder", False),
        flight_dump_dir=getattr(args, "flight_dump", None) or "",
        flight_latency_threshold_s=getattr(
            args, "anomaly_latency_threshold", 0.0
        ),
        flight_p99_factor=getattr(args, "anomaly_p99_factor", 0.0),
        admission_rate=getattr(args, "admission_rate", 0.0),
        compile_cache_dir=getattr(args, "compile_cache_dir", None) or "",
        warm_serving=getattr(args, "warm_serving", False),
        # the serving-load mode measures the coalesced window pipeline
        coalesce_routes=getattr(args, "tenants", 0) > 0,
        slo_targets=_slo_targets(getattr(args, "slo_target", None)),
        profile_dump_dir=getattr(args, "profile_dump", None) or "",
        replica_peer=getattr(args, "replica_peer", None) or "",
        replica_index=replica_index,
        replica_count=replica_count,
        replica_lease_interval_s=getattr(args, "lease_interval", 1.0),
        replica_lease_timeout_s=getattr(args, "lease_timeout", 3.0),
    )


def _slo_targets(specs) -> dict:
    """``--slo-target tenant:p99_ms[:avail]`` specs -> the
    Config.slo_targets dict; malformed specs fail the launch."""
    if not specs:
        return {}
    from sdnmpi_tpu_torch.control.slo import parse_slo_target

    out = {}
    for spec in specs:
        try:
            t = parse_slo_target(spec)
        except ValueError as e:
            raise SystemExit(str(e))
        out[t.tenant] = (t.p99_ms, t.availability)
    return out


def parse_ownership(spec) -> tuple[int, int]:
    """``--ownership I/N`` -> (replica_index, replica_count); raises
    SystemExit on malformed input so a typo fails the launch instead of
    two replicas silently claiming the same shards. None (flag absent)
    -> (-1, 2): the index derives from the process group's rank
    (ownership.mesh_replica_index)."""
    if not spec:
        return -1, 2
    try:
        idx_s, cnt_s = str(spec).split("/", 1)
        idx, cnt = int(idx_s), int(cnt_s)
    except ValueError:
        raise SystemExit(f"--ownership wants I/N, e.g. 0/2 (got {spec!r})")
    if cnt < 1 or not 0 <= idx < cnt:
        raise SystemExit(
            f"--ownership wants 0 <= I < N with N >= 1 (got {spec!r})"
        )
    return idx, cnt


def parse_distributed(spec: str) -> tuple[str, int, int]:
    """'HOST:PORT,NPROC,RANK' -> (coordinator, n_processes, process_id)
    for shardplane.mesh.init_multihost; raises SystemExit on malformed
    input so a typo fails the launch instead of silently running
    single-host."""
    try:
        coordinator, nproc_s, rank_s = spec.rsplit(",", 2)
        nproc, rank = int(nproc_s), int(rank_s)
    except ValueError:
        raise SystemExit(
            f"--distributed wants HOST:PORT,NPROC,RANK (got {spec!r})"
        )
    if ":" not in coordinator or nproc < 1 or not 0 <= rank < nproc:
        raise SystemExit(
            f"--distributed wants HOST:PORT,NPROC,RANK with "
            f"0 <= RANK < NPROC (got {spec!r})"
        )
    return coordinator, nproc, rank


async def run_replica_relay(controller, link, config) -> None:
    """Outbound half of the pair's replication stream: dial
    the peer's RPC WebSocket, relay the link's sends as
    ``replica_relay`` notifications, and drive the replica tick at the
    lease cadence — the async twin of the echo keepalive loop.
    Reconnects forever; sends while disconnected drop, and the
    sequence-gap protocol snapshot-backfills once the peer is back."""
    import json

    outbox: asyncio.Queue = asyncio.Queue(maxsize=4096)

    def enqueue(msg: dict) -> None:
        # QueueFull propagates into RpcReplicaLink.send's drop counter:
        # a wedged peer link opens a gap instead of growing unbounded
        outbox.put_nowait(json.dumps({
            "jsonrpc": "2.0", "method": "replica_relay", "params": [msg],
        }))

    link.bind_sender(enqueue)

    async def pump() -> None:
        import websockets

        while True:
            try:
                async with websockets.connect(
                    config.replica_peer
                ) as ws:
                    log.info("replica peer link up: %s", config.replica_peer)
                    while True:
                        await ws.send(await outbox.get())
            except asyncio.CancelledError:
                raise
            except Exception:
                await asyncio.sleep(
                    max(0.5, config.replica_lease_interval_s)
                )

    pump_task = asyncio.create_task(pump(), name="replica pump")
    try:
        while True:
            controller.replica.tick()
            await asyncio.sleep(max(0.1, config.replica_lease_interval_s))
    finally:
        pump_task.cancel()


def _report_failure(task: asyncio.Task) -> None:
    """Done-callback of the launcher's background tasks: a task that
    died is logged at once, not when it is garbage-collected."""
    if not task.cancelled() and task.exception() is not None:
        log.error("%s failed", task.get_name(), exc_info=task.exception())


async def amain(args) -> None:
    listen = getattr(args, "listen", None)
    if getattr(args, "distributed", None):
        # multi-process mesh: the process group must exist before any
        # mesh is built
        from sdnmpi_tpu_torch.shardplane.mesh import init_multihost

        init_multihost(*parse_distributed(args.distributed))
    config = config_from_args(args)
    if not args.no_rpc and importlib.util.find_spec("websockets") is None:
        raise SystemExit(
            "the WebSocket mirror needs the websockets package (the rpc "
            "extra: pip install 'sdnmpi-tpu[rpc]'); pass --no-rpc to run "
            "without it"
        )
    if config.compile_cache_dir:
        # the kernels' build directory, set before any kernel is built
        # or loaded so every library lands in / loads from it
        from sdnmpi_tpu_torch.oracle.engine import enable_compile_cache

        if enable_compile_cache(config.compile_cache_dir):
            log.info(
                "persistent kernel build directory at %s",
                config.compile_cache_dir,
            )
    if config.trace_log:
        from sdnmpi_tpu_torch.utils.tracing import set_trace_sink

        set_trace_sink(config.trace_log)
    trace_collector = None
    if config.trace_dump:
        # in-memory span collector tee'd beside any file sink; rendered
        # as a Perfetto/chrome://tracing timeline on shutdown
        from sdnmpi_tpu_torch.api.traceview import TraceCollector
        from sdnmpi_tpu_torch.utils.tracing import add_trace_sink

        trace_collector = TraceCollector()
        add_trace_sink(trace_collector)
    if listen:
        # real-switch mode: the southbound is an OpenFlow 1.0 TCP server
        # (control/southbound.py) and the topology is whatever dials in —
        # the posture the reference got from `ryu-manager` (run_router.sh)
        if args.demo:
            raise SystemExit("--demo needs the simulated fabric (no --listen)")
        from sdnmpi_tpu_torch.control.southbound import OFSouthbound

        host, _, port = listen.rpartition(":")
        fabric = OFSouthbound(host or "0.0.0.0", int(port))
        spec = None
    else:
        spec = parse_topo(args.topo)
        fabric = spec.to_fabric(
            wire=args.wire,
            discovery="packet" if args.observe_links else "direct",
        )
    ownership = None
    replica_link = None
    if config.replica_peer:
        # active/active pair: deterministic switch partition
        # by the process group's rank, replication + lease heartbeats
        # relayed over the peer's RPC WebSocket
        from sdnmpi_tpu_torch.control.ownership import (
            OwnershipMap,
            mesh_replica_index,
        )
        from sdnmpi_tpu_torch.control.replica import (
            FencedSouthbound,
            RpcReplicaLink,
        )

        index = (
            config.replica_index if config.replica_index >= 0
            else mesh_replica_index(config.replica_count)
        )
        ownership = OwnershipMap(config.replica_count, index)
        replica_link = RpcReplicaLink()
        fabric = FencedSouthbound(fabric, ownership, shared=False)
        log.info(
            "replica %d/%d: serving shards %s, peer %s",
            index, config.replica_count, ownership.shards_of(index),
            config.replica_peer,
        )
    controller = Controller(
        fabric, config, ownership=ownership, replica_link=replica_link
    )
    controller.attach()

    if args.restore:
        from sdnmpi_tpu_torch.api.snapshot import load_checkpoint

        load_checkpoint(controller, args.restore)
        log.info("restored checkpoint from %s", args.restore)
    if spec is not None:
        log.info(
            "topology %s: %d switches, %d hosts",
            spec.name,
            spec.n_switches,
            spec.n_hosts,
        )
    if config.warm_serving and config.oracle_backend == "torch":
        # build (or load) the kernels and run the serving path against
        # the booted topology before the first packet-in arrives
        warm = controller.topology_manager.topologydb.warm_serving(
            shapes=(8, config.coalesce_max_batch)
        )
        log.info(
            "serving path warmed in %.2f s (window buckets %s, hop "
            "budget %d)", warm["warm_s"], warm["shapes"], warm["max_len"],
        )

    tasks = []
    if controller.monitor is not None:
        tasks.append(asyncio.create_task(controller.monitor.run(), name="monitor"))

    if spec is None:
        await fabric.serve()  # accept real OF 1.0 switches
        if config.echo_interval_s > 0 and hasattr(fabric, "run_echo"):
            # controller-side keepalive: kill half-open datapaths so
            # EventDatapathDown — and the reconcile on redial — fires
            tasks.append(asyncio.create_task(fabric.run_echo(), name="echo"))
        if (
            controller.discovery is not None
            and config.lldp_reprobe_interval > 0
        ):
            async def reprobe() -> None:
                # heal lost probe frames: discovery is event-driven, so
                # a dropped LLDP packet would otherwise hide a link
                # until the next port event
                while True:
                    await asyncio.sleep(config.lldp_reprobe_interval)
                    controller.discovery.probe()

            tasks.append(asyncio.create_task(reprobe(), name="lldp reprobe"))
    else:
        chaos = None
        if getattr(args, "chaos", None) is not None:
            # live chaos demo: the same fault plan the recovery tests
            # soak under, stepping once per fabric clock tick
            from sdnmpi_tpu_torch.control.faults import FaultPlan

            chaos = FaultPlan(
                seed=args.chaos,
                p_send_drop=0.05, p_send_stall=0.03, p_send_truncate=0.02,
                p_ack_drop=0.03, p_stats_delay=0.1,
                p_crash=0.05, p_redial=0.5, p_flap=0.08, p_restore=0.5,
                # silent table corruption: watch the audit
                # plane's divergence counters catch and heal it live
                p_mutate=0.03,
                mutate_priority=config.priority_default,
            ).attach(fabric)
            log.info("chaos fault plan armed (seed %d)", args.chaos)

        async def clock() -> None:
            # drive the fabric's flow-expiry clock (a real switch ages
            # its own flows; the sim needs the tick) — cheap no-op while
            # all installed flows are permanent (the default timeouts)
            loop = asyncio.get_running_loop()
            while True:
                fabric.tick(loop.time())
                if chaos is not None:
                    chaos.step()
                await asyncio.sleep(1.0)

        tasks.append(asyncio.create_task(clock(), name="fabric clock"))
    if not args.no_rpc:
        from sdnmpi_tpu_torch.api.rpc import RPCInterface

        rpc = RPCInterface(controller.bus, config)
        if replica_link is not None:
            # inbound half of the replication stream: the peer's
            # replica_relay notifications land in the link's inbox
            rpc.on_replica_relay = replica_link.ingest
        tasks.append(asyncio.create_task(rpc.serve(), name="RPC mirror"))
    elif replica_link is not None:
        log.warning("--replica-peer with --no-rpc: no inbound relay "
                    "endpoint; this replica can send but never receive")
    if replica_link is not None:
        tasks.append(asyncio.create_task(
            run_replica_relay(controller, replica_link, config),
            name="replica relay",
        ))
    for task in tasks:
        task.add_done_callback(_report_failure)

    from sdnmpi_tpu_torch.utils.tracing import STATS, device_trace

    try:
        with device_trace(config.profile_dir):
            if args.demo:
                run_demo(controller, fabric, args.demo_ranks)
            if getattr(args, "tenants", 0) > 0:
                if spec is None:
                    raise SystemExit(
                        "--tenants needs the simulated fabric (no --listen)"
                    )
                # bounded serving-load run: report and exit
                run_serving_load(controller, fabric, args)
            elif args.duration > 0:
                await asyncio.sleep(args.duration)
            else:
                await asyncio.Future()
            if getattr(args, "distributed", None):
                # the buffers other processes mapped outlive their stores
                from sdnmpi_tpu_torch.kernels.ring import close_exchanges

                close_exchanges()
    except asyncio.CancelledError:
        pass
    finally:
        summary = STATS.summary()
        if summary:
            log.info("oracle timing summary: %s", summary)
        metrics_dump = getattr(args, "metrics_dump", None)
        if metrics_dump:
            # Prometheus-style text exposition of the telemetry
            # registry ("-" = stdout) — same snapshot the RPC mirror's
            # update_telemetry feed broadcast live
            from sdnmpi_tpu_torch.api.telemetry import dump

            dump(metrics_dump, snapshot=controller.telemetry())
            if metrics_dump != "-":
                log.info("metrics exposition written to %s", metrics_dump)
        if trace_collector is not None:
            # counter tracks from the metrics timeline render beside
            # the span slices — one trace, both stories
            trace = trace_collector.dump(
                config.trace_dump, timeline=controller.timeline
            )
            log.info(
                "Perfetto trace (%d events) written to %s",
                len(trace["traceEvents"]), config.trace_dump,
            )
        if controller.profile_capture is not None:
            controller.profile_capture.close()
        if controller.flight is not None:
            if controller.flight.bundles:
                log.info(
                    "flight recorder froze %d diagnostic bundle(s); "
                    "last trigger: %s",
                    len(controller.flight.bundles),
                    controller.flight.bundles[-1]["trigger"],
                )
            controller.flight.disarm()
        if args.checkpoint:
            from sdnmpi_tpu_torch.api.snapshot import save_checkpoint

            save_checkpoint(controller, args.checkpoint)
            log.info("checkpoint written to %s", args.checkpoint)
        if controller.event_logger is not None:
            log.info(
                "event log: %d events -> %s",
                controller.event_logger.n_events, config.event_log,
            )
            controller.event_logger.close()
        if spec is None:
            await fabric.close()  # stop accepting real switches
        for task in tasks:
            task.cancel()


def _nonneg_int(s: str) -> int:
    v = int(s)
    if v < 0:
        raise argparse.ArgumentTypeError(
            f"must be >= 0, got {v} (0 = auto)"
        )
    return v


def _nonneg_float(s: str) -> float:
    v = float(s)
    if v < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {v} (0 = off)")
    return v


def _pos_float(s: str) -> float:
    v = float(s)
    if v <= 0:
        raise argparse.ArgumentTypeError(f"must be > 0, got {v}")
    return v


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="sdnmpi_tpu_torch",
        description="SDN-MPI controller on PyTorch (NVIDIA Hopper)",
    )
    parser.add_argument(
        "--profile",
        choices=["normal", "debug", "no-monitor"],
        default="normal",
        help="launch profile (mirrors the reference's run_router*.sh)",
    )
    parser.add_argument("--topo", default="linear:4", help="topology spec, e.g. fattree:8")
    parser.add_argument(
        "--listen", default=None, metavar="[HOST:]PORT",
        help="real-switch mode: serve OpenFlow 1.0 over TCP instead of "
             "simulating --topo (e.g. --listen 6633); switches dial in "
             "like they dialed the reference's ryu-manager",
    )
    parser.add_argument(
        "--lldp-reprobe", type=float, default=15.0,
        help="periodic LLDP reflood seconds in --listen mode (0 = off)",
    )
    parser.add_argument(
        "--backend", choices=["torch", "py"], default="torch",
        help="route oracle: torch (device tensors and the CUDA kernels) "
        "or py (the pure-Python differential oracle)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device of the torch oracle (default cuda, which needs a "
        "card; cpu runs every kernel's plain version)",
    )
    parser.add_argument("--rpc-host", default="127.0.0.1")
    parser.add_argument("--rpc-port", type=int, default=8080)
    parser.add_argument("--no-rpc", action="store_true", help="disable the WebSocket mirror")
    parser.add_argument(
        "--policy",
        choices=["balanced", "adaptive", "shortest"],
        default="balanced",
        help="routing policy for proactive collective batches",
    )
    parser.add_argument(
        "--observe-links",
        action="store_true",
        help="learn links/hosts via LLDP probes + traffic instead of "
        "direct entity events (the reference's --observe-links, "
        "run_router.sh:2)",
    )
    parser.add_argument(
        "--wire",
        action="store_true",
        help="round-trip every southbound message through the byte-level "
        "OpenFlow 1.0 codec (protocol/ofwire.py)",
    )
    parser.add_argument(
        "--flow-idle-timeout", type=int, default=0,
        help="idle expiry for routing flows in seconds (0 = permanent, "
        "the reference's only mode)",
    )
    parser.add_argument(
        "--flow-hard-timeout", type=int, default=0,
        help="hard expiry for routing flows in seconds (0 = permanent)",
    )
    parser.add_argument(
        "--mesh-devices", type=int, default=0,
        help="shard the DAG balancer over the first N local devices "
        "(0 = single-device)",
    )
    parser.add_argument(
        "--shard-oracle", action="store_true",
        help="promote --mesh-devices to the FULL pod-scale sharded "
        "oracle backend (sdnmpi_tpu_torch/shardplane): APSP distances + next "
        "hops row-shard over the mesh and every routing entry point "
        "partitions its flow batch across it, with packed per-host "
        "readback. Bit-identical routes; requires --mesh-devices N > 0",
    )
    parser.add_argument(
        "--ring-exchange", dest="ring_exchange", action="store_true",
        help="stream the sharded oracle's distance/next-hop exchange "
        "through the ring all-gather kernel on a 2-byte wire; "
        "bit-identical routes; requires --shard-oracle",
    )
    parser.add_argument(
        "--no-ring-exchange", dest="ring_exchange", action="store_false",
        help="keep the sharded legs on the gather exchange (the "
        "default; byte-identical differential escape hatch)",
    )
    parser.set_defaults(ring_exchange=False)
    parser.add_argument(
        "--hier-oracle", action="store_true",
        help="route through the hierarchical two-level oracle "
        "(oracle/hier.py): dense per-pod blocks + a compressed border "
        "skeleton replace every dense [V, V] plane — O(pods x "
        "pod_size^2) memory, 65k-switch fabrics on one slice. Path "
        "lengths bit-identical to the dense oracle; with "
        "--mesh-devices the pod blocks shard one block-shard per "
        "device and --ring-exchange moves the border plane over the "
        "ring",
    )
    parser.add_argument(
        "--hier-pod-target", type=int, default=0,
        help="partitioner pod-size target for unannotated fabrics "
        "under --hier-oracle (0 = ~sqrt(V) auto)",
    )
    parser.add_argument(
        "--hier-warm", dest="hier_warm", action="store_true",
        help="precompile the full hierarchical program ladder "
        "(pod-stack APSP buckets, pow2 Jacobi pull-sweep shapes, fused "
        "composition, batch fdb) during warm_serving, so the first "
        "route after boot replays cached executables instead of "
        "tracing (default: on)",
    )
    parser.add_argument(
        "--no-hier-warm", dest="hier_warm", action="store_false",
        help="skip the hierarchical warm ladder — first route pays "
        "full trace/compile cost (the differential escape hatch; "
        "routes stay bit-identical)",
    )
    parser.set_defaults(hier_warm=True)
    parser.add_argument(
        "--hier-snapshot", dest="hier_snapshot", action="store_true",
        help="persist the hier oracle's lazy border-distance row plane "
        "through api/snapshot beside the route-cache memo — a "
        "restarted controller inherits the warm level-2 plane "
        "(topology-digest guarded; default: on)",
    )
    parser.add_argument(
        "--no-hier-snapshot", dest="hier_snapshot",
        action="store_false",
        help="exclude the border plane from checkpoints and ignore it "
        "on restore — restart pays the cold lazy rebuild (the "
        "differential escape hatch; routes stay bit-identical)",
    )
    parser.set_defaults(hier_snapshot=True)
    parser.add_argument(
        "--distributed", metavar="HOST:PORT,NPROC,RANK",
        help="join a multi-process shardplane mesh as process RANK of "
        "NPROC against the coordinator at HOST:PORT (a gloo "
        "torch.distributed group; process 0 listens there)",
    )
    parser.add_argument(
        "--no-recovery", action="store_true",
        help="disable the failure-domain recovery plane (desired-flow "
        "reconciliation, install retries, anti-entropy) — restores the "
        "fire-and-forget legacy for differential runs",
    )
    parser.add_argument(
        "--schedule-phases", type=_nonneg_int, default=None, metavar="K",
        help="enable the device-side collective phase scheduler "
        "(sdnmpi_tpu_torch/sched): block-installed collectives decompose into "
        "K link-load-balanced phases installed with barrier-acked "
        "boundaries (K is pow2-rounded and clamped at 32; 0 = auto). "
        "Omit the flag for the bit-identical single-shot install path",
    )
    parser.add_argument(
        "--no-delta-reval", action="store_true",
        help="disable delta-narrowed flow revalidation: every topology "
        "change re-routes every installed flow and collective (the "
        "differential escape hatch)",
    )
    parser.add_argument(
        "--no-install-barriers", action="store_true",
        help="do not terminate batched install windows with "
        "OFPT_BARRIER_REQUEST (no acked installs)",
    )
    parser.add_argument(
        "--install-retry-max", type=int, default=4,
        help="bounded retries per switch for dropped/un-acked install "
        "windows before escalating to a full resync",
    )
    parser.add_argument(
        "--install-retry-backoff", type=float, default=0.25,
        help="base seconds of the install retry queue's exponential "
        "backoff (doubles per attempt, +25%% seeded jitter)",
    )
    parser.add_argument(
        "--echo-interval", type=float, default=15.0,
        help="controller-side echo keepalive period for real TCP "
        "datapaths in --listen mode, seconds (0 = off)",
    )
    parser.add_argument(
        "--echo-timeout", type=float, default=45.0,
        help="seconds without an echo reply before a half-open "
        "datapath is disconnected",
    )
    parser.add_argument(
        "--replica-peer", default=None,
        help="peer controller's RPC WebSocket URL (e.g. "
        "ws://host:8080/v1.0/sdnmpi/ws): run as one replica of an "
        "active/active pair — switch ownership is partitioned, stores "
        "replicate, and a dead peer's shards are adopted (unset = "
        "single controller, unchanged serving path)"
    )
    parser.add_argument(
        "--ownership", default=None,
        help="this replica's slot as I/N (e.g. 0/2); omit to derive "
        "the index from the mesh's process order"
    )
    parser.add_argument(
        "--lease-interval", type=_pos_float, default=1.0,
        help="replica lease heartbeat period, seconds"
    )
    parser.add_argument(
        "--lease-timeout", type=_pos_float, default=3.0,
        help="seconds of peer silence before its lease expires and "
        "its shards are adopted (epoch bump + reconcile-on-adopt)"
    )
    parser.add_argument(
        "--no-fabric-audit", action="store_true",
        help="disable the fabric ground-truth audit plane "
        "(control/audit.py): per-flush OFPST_FLOW sweeps diffing every "
        "switch's actual table against the desired store, healing "
        "confirmed divergence as targeted re-drives",
    )
    parser.add_argument(
        "--audit-switches-per-flush", type=_nonneg_int, default=64,
        metavar="N",
        help="switches audited per Monitor flush (the sweep's "
        "round-robin pacing; 0 = the whole fabric every flush)"
    )
    parser.add_argument(
        "--no-traffic-plane", action="store_true",
        help="disable the measured traffic matrix + shadow route-"
        "quality sentinel (oracle/trafficplane.py, control/sentinel.py):"
        " per-flush EWMA folding of the audit plane's attributed byte "
        "deltas into a device-resident per-tenant src->dst rate matrix,"
        " re-scored against a fresh oracle optimum",
    )
    parser.add_argument(
        "--sentinel-sample-per-flush", type=_nonneg_int, default=64,
        metavar="N",
        help="installed routes the sentinel re-scores per stats flush "
        "against a fresh oracle optimum for the measured matrix "
        "(round-robin pacing; 0 = the whole installed population)"
    )
    parser.add_argument(
        "--sentinel-divergence-factor", type=_pos_float, default=2.0,
        metavar="F",
        help="measured-vs-modeled hottest-link ratio at which the "
        "sentinel confirms the routes no longer fit the traffic "
        "(counts sentinel_divergence_total{tenant} and freezes a "
        "flight bundle naming the worst tenant/collective/pod-pair)"
    )
    parser.add_argument(
        "--sentinel-heal", action="store_true",
        help="let the sentinel re-drive the worst diverging pair "
        "through the install plane when divergence confirms (default "
        "OFF: the channel observes only and never mutates routing)"
    )
    parser.add_argument(
        "--reconcile-max-per-flush", type=_nonneg_int, default=0,
        metavar="N",
        help="cap datapath-up reconciles served per flush window so a "
        "power-cycled pod redialing at once cannot flood the install "
        "plane (deferred reconciles drain on later flushes, counted in "
        "reconcile_deferred_total; 0 = unshaped)",
    )
    parser.add_argument(
        "--chaos", type=int, default=None, metavar="SEED",
        help="arm a seeded fault-injection plan (control/faults.py) "
        "against the simulated fabric: switch crashes/redials, link "
        "flaps, dropped/stalled/truncated installs, delayed stats — "
        "one chaos step per fabric clock tick; watch the recovery "
        "counters converge it back",
    )
    parser.add_argument(
        "--tenants", type=_nonneg_int, default=0, metavar="N",
        help="serving-load mode: split the simulated "
        "fabric's hosts into N tenants and drive the live controller "
        "with the open-loop multi-tenant harness (control/loadgen.py) "
        "for --duration seconds (default 5), reporting per-tenant "
        "routes/s and p50/p99/p999; implies route coalescing. 0 = off",
    )
    parser.add_argument(
        "--offered-rate", type=_pos_float, default=200.0, metavar="R",
        help="offered load per tenant in requests/second for --tenants "
        "(open-loop: arrivals are scheduled from this rate alone, so "
        "queueing past capacity shows up as tail latency, not as "
        "silently throttled load)",
    )
    parser.add_argument(
        "--route-cache", dest="route_cache", action="store_true",
        help="memoize reaped route windows / collective results in "
        "front of the oracle, invalidated through the topology delta "
        "log (oracle/routecache.py; the default)",
    )
    parser.add_argument(
        "--no-route-cache", dest="route_cache", action="store_false",
        help="serve every request through the oracle dispatch path "
        "(byte-identical — the differential escape hatch)",
    )
    parser.set_defaults(route_cache=True)
    parser.add_argument(
        "--admission-rate", type=_nonneg_float, default=0.0,
        metavar="RATE",
        help="per-tenant admission rate in packet-ins/second "
        "(control/admission.py): requests past a tenant's token bucket "
        "drop at the door so one tenant's storm cannot starve the "
        "rest. 0 = admit everything (the default)",
    )
    parser.add_argument(
        "--compile-cache-dir", metavar="DIR",
        help="persistent kernel build directory: the CUDA kernels are "
        "built with nvcc into DIR and a restarted controller loads them "
        "instead of building them again",
    )
    parser.add_argument(
        "--warm-serving", action="store_true",
        help="build (or load) the kernels and run the serving path "
        "(APSP refresh + window extraction buckets) against the booted "
        "topology at launch, before the first packet-in arrives",
    )
    parser.add_argument("--trace-log", help="JSONL structured trace log path")
    parser.add_argument(
        "--trace-dump", metavar="PATH",
        help="write the run's span trees as a Perfetto/chrome://tracing "
        "JSON timeline on shutdown (api/traceview.py)"
    )
    parser.add_argument(
        "--no-flight-recorder", action="store_true",
        help="disable the in-memory flight recorder (span-tree ring, "
        "anomaly triggers, histogram exemplars)",
    )
    parser.add_argument(
        "--flight-dump", metavar="DIR",
        help="write each anomaly trigger's diagnostic bundle as a JSON "
        "file under DIR (default: bundles stay in memory, readable via "
        "the flight_dump RPC method)",
    )
    parser.add_argument(
        "--anomaly-latency-threshold", type=float, default=0.0,
        metavar="SECONDS",
        help="freeze a diagnostic bundle when a route/install/re-route "
        "latency observation provably exceeds this bound (0 = off)"
    )
    parser.add_argument(
        "--anomaly-p99-factor", type=float, default=0.0, metavar="FACTOR",
        help="freeze a bundle when an interval's estimated p99 exceeds "
        "FACTOR x the rolling baseline (0 = off)"
    )
    parser.add_argument(
        "--slo-target", action="append", metavar="TENANT:P99_MS[:AVAIL]",
        help="per-tenant serving SLO (repeatable): the Router "
        "feeds the tenant's latency histogram and a multi-window "
        "burn-rate trigger freezes a diagnostic bundle naming the "
        "burning tenant and the dominant pipeline stage when the error "
        "budget burns (e.g. --slo-target victim:50:0.999)",
    )
    parser.add_argument(
        "--profile-dump", metavar="DIR",
        help="anomaly-armed device profiling: when a flight-recorder "
        "trigger fires, open a torch.profiler capture window under DIR "
        "for a few seconds — the profile OF the incident, zero "
        "steady-state overhead",
    )
    parser.add_argument(
        "--event-log",
        help="JSONL control-plane event log (every bus event, one line)",
    )
    parser.add_argument(
        "--event-log-max-bytes", type=int, default=0,
        help="rotate the event log to <path>.1 at this size (0 = never)",
    )
    parser.add_argument(
        "--metrics-dump", metavar="PATH",
        help="write the telemetry registry as a Prometheus-style text "
        "exposition on shutdown ('-' = stdout)",
    )
    parser.add_argument("--profile-dir", help="torch.profiler trace output dir")
    parser.add_argument("--demo", action="store_true", help="generate demo MPI traffic")
    parser.add_argument("--demo-ranks", type=int, default=8)
    parser.add_argument("--duration", type=float, default=0, help="run time in seconds (0 = forever)")
    parser.add_argument("--checkpoint", help="write a state checkpoint on shutdown")
    parser.add_argument("--restore", help="restore state from a checkpoint file")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    setup_logging(args.profile)
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()

"""Controller checkpoint / resume.

The reference keeps all state in memory and rebuilds only via
rediscovery after a restart (SURVEY §5: "checkpoint/resume: none"); its
``to_dict`` serializers exist purely to seed WebSocket clients. Here the
same serializers double as a checkpoint format: ``snapshot_controller``
captures topology, installed flows, the rank registry, and link
utilization; ``restore_controller`` rebuilds the stores so a restarted
controller resumes with warm state instead of a blank network view.

Counterpart of ``sdnmpi_tpu/api/snapshot.py``, copied with its imports
rewritten: the checkpoint is the same JSON (``SNAPSHOT_VERSION``), so a
checkpoint written by either package restores into the other, the hier
oracle's border rows (``hier_border``) included.
"""

from __future__ import annotations

import json
import logging
import pathlib

import numpy as np

from sdnmpi_tpu_torch.core.topology_db import Host, Link, Port, Switch
from sdnmpi_tpu_torch.utils.metrics import REGISTRY

log = logging.getLogger(__name__)

SNAPSHOT_VERSION = 1

_m_cold_starts = REGISTRY.counter(
    "snapshot_cold_starts_total",
    "checkpoint restores abandoned or partially skipped (version or "
    "digest mismatch) in favor of a cold start",
)


def _cold_start(controller, reason: str) -> None:
    """A restore section did not match this controller's world: log it,
    count it, and drop a breadcrumb on the bus (the flight recorder's
    event tail picks it up) — never raise. A replica bootstrapping
    from a stale snapshot must degrade to rediscovery, not crash-loop."""
    from sdnmpi_tpu_torch.control import events as ev

    log.warning("snapshot restore degraded to cold start: %s", reason)
    _m_cold_starts.inc()
    controller.bus.publish(ev.EventSnapshotColdStart(reason))


def snapshot_controller(controller) -> dict:
    db = controller.topology_manager.topologydb
    # the route-cache memo rides the checkpoint beside the compile
    # cache: surviving (shortest-policy) entries
    # serialize with a topology digest + format version and re-seed a
    # restarted controller's cache, so the first repeat collective
    # after a restart is a hit, not a dispatch. Absent/None when the
    # cache is off — restores treat it as optional.
    route_cache = (
        db.route_cache.snapshot_entries(db)
        if db.route_cache is not None else None
    )
    # the desired-flow store rides the checkpoint beside the route-cache
    # memo: a restarted
    # controller re-seeds what SHOULD be installed and then AUDITS the
    # fabric it left behind (the switches kept their tables across the
    # controller restart) instead of starting blind — the audit plane's
    # first sweeps reconcile any drift accumulated while it was down.
    # Topology-digest guarded like the route cache: a controller that
    # discovered a different fabric restores nothing.
    from sdnmpi_tpu_torch.oracle.routecache import RouteCache

    desired = controller.router.recovery.desired
    # the hier oracle's lazy border-distance row plane rides beside the
    # route-cache memo: digest-guarded inside the oracle, so a restarted
    # controller inherits the warm level-2 plane instead of re-sweeping
    # it. None when the hier oracle (or the knob) is off.
    cfg = getattr(controller.topology_manager, "config", None)
    hier_border = (
        db.hier_border_snapshot()
        if getattr(cfg, "hier_snapshot", True) else None
    )
    # the audit plane's per-row counter baselines ride beside the
    # desired-store checkpoint, digest-guarded: a
    # restarted controller that re-baselined from scratch would
    # attribute each switch's LIFETIME counters as a fresh delta on its
    # first sweep — spiking tenant bytes, the traffic matrix, and any
    # divergence trigger watching them.
    audit = getattr(controller, "audit", None)
    audit_baselines = (
        {
            "topology_digest": RouteCache.topology_digest(db),
            "cycle": audit.cycle,
            "rows": [
                [dpid, src, dst, pkts, bts]
                for dpid, table in sorted(audit._counters.items())
                for (src, dst), (pkts, bts) in sorted(table.items())
            ],
        }
        if audit is not None else None
    )
    # the measured traffic matrix's EWMA state rides too (cells keyed
    # by tenant/endpoint NAMES; the plane re-resolves them against the
    # live fabric on restore), under the same digest guard
    traffic = getattr(controller, "traffic", None)
    traffic_plane = (
        dict(traffic.state_dict(),
             topology_digest=RouteCache.topology_digest(db))
        if traffic is not None else None
    )
    return {
        "version": SNAPSHOT_VERSION,
        "route_cache": route_cache,
        "hier_border": hier_border,
        "audit_baselines": audit_baselines,
        "traffic_plane": traffic_plane,
        "desired_flows": {
            "topology_digest": RouteCache.topology_digest(db),
            "rows": [
                [dpid, src, dst, spec.out_port, spec.rewrite,
                 spec.collective]
                for dpid, table in sorted(desired.flows.items())
                for (src, dst), spec in sorted(table.items())
            ],
        },
        "topology": controller.topology_manager.topologydb.to_dict(),
        "fdb": controller.router.fdb.to_dict(),
        "rankdb": controller.process_manager.rankdb.to_dict(),
        "link_util": [
            [dpid, port, bps]
            for (dpid, port), bps in controller.topology_manager.link_util.items()
        ],
        # block-installed collectives by identity, not by flow: restore
        # re-routes them against the live topology (pair arrays are
        # regenerated from the stored index arrays)
        "collectives": [
            {
                "coll_type": i.coll_type,
                "root": i.root,
                "ranks": list(i.ranks),
                "policy": i.policy,
                "src_idx": np.asarray(i.src_idx).tolist(),
                "dst_idx": np.asarray(i.dst_idx).tolist(),
            }
            for i in controller.router.collectives
        ],
    }


def restore_controller(controller, snapshot: dict) -> None:
    if snapshot.get("version") != SNAPSHOT_VERSION:
        _cold_start(
            controller,
            f"unsupported snapshot version {snapshot.get('version')}",
        )
        return

    # Live discovery is authoritative for topology: once attach() has
    # populated any switches, merging the snapshot would resurrect links
    # that no longer exist (no delete event ever fires for a link that
    # was never discovered) and routes could blackhole through them. The
    # snapshot topology is only a cold-start warm cache; discovery
    # upserts over it as real events arrive.
    db = controller.topology_manager.topologydb
    topo = snapshot["topology"]
    if not db.switches:
        for sw in topo["switches"]:
            db.add_switch(
                Switch.make(
                    sw["dpid"],
                    [Port(p["dpid"], p["port_no"]) for p in sw.get("ports", [])],
                )
            )
        for link in topo["links"]:
            db.add_link(Link(_port(link["src"]), _port(link["dst"])))
    for host in topo["hosts"]:
        db.add_host(Host(host["mac"], _port(host["port"])))

    rankdb = controller.process_manager.rankdb
    for rank_str, mac in snapshot["rankdb"].items():
        rankdb.add_process(int(rank_str), mac)

    # through the manager, not the raw dict: the restore must also seed
    # the device-resident utilization plane so the first post-restore
    # route is congestion-aware without waiting a Monitor interval
    controller.topology_manager.restore_link_util(
        {(dpid, port): bps for dpid, port, bps in snapshot.get("link_util", [])}
    )

    # Re-seed the desired-flow store so the
    # restarted controller knows what SHOULD be installed before any
    # reinstall below runs — and so the audit plane's first sweeps
    # verify the fabric it left behind instead of reading a warm
    # switch's surviving rows as orphans. Digest-guarded: a different
    # fabric restores nothing (the reinstall passes rebuild the store
    # from live routing anyway).
    des = snapshot.get("desired_flows")
    if des and des.get("rows"):
        from sdnmpi_tpu_torch.oracle.routecache import RouteCache

        if des.get("topology_digest") == RouteCache.topology_digest(db):
            desired = controller.router.recovery.desired
            for dpid, src, dst, out_port, rewrite, collective in des[
                "rows"
            ]:
                desired.record(
                    int(dpid), src, dst, int(out_port), rewrite,
                    bool(collective),
                )
        else:
            _cold_start(controller, "desired-flow topology digest mismatch")

    # Re-seed the audit plane's counter baselines
    # under the same digest guard: the first post-restore sweep then
    # diffs against where the counters stood at checkpoint instead of
    # attributing each switch's lifetime counters as one giant fresh
    # delta. (A switch that redialed meanwhile reset its counters;
    # the attribution path re-baselines on counters-went-backwards,
    # so a stale baseline degrades to the old behavior, never a spike.)
    from sdnmpi_tpu_torch.oracle.routecache import RouteCache

    aud = snapshot.get("audit_baselines")
    audit = getattr(controller, "audit", None)
    if aud and audit is not None:
        if aud.get("topology_digest") == RouteCache.topology_digest(db):
            audit.cycle = int(aud.get("cycle", 0))
            for dpid, src, dst, pkts, bts in aud.get("rows", []):
                audit._counters.setdefault(int(dpid), {})[(src, dst)] = (
                    int(pkts), int(bts)
                )
        else:
            _cold_start(controller, "audit-baseline topology digest mismatch")

    # ... and the measured traffic matrix's EWMA state, so the sentinel
    # scores against the learned matrix instead of a blank one until
    # traffic re-accumulates
    tp = snapshot.get("traffic_plane")
    traffic = getattr(controller, "traffic", None)
    if tp and traffic is not None:
        if tp.get("topology_digest") == RouteCache.topology_digest(db):
            traffic.load_state(tp)
        else:
            _cold_start(controller, "traffic-plane topology digest mismatch")

    # Re-seed the route-cache memo BEFORE any re-routing below: the
    # reinstall passes then hit the restored entries (hit == miss
    # bit-identical, so this is purely a latency win). The restore is
    # version- AND topology-digest-guarded inside restore_entries — a
    # controller that discovered a different fabric restores nothing.
    memo = snapshot.get("route_cache")
    if memo and db.route_cache is not None:
        db.route_cache.restore_entries(memo, db)

    # The hier border plane restores BEFORE the re-routing below, which
    # then composes against the restored rows instead of re-sweeping
    # them. Digest/version mismatches leave the cold lazy build inside
    # the oracle (counted hier_snapshot_rejected_total), never a crash.
    border = snapshot.get("hier_border")
    cfg = getattr(controller.topology_manager, "config", None)
    if border and getattr(cfg, "hier_snapshot", True):
        db.hier_restore_border_rows(border)

    # Flows are restored by *re-routing* the snapshotted (src, dst) pairs
    # and pushing real FlowMods to whatever datapaths are currently live —
    # seeding the bookkeeping alone would dedup-suppress installs forever
    # while the switches sit empty. Restore after attach() so the
    # datapaths are connected.
    pairs = sorted(
        {
            tuple(pair.split(" "))
            for table in snapshot["fdb"].values()
            for pair in table
        }
    )
    controller.router.reinstall_pairs([(s, d) for s, d in pairs])

    # Block-installed collectives re-route wholesale against the live
    # topology and process registry (same discipline as reinstall_pairs:
    # the snapshot's identity is trusted, its paths are not).
    from sdnmpi_tpu_torch.control.events import CurrentProcessAllocationRequest

    rankdb = controller.bus.request(CurrentProcessAllocationRequest()).processes
    for coll in snapshot.get("collectives", []):
        pairs_arr = np.stack(
            [
                np.asarray(coll["src_idx"], dtype=np.int64),
                np.asarray(coll["dst_idx"], dtype=np.int64),
            ],
            axis=1,
        )
        controller.router._install_collective_blocks(
            coll["coll_type"], list(coll["ranks"]), coll["root"],
            pairs_arr, rankdb, policy=coll.get("policy"),
        )


def _port(d: dict) -> Port:
    return Port(d["dpid"], d["port_no"])


def save_checkpoint(controller, path: str | pathlib.Path) -> None:
    pathlib.Path(path).write_text(json.dumps(snapshot_controller(controller)))


def load_checkpoint(controller, path: str | pathlib.Path) -> None:
    restore_controller(controller, json.loads(pathlib.Path(path).read_text()))

"""Active/active controller pair: replicated stores, ownership fencing,
lease failover, reconcile-on-adopt.

Every serving number in the suite used to die with one process. This
module makes the control plane survive a controller loss by running N
(practically: two) controller processes over one fabric, split by the
deterministic switch partition of control/ownership.py:

- :class:`FencedSouthbound` wraps the shared southbound so a replica
  can only program the switches it owns. Fenced rows are counted and
  silently succeed (the owner installs them); owned ADD rows with a
  free cookie get stamped with the shard's ``(shard, epoch)`` token so
  the chaos acceptance can prove, from the fabric's own tables, which
  regime installed every row (no dual-owner installs).
- :class:`PairBus` is the event mux a shared fabric publishes into:
  dpid-scoped events go to the owning live replica (so ``Router.dps``
  *is* the ownership map, auto-scoping reconcile and the audit sweep);
  topology-wide events broadcast. Lifecycle events nobody owns (their
  owner is dead) are parked for the adopter.
- :class:`ReplicaPlane` replicates the three controller-private stores
  the fabric cannot re-teach quickly — desired-flow mutations (via the
  DesiredFlowStore ``on_mutate`` seam), process-registry events, and
  the TopologyDB delta-log version chain — as sequence-numbered op
  batches. A receive gap triggers a snapshot backfill over the same
  link (api/snapshot's capture), mirroring how the delta log itself
  falls back to full pulls. Lease heartbeats ride the same tick
  cadence as the echo machinery (EventStatsFlush); when a peer's
  lease expires the survivor adopts its shards: epoch bump, replicated
  tail drained, then one ``EventDatapathUp`` republish per adopted
  switch — *jittered* (recovery.jitter) and rate-shaped by the
  router's existing ``reconcile_max_per_flush`` budget, audited by the
  audit verify queue — so a failover storm cannot thundering-herd the
  fabric.

Replication transports: :class:`LoopLink` (in-process pair, the chaos
harness) and :class:`RpcReplicaLink` (JSON-RPC ``replica_relay``
notifications over the api/rpc WebSocket, the launch path). Messages
are JSON-safe dicts either way.

Everything here is opt-in: without ``--replica-peer`` no object in
this module is constructed and the single-controller path is
byte-identical (the acceptance pin).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Callable, Optional

import numpy as np

from sdnmpi_tpu_torch.control import events as ev
from sdnmpi_tpu_torch.control.ownership import OwnershipMap, cookie_token
from sdnmpi_tpu_torch.control.recovery import InstallVerdict
from sdnmpi_tpu_torch.protocol import openflow as of
from sdnmpi_tpu_torch.utils.metrics import REGISTRY

log = logging.getLogger(__name__)

_m_ops_sent = REGISTRY.counter(
    "replica_ops_sent_total", "replicated store mutations shipped to the peer")
_m_ops_applied = REGISTRY.counter(
    "replica_ops_applied_total", "replicated store mutations applied from the peer")
_m_heartbeats = REGISTRY.counter(
    "replica_heartbeats_total", "lease heartbeats sent to the peer")
_m_seq_gaps = REGISTRY.counter(
    "replica_seq_gaps_total", "inbound replication sequence gaps detected")
_m_snapshot_backfills = REGISTRY.counter(
    "replica_snapshot_backfills_total",
    "full-state backfills applied after a replication gap")
_m_lease_expiries = REGISTRY.counter(
    "replica_lease_expiries_total", "peer leases declared expired")
_m_adoptions = REGISTRY.counter(
    "replica_adoptions_total", "shards adopted from a dead peer")
_m_fenced = REGISTRY.counter(
    "replica_fenced_rows_total",
    "FlowMod rows fenced off an unowned switch (the peer installs them)")
_m_lag = REGISTRY.gauge(
    "replication_lag",
    "op batches shipped but not yet acknowledged by the peer")
_m_epoch = REGISTRY.gauge(
    "ownership_epoch", "highest shard ownership epoch on this replica")


# -- transports ------------------------------------------------------------


class LoopLink:
    """In-memory replication pipe between two planes in one process —
    the chaos-acceptance transport. ``kill()`` models a controller
    death (its inbox drains to nowhere and its peer's sends drop);
    ``drop_next`` swallows the next N sends to force a sequence gap."""

    def __init__(self) -> None:
        self.inbox: collections.deque = collections.deque()
        self.peer: Optional["LoopLink"] = None
        self.alive = True
        self.dropped = 0
        self.drop_next = 0

    @classmethod
    def pair(cls) -> tuple["LoopLink", "LoopLink"]:
        a, b = cls(), cls()
        a.peer, b.peer = b, a
        return a, b

    def send(self, msg: dict) -> None:
        peer = self.peer
        if not self.alive or peer is None or not peer.alive:
            self.dropped += 1
            return
        if self.drop_next > 0:
            self.drop_next -= 1
            self.dropped += 1
            return
        peer.inbox.append(msg)

    def recv(self) -> list:
        out = list(self.inbox)
        self.inbox.clear()
        return out

    def kill(self) -> None:
        self.alive = False
        self.inbox.clear()


class RpcReplicaLink:
    """Launch-mode transport: outbound messages become JSON-RPC
    ``replica_relay`` notifications to the peer's api/rpc WebSocket
    (launch.py binds the sender once the client connects); inbound
    notifications are ingested by RPCInterface into :meth:`ingest`.
    Sends before the peer is reachable drop — the sequence gap they
    open is exactly what the snapshot backfill protocol repairs."""

    def __init__(self) -> None:
        self.inbox: collections.deque = collections.deque()
        self.dropped = 0
        self._send: Optional[Callable[[dict], None]] = None

    def bind_sender(self, fn: Callable[[dict], None]) -> None:
        self._send = fn

    def send(self, msg: dict) -> None:
        if self._send is None:
            self.dropped += 1
            return
        try:
            self._send(msg)
        except Exception:  # peer unreachable: gap now, backfill later
            self.dropped += 1

    def ingest(self, msg: dict) -> None:
        self.inbox.append(msg)

    def recv(self) -> list:
        out = list(self.inbox)
        self.inbox.clear()
        return out


# -- fenced southbound -----------------------------------------------------

#: fabric-global knobs the Controller pushes at construction; they must
#: land on the real southbound, not be shadowed on the proxy
_FORWARD_ATTRS = frozenset(
    {"install_highwater", "send_barriers", "echo_interval", "echo_timeout"}
)


def _slice_batch(batch: "of.FlowModBatch", keep: np.ndarray):
    return dataclasses.replace(
        batch,
        src=np.asarray(batch.src)[keep],
        dst=np.asarray(batch.dst)[keep],
        out_port=np.asarray(batch.out_port)[keep],
        rewrite=(
            None if batch.rewrite is None
            else np.asarray(batch.rewrite)[keep]
        ),
    )


class FencedSouthbound:
    """Ownership fence + epoch stamp in front of a (shared) southbound.

    Sends to unowned switches are counted and swallowed *as successes*
    (empty verdict / True): the owner replica installs those rows, so
    they must not look like drops to the caller's retry machinery.
    Owned ADD rows whose cookie is free (0) are stamped with the
    shard's current ``(shard, epoch)`` token; nonzero cookies (the
    block plane's collective identities) pass untouched. Everything
    else — stats, barriers, packet-out — delegates to the wrapped
    southbound, so ``hasattr`` feature probes see the fabric's real
    surface.

    ``shared=True`` (two controllers, one in-process fabric) keeps
    ``on_idle`` local — the pair harness composes both routers' flush
    callbacks — and refuses ``connect`` (the PairBus is connected
    once, not per controller)."""

    def __init__(self, southbound, ownership: OwnershipMap,
                 shared: bool = True) -> None:
        d = self.__dict__
        d["southbound"] = southbound
        d["ownership"] = ownership
        d["shared"] = shared
        d["on_idle"] = None

    def __getattr__(self, name):
        return getattr(self.__dict__["southbound"], name)

    def __setattr__(self, name, value) -> None:
        if name in _FORWARD_ATTRS:
            setattr(self.__dict__["southbound"], name, value)
            return
        if not self.__dict__["shared"] and name not in (
            "southbound", "ownership", "shared"
        ):
            # sole user of the southbound (launch mode): every write —
            # on_idle, fault plans, clocks — belongs on the real fabric
            setattr(self.__dict__["southbound"], name, value)
            if name != "on_idle":
                return
        self.__dict__[name] = value

    def connect(self, bus) -> None:
        if self.__dict__["shared"]:
            raise RuntimeError(
                "shared pair fabric: connect the PairBus once via "
                "ControllerPair.attach(), not per controller")
        self.__dict__["southbound"].connect(bus)

    # -- install plane, fenced --

    def flow_mod(self, dpid: int, mod: "of.FlowMod"):
        om = self.ownership
        if not om.owns(dpid):
            _m_fenced.inc()
            return True  # the owner installs it; not a send failure
        if mod.command == of.OFPFC_ADD and mod.cookie == 0:
            mod = dataclasses.replace(mod, cookie=om.cookie_token(dpid))
        return self.southbound.flow_mod(dpid, mod)

    def flow_mods_batch(self, dpid: int, batch: "of.FlowModBatch"):
        om = self.ownership
        if not om.owns(dpid):
            _m_fenced.inc(len(batch))
            return InstallVerdict()
        if batch.command == of.OFPFC_ADD and batch.cookie == 0:
            batch = dataclasses.replace(
                batch, cookie=om.cookie_token(dpid))
        return self.southbound.flow_mods_batch(dpid, batch)

    def flow_mods_window(self, dpids, batch: "of.FlowModBatch"):
        om = self.ownership
        dpids = np.asarray(dpids)
        # vectorized per-row token: shard is dpid % count, token 0 for
        # shards served elsewhere (= fenced rows)
        shard_tok = np.zeros(om.count, dtype=np.int64)
        for s in range(om.count):
            if om.assignment[s] == om.index:
                shard_tok[s] = cookie_token(s, om.epoch.get(s, 0))
        tokens = shard_tok[dpids % om.count]
        owned = tokens != 0
        n_fenced = int(len(dpids) - int(owned.sum()))
        if n_fenced:
            _m_fenced.inc(n_fenced)
            if not owned.any():
                return InstallVerdict()
        if batch.command != of.OFPFC_ADD or batch.cookie != 0:
            # deletes and pre-cookied (collective) bursts: fence only
            if not n_fenced:
                return self.southbound.flow_mods_window(dpids, batch)
            keep = np.flatnonzero(owned)
            return self.southbound.flow_mods_window(
                dpids[keep], _slice_batch(batch, keep))
        # a FlowModBatch carries ONE cookie but owned shards may sit at
        # different epochs: forward one sub-window per token value. The
        # token is a function of dpid, so the sub-windows partition the
        # dpid set (per-dpid spans stay contiguous, verdicts disjoint).
        verdict = InstallVerdict()
        for tok in np.unique(tokens[owned]):
            keep = np.flatnonzero(tokens == tok)
            sub = dataclasses.replace(
                _slice_batch(batch, keep), cookie=int(tok))
            v = self.southbound.flow_mods_window(dpids[keep], sub)
            verdict.sent += v.sent
            verdict.dropped += v.dropped
            verdict.barriers += v.barriers
        return verdict


# -- shared-fabric event mux ----------------------------------------------


class PairBus:
    """The bus a *shared* fabric publishes into when two controllers
    ride one fabric: dpid-scoped events route to the live replica that
    owns the switch, topology-wide events broadcast to every live
    replica. Lifecycle events whose owner is dead are parked
    (``unowned_live`` / ``unowned_down``) so the adopter can
    reconstruct exact switch liveness at failover — the in-process
    twin of the replicated tail."""

    def __init__(self) -> None:
        self.nodes: dict[int, tuple] = {}  # index -> (bus, ownership)
        self.dead: set[int] = set()
        self.unowned_live: set[int] = set()
        self.unowned_down: set[int] = set()

    def register(self, index: int, bus, ownership: OwnershipMap) -> None:
        self.nodes[index] = (bus, ownership)

    def kill(self, index: int) -> None:
        self.dead.add(index)

    def publish(self, event) -> None:
        dpid = getattr(event, "dpid", None)
        alive = [
            (i, b, o) for i, (b, o) in sorted(self.nodes.items())
            if i not in self.dead
        ]
        if dpid is None:
            for _i, b, _o in alive:
                b.publish(event)
            return
        owners = [b for _i, b, o in alive if o.owns(dpid)]
        if not owners:
            if isinstance(event, ev.EventDatapathUp):
                self.unowned_live.add(int(dpid))
                self.unowned_down.discard(int(dpid))
            elif isinstance(event, ev.EventDatapathDown):
                self.unowned_down.add(int(dpid))
                self.unowned_live.discard(int(dpid))
            return
        for b in owners:
            b.publish(event)

    def take_orphans(self) -> tuple[list[int], list[int]]:
        """Drain the parked lifecycle state: (came up, went down) since
        the owner died, consumed exactly once by the adopter."""
        live = sorted(self.unowned_live)
        down = sorted(self.unowned_down)
        self.unowned_live = set()
        self.unowned_down = set()
        return live, down


# -- the replica plane -----------------------------------------------------


class ReplicaPlane:
    """Store replication + lease failover for one replica of the pair.

    Ticks on the controller's EventStatsFlush edge (the same cadence
    the echo keepalive rides). Each tick: drain inbound messages,
    ship the TopologyDB version chain and staged store ops as one
    sequence-numbered batch, heartbeat, check the peer's lease, drain
    jittered adoption republies and rate-capped targeted re-drives.

    The op log is *semantic*, not byte-oriented: desired-flow
    mutations replay through DesiredFlowStore.record/remove (with the
    ``_applying`` latch suppressing echo), registry events replay
    through the rankdb + a republish (so the peer's Router prunes
    flows for departed ranks on the switches *it* owns), topology
    deltas ship as version markers (content rides the broadcast
    discovery events; a gap falls back to the api/snapshot backfill,
    exactly like the delta log's own full-pull fallback)."""

    def __init__(self, controller, ownership: OwnershipMap, link,
                 config, clock: Callable[[], float] = time.monotonic,
                 mux: Optional[PairBus] = None) -> None:
        self.controller = controller
        self.ownership = ownership
        self.link = link
        self.config = config
        self.clock = clock
        self.mux = mux
        self.bus = controller.bus
        self.router = controller.router
        self.index = ownership.index

        self._applying = False   # replaying peer ops: don't re-stage
        self._staged: list = []
        self._seq_out = 0        # last batch shipped
        self._seq_in = 0         # last batch applied
        self._need_backfill = False
        self._topo_version = 0   # last TopologyDB version shipped
        self._peer_topo_version = 0
        self._peer_acked = 0
        self._peer_dps: dict[int, list[int]] = {}
        self._peer_alive: dict[int, bool] = {}
        self._last_heard: dict[int, float] = {}
        self._last_hb: Optional[float] = None
        self._adopt_due: list[tuple[float, int]] = []
        self._redrive_q: collections.deque = collections.deque()
        self._redrive_rows: dict[int, set] = {}
        self._delete_rows: dict[int, set] = {}

        self.router.recovery.desired.on_mutate = self._desired_mutated
        self.bus.subscribe(ev.EventProcessAdd, self._process_add)
        self.bus.subscribe(ev.EventProcessDelete, self._process_delete)
        _m_epoch.set(max(ownership.epoch.values(), default=0))

    # -- staging (local mutations -> op log) --

    def _desired_mutated(self, op: tuple) -> None:
        if not self._applying:
            self._staged.append(("desired",) + tuple(op))

    def _process_add(self, event: ev.EventProcessAdd) -> None:
        if not self._applying:
            self._staged.append(("rank", "add", int(event.rank), event.mac))

    def _process_delete(self, event: ev.EventProcessDelete) -> None:
        if not self._applying:
            self._staged.append(("rank", "del", int(event.rank)))

    # -- tick --

    def tick(self, now: Optional[float] = None) -> None:
        now = self.clock() if now is None else now
        for msg in self.link.recv():
            self._handle(msg, now)
        self._ship_topology()
        self._flush_ops()
        interval = self.config.replica_lease_interval_s
        if self._last_hb is None or now - self._last_hb >= interval:
            self._send_heartbeat(now)
        self._check_leases(now)
        self._drain_adoptions(now)
        self._drain_redrives()
        if any(self._peer_alive.get(p, True) for p in self._peers()):
            _m_lag.set(max(0, self._seq_out - self._peer_acked))
        else:
            _m_lag.set(0)

    def _peers(self) -> list[int]:
        return [i for i in range(self.ownership.count) if i != self.index]

    def _ship_topology(self) -> None:
        db = self.controller.topology_manager.topologydb
        version = db.version
        if version == self._topo_version:
            return
        deltas = db.deltas_since(self._topo_version)
        if deltas is None:
            # our own delta log no longer covers what the peer missed:
            # ship the full entity map, the log's own fallback shape
            self._staged.append(("topo_full", version, db.to_dict()))
        else:
            self._staged.append(
                ("topo", version, [list(e) for e in deltas]))
        self._topo_version = version

    def _flush_ops(self) -> None:
        if not self._staged:
            return
        self._seq_out += 1
        self.link.send({
            "kind": "ops", "from": self.index, "seq": self._seq_out,
            "ops": self._staged,
        })
        _m_ops_sent.inc(len(self._staged))
        self._staged = []

    def _send_heartbeat(self, now: float) -> None:
        self.link.send({
            "kind": "hb", "from": self.index,
            "seq": self._seq_out, "acked": self._seq_in,
            "dps": sorted(int(d) for d in self.router.dps),
            "ownership": self.ownership.to_dict(),
        })
        _m_heartbeats.inc()
        self._last_hb = now

    # -- inbound --

    def _handle(self, msg: dict, now: float) -> None:
        kind = msg.get("kind")
        if kind == "ops":
            self._handle_ops(msg)
        elif kind == "hb":
            frm = int(msg["from"])
            if not self._peer_alive.get(frm, True):
                # a declared-dead peer talking again: its shards were
                # adopted and its epoch fenced out — it must restart
                log.warning("replica %d: heartbeat from expired peer %d "
                            "(fenced; it must rejoin via restart)",
                            self.index, frm)
                return
            self._last_heard[frm] = now
            self._peer_acked = max(self._peer_acked, int(msg["acked"]))
            self._peer_dps[frm] = [int(d) for d in msg.get("dps", ())]
        elif kind == "snap_req":
            self._send_snapshot()
        elif kind == "snap":
            self._apply_snapshot(msg.get("snapshot") or {})
            self._seq_in = int(msg["seq"])
            self._need_backfill = False
            _m_snapshot_backfills.inc()

    def _handle_ops(self, msg: dict) -> None:
        seq = int(msg["seq"])
        if self._need_backfill or seq <= self._seq_in:
            return  # awaiting backfill / duplicate
        if seq != self._seq_in + 1:
            _m_seq_gaps.inc()
            self._need_backfill = True
            log.warning("replica %d: replication gap (have %d, got %d); "
                        "requesting snapshot backfill",
                        self.index, self._seq_in, seq)
            self.link.send({"kind": "snap_req", "from": self.index})
            return
        for op in msg.get("ops", ()):
            self._apply_op(tuple(op))
        self._seq_in = seq

    def _send_snapshot(self) -> None:
        from sdnmpi_tpu_torch.api.snapshot import snapshot_controller

        self._flush_ops()  # the snapshot covers everything staged
        self.link.send({
            "kind": "snap", "from": self.index, "seq": self._seq_out,
            "snapshot": snapshot_controller(self.controller),
        })

    # -- op replay --

    def _apply_op(self, op: tuple) -> None:
        kind = op[0]
        if kind == "desired":
            self._apply_desired(op[1:])
        elif kind == "rank":
            self._apply_rank(op[1:])
        elif kind in ("topo", "topo_full"):
            self._peer_topo_version = int(op[1])
            if kind == "topo_full":
                pass  # entity content rides the broadcast discovery
                # events in-process; launch mode backfills via snapshot
        _m_ops_applied.inc()

    def _apply_desired(self, op: tuple) -> None:
        verb, dpid = op[0], int(op[1])
        desired = self.router.recovery.desired
        self._applying = True
        try:
            if verb == "record":
                _v, _d, src, dst, out_port, rewrite, collective = op
                desired.record(dpid, src, dst, int(out_port), rewrite,
                               bool(collective))
            else:
                _v, _d, src, dst = op
                desired.remove(dpid, src, dst)
        finally:
            self._applying = False
        if not self.ownership.owns(dpid):
            return
        # owned switch: the peer computed a route crossing our shard —
        # queue a targeted, rate-capped re-drive (or delete)
        if verb == "record":
            self._redrive_rows.setdefault(dpid, set()).add((src, dst))
            if dpid not in self._redrive_q:
                self._redrive_q.append(dpid)
        else:
            self._delete_rows.setdefault(dpid, set()).add((src, dst))
            if dpid not in self._redrive_q:
                self._redrive_q.append(dpid)

    def _apply_rank(self, op: tuple) -> None:
        pm = self.controller.process_manager
        self._applying = True
        try:
            if op[0] == "add":
                rank, mac = int(op[1]), op[2]
                pm.rankdb.add_process(rank, mac)
                # republish: our Router prunes/installs for this rank
                # on the switches WE own (the peer's sends are fenced)
                self.bus.publish(ev.EventProcessAdd(rank, mac))
            else:
                rank = int(op[1])
                pm.rankdb.delete_process(rank)
                self.bus.publish(ev.EventProcessDelete(rank))
        finally:
            self._applying = False

    def _apply_snapshot(self, snapshot: dict) -> None:
        """Lean backfill: replay only the replicated stores (desired
        rows + rank table) out of an api/snapshot capture. The full
        restore path (route cache, audit baselines, traffic EWMA)
        stays per-replica — those planes rebuild from the fabric."""
        for rank_str, mac in (snapshot.get("rankdb") or {}).items():
            self._apply_rank(("add", int(rank_str), mac))
        rows = (snapshot.get("desired_flows") or {}).get("rows", ())
        for row in rows:
            dpid, src, dst, out_port, rewrite, collective = row
            self._apply_desired((
                "record", int(dpid), src, dst, int(out_port), rewrite,
                bool(collective),
            ))

    # -- lease + adoption --

    def _check_leases(self, now: float) -> None:
        timeout = self.config.replica_lease_timeout_s
        for peer in self._peers():
            if not self._peer_alive.get(peer, True):
                continue
            last = self._last_heard.get(peer)
            if last is None:
                self._last_heard[peer] = now  # lease grace starts now
            elif now - last > timeout:
                self._expire(peer, now)

    def _expire(self, peer: int, now: float) -> None:
        self._peer_alive[peer] = False
        _m_lease_expiries.inc()
        log.warning("replica %d: peer %d lease expired; adopting its "
                    "shards", self.index, peer)
        self.bus.publish(ev.EventPeerLeaseExpired(peer))
        for shard in self.ownership.shards_of(peer):
            epoch = self.ownership.adopt(shard)
            _m_adoptions.inc()
            self.bus.publish(ev.EventShardAdopted(shard, epoch, self.index))
        _m_epoch.set(max(self.ownership.epoch.values(), default=0))
        # replay any tail the dead peer shipped before it stopped
        for msg in self.link.recv():
            self._handle(msg, now)
        # reconstruct the adopted shard's switch liveness: the peer's
        # last heartbeat, corrected by lifecycle events that went
        # unowned after the death
        dpids = set(self._peer_dps.get(peer, ()))
        if self.mux is not None:
            live, down = self.mux.take_orphans()
            dpids |= set(live)
            dpids -= set(down)
        dpids = {
            int(d) for d in dpids
            if self.ownership.owns(d) and d not in self.router.dps
        }
        # jittered republish: each EventDatapathUp rides the Router's
        # budgeted reconcile path and the audit verify queue — the
        # rate-shaped, audit-verified re-drive, de-synchronized so a
        # pair-wide failover can't thundering-herd the fabric
        base = self.config.replica_adopt_backoff_s
        jitter = self.router.recovery.jitter
        for d in sorted(dpids):
            self._adopt_due.append((now + jitter(base), d))

    def _drain_adoptions(self, now: float) -> None:
        if not self._adopt_due:
            return
        ready = [x for x in self._adopt_due if x[0] <= now]
        if not ready:
            return
        self._adopt_due = [x for x in self._adopt_due if x[0] > now]
        audit = self.controller.audit
        for _t, dpid in sorted(ready):
            if dpid in self.router.dps:
                continue
            self.bus.publish(ev.EventDatapathUp(dpid))
            if audit is not None:
                audit.request_verify(dpid)

    def _drain_redrives(self) -> None:
        budget = self.config.replica_redrive_per_tick or len(self._redrive_q)
        desired = self.router.recovery.desired
        while self._redrive_q and budget > 0:
            budget -= 1
            dpid = self._redrive_q.popleft()
            keys = self._redrive_rows.pop(dpid, set())
            dels = self._delete_rows.pop(dpid, set())
            if dpid not in self.router.dps:
                continue  # reconcile-on-connect covers it instead
            if dels:
                self.router.audit_delete(dpid, sorted(dels))
            rows = [
                (s, d, spec) for s, d, spec in desired.entries_for(dpid)
                if (s, d) in keys
            ]
            if rows:
                self.router.audit_redrive(dpid, rows)

    # -- observability --

    def status(self) -> dict:
        """Forensics payload: the flight recorder's "replica" context
        and the ``replica_status`` pull RPC."""
        return {
            "mode": "pair",
            "index": self.index,
            "ownership": self.ownership.to_dict(),
            "seq_out": self._seq_out,
            "seq_in": self._seq_in,
            "staged": len(self._staged),
            "peer_acked": self._peer_acked,
            "lag": max(0, self._seq_out - self._peer_acked),
            "peer_alive": {
                p: self._peer_alive.get(p, True) for p in self._peers()
            },
            "adopt_queue": len(self._adopt_due),
            "redrive_queue": len(self._redrive_q),
            "need_backfill": self._need_backfill,
        }


# -- pair harness ----------------------------------------------------------


@dataclasses.dataclass
class ControllerPair:
    """Two controllers over one shared fabric — the chaos-acceptance
    and benchmark harness (and the reference wiring for launch mode)."""

    fabric: object
    mux: PairBus
    controllers: list
    proxies: list
    links: tuple

    def plane(self, index: int):
        return self.controllers[index].replica

    def attach(self) -> None:
        self.fabric.connect(self.mux)
        self.fabric.on_idle = self._idle

    def _idle(self) -> None:
        for i, proxy in enumerate(self.proxies):
            cb = proxy.on_idle
            if cb is not None and i not in self.mux.dead:
                cb()

    def kill(self, index: int) -> None:
        """Model controller ``index`` dying: no more events, no more
        replication traffic, its heartbeats stop."""
        self.mux.kill(index)
        self.links[index].kill()

    def poll(self, now: float) -> None:
        """One Monitor pass per live controller — the EventStatsFlush
        edge that drives anti-entropy, audit, and the replica tick."""
        for i, c in enumerate(self.controllers):
            if i not in self.mux.dead:
                c.monitor.poll(now=now)

    def survivor(self):
        alive = [c for i, c in enumerate(self.controllers)
                 if i not in self.mux.dead]
        return alive[0] if alive else None


def build_pair(fabric, config, clock: Callable[[], float] = time.monotonic,
               count: int = 2) -> ControllerPair:
    """Wire ``count`` controllers (practically 2) over one shared
    fabric: per-replica OwnershipMap + FencedSouthbound, a LoopLink
    mesh pair, and the PairBus mux. Call ``pair.attach()`` to connect
    the fabric (NOT controller.attach())."""
    from sdnmpi_tpu_torch.control.controller import Controller

    if count != 2:
        raise NotImplementedError("LoopLink harness is a pair (count=2)")
    links = LoopLink.pair()
    mux = PairBus()
    controllers, proxies = [], []
    for i in range(count):
        om = OwnershipMap(count, i)
        proxy = FencedSouthbound(fabric, om, shared=True)
        c = Controller(proxy, config, ownership=om, replica_link=links[i])
        c.replica.clock = clock
        c.replica.mux = mux
        mux.register(i, c.bus, om)
        controllers.append(c)
        proxies.append(proxy)
    pair = ControllerPair(fabric, mux, controllers, proxies, links)
    return pair

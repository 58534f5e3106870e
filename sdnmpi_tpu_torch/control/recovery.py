"""Failure-domain recovery plane — desired state, acked installs, retries.

PRs 1-4 made the route->install pipeline fast; every leg of it was still
fire-and-forget: ``OFSouthbound._send`` returns a
queued/dropped verdict but a dropped window was simply lost, a switch
that crashed and redialed came back with an EMPTY flow table while the
Router still believed its flows were installed, and a half-open TCP
peer stayed "connected" forever. This module holds the bookkeeping that
closes the loop; the Router drives it (control/router.py) and the
southbounds feed it verdicts:

- :class:`DesiredFlowStore` — per-switch record of what SHOULD be
  installed (the Router's flow bookkeeping, minus the dedup role the
  SwitchFDB keeps). It survives ``EventDatapathDown``, which is the
  whole point: on ``EventDatapathUp`` for a known dpid the Router
  reconciles the returning switch against it, and the periodic
  anti-entropy pass re-drives switches whose window sends were dropped.
- :class:`InstallVerdict` — what one batched southbound send actually
  did: which switches got their whole byte span queued, which dropped
  it, and the OFPT_BARRIER_REQUEST xids terminating each switch's span
  (protocol/ofwire.py; the ack is the install's end-to-end receipt).
- :class:`RecoveryPlane` — pending-barrier table (ack -> RTT histogram,
  no ack -> resync), and the bounded per-switch retry queue with
  exponential backoff + seeded jitter (``Config.install_retry_max``,
  ``Config.install_retry_backoff_s``). Exhausted retries escalate to a
  full datapath resync (wipe + re-drive) rather than silently diverge.

DeltaPath (PAPERS.md) frames failure recovery as incremental repair;
this is the control-plane twin of that idea: recovery re-drives only
the failed switch's desired set through the batched window path,
never the whole fabric.
"""

from __future__ import annotations

import dataclasses
import random
import time

from sdnmpi_tpu_torch.utils.metrics import LATENCY_BUCKETS_S, REGISTRY

# -- recovery telemetry (first-class citizens of the metrics registry) -------
_m_reconcile_flows = REGISTRY.counter(
    "reconcile_flows_total",
    "desired flows re-driven to a switch by the reconciler",
)
_m_reconcile_passes = REGISTRY.counter(
    "reconcile_passes_total",
    "per-switch reconciliation passes (datapath-up + anti-entropy)",
)
_m_retries = REGISTRY.counter(
    "install_retries_total",
    "retry-queue re-drives of dropped/un-acked install windows",
)
_m_giveups = REGISTRY.counter(
    "install_retry_giveups_total",
    "switches whose bounded retries exhausted (escalated to resync)",
)
_m_resyncs = REGISTRY.counter(
    "install_resyncs_total",
    "full datapath resyncs (table wipe + state re-drive) after retry "
    "exhaustion",
)
_m_reconcile_deferred = REGISTRY.counter(
    "reconcile_deferred_total",
    "datapath-up reconciles deferred past the per-flush cap "
    "(Config.reconcile_max_per_flush — a power-cycled pod redialing at "
    "once must not flood the install plane)",
)
_m_barrier_rtt = REGISTRY.histogram(
    "barrier_rtt_seconds", LATENCY_BUCKETS_S,
    "install window send -> OFPT_BARRIER_REPLY round-trip",
)
_m_barrier_timeouts = REGISTRY.counter(
    "barrier_timeouts_total",
    "install windows whose barrier ack never arrived in time",
)
_m_pending_barriers = REGISTRY.gauge(
    "barriers_pending", "install windows awaiting their barrier ack"
)
_m_desired_flows = REGISTRY.gauge(
    "desired_flows", "flows in the desired-state store across all switches"
)
# registered here (not only in control/southbound.py, whose incrementing
# site lives beside the echo keepalive) so the family is present in
# every controller's exposition — a sim-fabric deployment's dashboards
# must not change shape when it moves to real TCP switches
REGISTRY.counter(
    "echo_timeouts_total",
    "half-open datapaths aborted by the controller-side echo keepalive",
)

#: early barrier acks kept for matching (the simulated Fabric acks
#: synchronously, BEFORE the caller can register the pending barrier)
_EARLY_ACK_CAP = 1024


@dataclasses.dataclass(frozen=True)
class FlowSpec:
    """What one desired flow installs beyond its (src, dst) match: the
    output port and the optional last-hop dl_dst rewrite (MPI virtual ->
    real MAC). Priority/timeouts are uniform per Config, so the store
    does not repeat them per row. ``collective`` marks rows installed by
    the phase scheduler's block plane: they reconcile like any
    other desired row but carry no SwitchFDB bookkeeping — the
    collective table, not the FDB, owns their lifecycle."""

    out_port: int
    rewrite: str | None = None
    collective: bool = False


@dataclasses.dataclass
class InstallVerdict:
    """Outcome of one batched southbound send (see module docstring).

    ``sent``/``dropped`` are dpids; a dpid appears in exactly one of
    them per send. ``barriers`` is ``[(dpid, xid), ...]`` — one
    OFPT_BARRIER_REQUEST terminates each successfully queued span when
    barriers are enabled, and its ack (EventBarrierAck) is the
    end-to-end receipt the RecoveryPlane times out on."""

    sent: list = dataclasses.field(default_factory=list)
    dropped: list = dataclasses.field(default_factory=list)
    barriers: list = dataclasses.field(default_factory=list)


class DesiredFlowStore:
    """dpid -> (src, dst) -> FlowSpec: what SHOULD be installed.

    Deliberately NOT cleared on datapath down — a crashed switch's
    desired set is exactly what the reconciler re-drives when it
    redials. Rows leave only through intentional teardown (revalidation
    re-routes, rank exits, switch-side expiry)."""

    def __init__(self) -> None:
        self.flows: dict[int, dict[tuple[str, str], FlowSpec]] = {}
        self._count = 0
        #: replication seam: when set, every effective
        #: mutation is reported as one op tuple —
        #: ``("record", dpid, src, dst, out_port, rewrite, collective)``
        #: with the values actually STORED (first-writer-wins ownership
        #: included), or ``("remove", dpid, src, dst)`` for a row that
        #: existed. None (the default) costs one attribute load per
        #: mutation — the single-controller path is unchanged.
        self.on_mutate = None

    def record(
        self, dpid: int, src: str, dst: str, out_port: int,
        rewrite: str | None = None, collective: bool = False,
    ) -> None:
        table = self.flows.setdefault(dpid, {})
        prev = table.get((src, dst))
        if prev is None:
            self._count += 1
        # ownership is first-writer-wins (cleared only by remove): a
        # re-record of the same match never flips a row between
        # FDB-owned and collective-owned — a reactive packet-in racing
        # a phased program's byte-identical row would otherwise hand it
        # flow timeouts on the next reconcile (and the reverse would
        # strip the FDB bookkeeping)
        spec = FlowSpec(
            int(out_port), rewrite,
            collective if prev is None else prev.collective,
        )
        table[(src, dst)] = spec
        _m_desired_flows.set(self._count)
        if self.on_mutate is not None:
            self.on_mutate((
                "record", dpid, src, dst, spec.out_port, spec.rewrite,
                spec.collective,
            ))

    def record_many(
        self, dpids, srcs, dsts, out_ports, rewrites,
        collective: bool = False,
    ) -> None:
        """Bulk :meth:`record` over parallel row sequences: one pass,
        one gauge update. The phase scheduler's install leg records a
        whole phase's rows (flagship scale: ~1e6 per program) here
        instead of a scalar call per row."""
        flows = self.flows
        on_mutate = self.on_mutate
        fresh = 0
        for dpid, src, dst, port, rewrite in zip(
            dpids, srcs, dsts, out_ports, rewrites
        ):
            table = flows.setdefault(dpid, {})
            prev = table.get((src, dst))
            if prev is None:
                fresh += 1
            # first-writer-wins ownership, same rule as record(): a
            # reactive flow can be byte-identical to a phase row (the
            # kickoff packet's), and stealing it would strip its
            # SwitchFDB bookkeeping on the next reconcile
            spec = FlowSpec(
                int(port), rewrite,
                collective if prev is None else prev.collective,
            )
            table[(src, dst)] = spec
            if on_mutate is not None:
                on_mutate((
                    "record", int(dpid), src, dst, spec.out_port,
                    spec.rewrite, spec.collective,
                ))
        self._count += fresh
        _m_desired_flows.set(self._count)

    def remove(self, dpid: int, src: str, dst: str) -> None:
        table = self.flows.get(dpid)
        if table is None or table.pop((src, dst), None) is None:
            return
        self._count -= 1
        if not table:
            del self.flows[dpid]
        _m_desired_flows.set(self._count)
        if self.on_mutate is not None:
            self.on_mutate(("remove", int(dpid), src, dst))

    def has(self, dpid: int, src: str, dst: str) -> bool:
        return (src, dst) in self.flows.get(dpid, {})

    def entries_for(self, dpid: int) -> list[tuple[str, str, FlowSpec]]:
        """This switch's desired rows in deterministic order (the
        reconciler's unit of work; sorted so a reconcile install is
        byte-identical run to run)."""
        table = self.flows.get(dpid, {})
        return [(s, d, spec) for (s, d), spec in sorted(table.items())]

    def total(self) -> int:
        return self._count


@dataclasses.dataclass
class _Retry:
    """One switch's pending re-drive: ``resync`` re-pushes the whole
    desired set; ``deletes`` re-drives specific dropped teardowns."""

    due: float = 0.0
    resync: bool = False
    deletes: set = dataclasses.field(default_factory=set)


class RecoveryPlane:
    """Retry/backoff + barrier-ack bookkeeping (see module docstring).

    Single-threaded by bus discipline, like every control-plane store.
    ``now`` parameters take ``time.monotonic()`` values; tests inject
    their own clock."""

    def __init__(self, config, seed: int = 0) -> None:
        self.config = config
        self.desired = DesiredFlowStore()
        self._rng = random.Random(seed)
        self._retries: dict[int, _Retry] = {}
        #: (dpid, xid) -> (send time, delete rows | None) of barriers
        #: awaiting their ack — DELETE windows carry their rows so an
        #: expiry re-drives the teardown itself, not just the ADD set
        self._pending: dict[tuple[int, int], tuple] = {}
        #: dpid -> teardown rows whose delivery is unconfirmed and whose
        #: switch went away before the retry could run. Survives the
        #: down edge on purpose: a TCP-bounced switch KEEPS its flow
        #: table, so reconcile-on-up must re-drive these deletes or the
        #: stale flows forward forever (the desired store alone only
        #: covers the ADD side).
        self._lost_deletes: dict[int, set] = {}
        #: acks that arrived before their send registered (sim fabrics
        #: ack synchronously inside flow_mods_window): (dpid, xid) -> t
        self._early_acks: dict[tuple[int, int], float] = {}
        #: consecutive failed re-drives per dpid (cleared on success)
        self._attempts: dict[int, int] = {}
        #: escalation hook fired when a dropped send cannot be queued
        #: because the dpid's bounded retries are already exhausted —
        #: the Router points this at its wipe-and-resync. Without it a
        #: drop landing AFTER exhaustion would be given up silently
        #: (found by the seeded chaos soak: a revalidation reinstall
        #: dropped post-exhaustion stayed missing through quiesce).
        self.on_exhausted = None

    # -- send outcomes ----------------------------------------------------

    def note_send(
        self, verdict, delete_rows=None, now: float | None = None,
        reschedule: bool = True,
    ) -> None:
        """Digest one batched send's outcome: register its barriers and
        (when ``reschedule``) queue retries for its dropped switches.
        ``delete_rows`` maps dpid -> set[(src, dst)] for DELETE windows,
        so a dropped teardown re-drives as a teardown, not a resync.
        ``verdict`` may be None (duck-typed southbounds without the
        verdict contract) — a no-op, the fire-and-forget legacy."""
        if verdict is None:
            return
        now = time.monotonic() if now is None else now
        for dpid, xid in verdict.barriers:
            t_ack = self._early_acks.pop((dpid, xid), None)
            if t_ack is not None:
                _m_barrier_rtt.observe(max(0.0, t_ack - now))
            else:
                rows = None if delete_rows is None else delete_rows.get(dpid)
                self._pending[(dpid, xid)] = (
                    now, None if rows is None else frozenset(rows)
                )
        _m_pending_barriers.set(len(self._pending))
        if not reschedule:
            return
        for dpid in verdict.dropped:
            rows = None if delete_rows is None else delete_rows.get(dpid)
            if (
                not self.schedule(dpid, now, deletes=rows,
                                  resync=rows is None)
                and self.on_exhausted is not None
            ):
                self.on_exhausted(dpid, now)

    def ack(self, dpid: int, xid: int, now: float | None = None) -> None:
        """An OFPT_BARRIER_REPLY (EventBarrierAck) arrived."""
        now = time.monotonic() if now is None else now
        entry = self._pending.pop((dpid, xid), None)
        if entry is None:
            # sim fabrics ack before note_send registers the barrier;
            # park it for the imminent match (bounded, FIFO-evicted)
            self._early_acks[(dpid, xid)] = now
            while len(self._early_acks) > _EARLY_ACK_CAP:
                self._early_acks.pop(next(iter(self._early_acks)))
            return
        _m_barrier_rtt.observe(now - entry[0])
        _m_pending_barriers.set(len(self._pending))

    def expire_barriers(self, now: float, timeout_s: float) -> dict:
        """Pop every pending barrier older than ``timeout_s``. Returns
        ``{dpid: (delete_rows, resync)}``: an expired DELETE window
        re-drives its own rows; an expired install window (rows None)
        asks for a desired-set resync — both may be true when several
        windows expired together."""
        expired = [k for k, (t0, _rows) in self._pending.items()
                   if now - t0 >= timeout_s]
        stale: dict[int, tuple[set, bool]] = {}
        for key in expired:
            _t0, rows = self._pending.pop(key)
            _m_barrier_timeouts.inc()
            deletes, resync = stale.get(key[0], (set(), False))
            if rows is None:
                resync = True
            else:
                deletes = deletes | set(rows)
            stale[key[0]] = (deletes, resync)
        if expired:
            _m_pending_barriers.set(len(self._pending))
        return stale

    def stash_lost_deletes(self, dpid: int, rows) -> None:
        """Park teardown rows whose switch is unreachable; the next
        reconcile drains them (see _lost_deletes)."""
        if rows:
            self._lost_deletes.setdefault(dpid, set()).update(rows)

    def take_lost_deletes(self, dpid: int) -> set:
        return self._lost_deletes.pop(dpid, set())

    # -- retry queue ------------------------------------------------------

    def schedule(
        self, dpid: int, now: float, deletes=None, resync: bool = True,
    ) -> bool:
        """Queue a re-drive for ``dpid`` with exponential backoff +
        jitter. Returns False when the bounded retries are exhausted —
        the caller escalates to a full resync (and the attempt clock
        restarts)."""
        attempt = self._attempts.get(dpid, 0) + 1
        if attempt > self.config.install_retry_max:
            _m_giveups.inc()
            self._attempts.pop(dpid, None)
            self._retries.pop(dpid, None)
            return False
        self._attempts[dpid] = attempt
        retry = self._retries.setdefault(dpid, _Retry())
        if deletes:
            retry.deletes |= set(deletes)
        if resync:
            retry.resync = True
        backoff = self.config.install_retry_backoff_s * (2 ** (attempt - 1))
        retry.due = now + backoff + self.jitter(backoff)
        return True

    def jitter(self, base: float) -> float:
        """One seeded jitter draw over ``base`` seconds: uniform in
        ``[0, base / 4)``. The shared de-synchronizer — retry backoff, retry-exhaustion wipe-resyncs, and
        reconcile-on-adopt all draw from this one seeded stream, so
        simultaneous failures spread instead of thundering-herd the
        install plane, and a seeded test replays the exact schedule.
        ``base <= 0`` draws nothing and returns 0 (the FAST_RECOVERY /
        zero-backoff test path stays byte-identical)."""
        if base <= 0:
            return 0.0
        return base * 0.25 * self._rng.random()

    def pop_due(self, now: float) -> list[tuple[int, _Retry]]:
        """Remove and return every retry whose backoff elapsed. The
        attempt count stays on the books until :meth:`succeed` — a
        re-drive that fails again resumes the backoff curve where it
        left off."""
        due = [(d, r) for d, r in self._retries.items() if r.due <= now]
        for dpid, _ in due:
            del self._retries[dpid]
        return due

    def succeed(self, dpid: int) -> None:
        """A re-drive (or reconcile) for ``dpid`` went through cleanly:
        its failure streak is over."""
        self._attempts.pop(dpid, None)

    def forget(self, dpid: int) -> None:
        """Datapath down: its pending barriers will never ack and its
        queued retries are moot — reconcile-on-up re-drives from the
        desired store, which this deliberately does NOT touch.
        Unconfirmed TEARDOWN rows are parked in the lost-delete ledger
        instead of dropped: a bounced switch keeps its flow table, and
        only re-driving the deletes can clear the stale entries."""
        retry = self._retries.pop(dpid, None)
        if retry is not None:
            self.stash_lost_deletes(dpid, retry.deletes)
        self._attempts.pop(dpid, None)
        stale = [k for k in self._pending if k[0] == dpid]
        for key in stale:
            _t0, rows = self._pending.pop(key)
            if rows:
                self.stash_lost_deletes(dpid, rows)
        if stale:
            _m_pending_barriers.set(len(self._pending))

    def in_flight(self, dpid: int) -> bool:
        """True while this switch has recovery machinery mid-air —
        un-acked barriers, a queued retry, or parked lost deletes. The
        audit plane (control/audit.py) skips such switches: their
        installed-vs-desired gap is already being repaired, and
        flagging it as fabric divergence would double-drive the repair
        (and page on what is ordinary retry latency)."""
        return (
            dpid in self._retries
            or dpid in self._lost_deletes
            or any(k[0] == dpid for k in self._pending)
        )

    # -- metric seams (the Router counts through these so the counters
    # live beside the machinery they describe) ----------------------------

    @staticmethod
    def note_reconcile(n_flows: int) -> None:
        _m_reconcile_passes.inc()
        _m_reconcile_flows.inc(n_flows)

    @staticmethod
    def note_retry() -> None:
        _m_retries.inc()

    @staticmethod
    def note_resync() -> None:
        _m_resyncs.inc()

    @staticmethod
    def note_reconcile_deferred() -> None:
        _m_reconcile_deferred.inc()

"""Fabric ground-truth audit plane.

Every other observability layer instruments the
controller's OWN pipeline; nothing observed the fabric. Installed state
was asserted only in tests, the recovery plane's wipe-and-resync
escalation trusted the wipe, and a switch silently corrupting its table
— a row dropped by a firmware bug, a row inserted by a rogue writer, a
counter ASIC going dead — was invisible forever. This module is the
independent ground-truth channel:

- **Sweep**: per ``EventStatsFlush`` a shard of the switch space
  answers OFPST_FLOW (``southbound.flow_stats``; the wire codec is
  protocol/ofwire.py, multipart), paced by
  ``Config.audit_switches_per_flush`` so a 1024-switch fabric audits in
  bounded round-robin slices — the install plane's ``install_highwater``
  idiom applied to the stats plane.
- **Diff**: replies canonicalize to the Router's install scope (the
  default-priority exact-L2 rows with cookie 0 — bootstrap control
  rules and block-plane rows are other subsystems' property) and diff
  against the :class:`~sdnmpi_tpu_torch.control.recovery.DesiredFlowStore`
  three ways: **missing** desired rows (absent, or present with the
  wrong actions — a blackholed row is a missing desired row), **orphan**
  rows the store never recorded, and **counter-dead** rows that should
  carry traffic (their pair's counters advance on other switches while
  this row stays flat across consecutive sweeps — the dead-counter /
  diverted-traffic signature).
- **Confirm, then heal**: a suspected divergence must survive
  ``Config.audit_confirm_sweeps`` consecutive sweeps before it is
  confirmed — one-sweep transients (a packet-out-bypassed first packet,
  an install racing the sweep) clear themselves — and switches whose
  recovery machinery is mid-air (``RecoveryPlane.in_flight``) are
  skipped entirely: their gap is already being repaired. Confirmed rows
  count into ``fabric_divergence_total{kind}``, feed the
  reconcile/resync path as TARGETED re-drives (missing/dead rows
  reinstall through ``Router.audit_redrive`` — OF 1.0 ADD replaces the
  corrupt entry; orphans tear down through ``Router.audit_delete``),
  and freeze a flight-recorder bundle naming the switch and the rows
  (:class:`FabricDivergence`). The wipe-and-resync escalation now ends
  with a verify sweep (``request_verify``) instead of blind trust.
- **Attribution**: the same sweep's per-row byte deltas roll up by
  tenant (admission MAC groups; unregistered sources pool under "-")
  into ``fabric_tenant_bytes_total{tenant}`` and by collective (the
  phase-row index of :class:`~sdnmpi_tpu_torch.core.collective_table.
  CollectiveInstall`) into the congestion report's measured-vs-modeled
  column — the first time the scheduler's modeled completion can
  be checked against observed bytes.

FatPaths-style multipath steering (arxiv 1906.10885) and the SLO plane
both ultimately steer on per-flow traffic truth; this plane is where
that truth enters the controller.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

from sdnmpi_tpu_torch.control.ownership import is_owner_cookie
from sdnmpi_tpu_torch.protocol import openflow as of
from sdnmpi_tpu_torch.utils.metrics import LATENCY_BUCKETS_S, REGISTRY
from sdnmpi_tpu_torch.utils.tracing import start_span

_m_sweeps = REGISTRY.counter(
    "audit_sweeps_total", "fabric audit sweep passes (per EventStatsFlush)"
)
_m_sweep_s = REGISTRY.histogram(
    "audit_sweep_seconds", LATENCY_BUCKETS_S,
    "wall of one audit sweep pass (flow-stats pull + canonicalize + "
    "diff + heal over the pass's switch shard)",
)
_m_rows = REGISTRY.counter(
    "audit_rows_checked_total",
    "installed flow rows canonicalized and diffed against the desired "
    "store",
)
_m_skipped = REGISTRY.counter(
    "audit_switches_skipped_total",
    "audit passes skipped for one switch (recovery in flight, or no "
    "stats reply this pull)",
)
_m_divergence = REGISTRY.labeled_counter(
    "fabric_divergence_total", "kind",
    "confirmed installed-vs-desired divergences, by kind "
    "(missing / orphan / counter_dead)",
)
_m_diverged = REGISTRY.gauge(
    "fabric_diverged_switches",
    "switches with a confirmed divergence in the latest audit pass "
    "that covered them",
)
_m_healed = REGISTRY.counter(
    "audit_heals_total",
    "targeted repair rows driven by the audit plane (re-installed "
    "missing/dead rows + deleted orphans)",
)
_m_tenant_bytes = REGISTRY.labeled_counter(
    "fabric_tenant_bytes_total", "tenant",
    "measured data-plane bytes attributed per tenant from flow-stats "
    "deltas (admission MAC groups; unregistered sources pool under -)",
)


#: sweep intervals the congestion report's measured block averages
#: over — long enough to smooth pull jitter, short enough that the
#: measured-vs-modeled comparison tracks the current workload
REPORT_WINDOW_SWEEPS = 8


def _parse_row_actions(actions) -> Optional[tuple[int, Optional[str]]]:
    """(out_port, rewrite MAC | None) of a Router-shaped action tuple,
    None when the layout is not one the Router installs (including the
    empty/drop layout a blackhole mutation leaves behind)."""
    if len(actions) == 1 and isinstance(actions[0], of.ActionOutput):
        return actions[0].port, None
    if (
        len(actions) == 2
        and isinstance(actions[0], of.ActionSetDlDst)
        and isinstance(actions[1], of.ActionOutput)
    ):
        return actions[1].port, actions[0].mac
    return None


class FabricDivergence:
    """Flight-recorder trigger: any advance of the
    ``fabric_divergence_total`` family freezes a bundle whose detail
    names the diverged switches and rows (every confirmed divergence is
    an incident — the fabric disagreed with the controller)."""

    name = "fabric:divergence"

    def __init__(self, plane: "AuditPlane") -> None:
        self.plane = plane

    @staticmethod
    def _total(snapshot: dict) -> int:
        pfx = "fabric_divergence_total{"
        return sum(
            v for k, v in snapshot.get("counters", {}).items()
            if k.startswith(pfx)
        )

    def check(self, prev: dict, cur: dict, window=None) -> Optional[dict]:
        d = self._total(cur) - self._total(prev)
        if d <= 0:
            return None
        return {
            "divergences": int(d),
            "recent": self.plane.take_unreported(),
        }


class AuditPlane:
    """Continuous fabric audit (module docstring). Single-threaded by
    bus discipline like every control-plane store; ``sweep`` is the one
    entry point, driven per ``EventStatsFlush`` by the Controller."""

    def __init__(self, config, southbound, router,
                 clock=time.monotonic) -> None:
        self.config = config
        self.southbound = southbound
        self.router = router
        self.recovery = router.recovery
        self.clock = clock
        #: round-robin pacing cursor over the sorted live switch list
        self._cursor = 0
        #: completed full passes over the switch space — the audit's
        #: sweep-period clock (counter-dead pair epochs key on it)
        self.cycle = 0
        #: switches owed a priority verify sweep (wipe-and-resync ends
        #: with verification instead of blind trust)
        self._verify: set[int] = set()
        #: dpid -> {(src, dst): (packet_count, byte_count)} as of the
        #: last sweep that covered the switch — the delta baseline for
        #: attribution and counter-dead detection
        self._counters: dict[int, dict] = {}
        #: (src, dst) -> cycle at which the pair's counters last
        #: advanced on ANY switch (the path-consistency signal)
        self._pair_epoch: dict[tuple[str, str], int] = {}
        #: (src, dst) -> cycle at which a TABLE-VISIBLE gap (a missing
        #: or mismatched row) was last seen for the pair on any switch.
        #: Counter-dead is suppressed for such pairs: a blackholed hop
        #: starves every hop downstream of it, and flagging the starved
        #: rows too would double-count one corruption — counter-dead
        #: exists for faults the table dump CANNOT show (dead counter
        #: ASIC, diverted traffic), so it only fires when the table
        #: looks right
        self._pair_gap: dict[tuple[str, str], int] = {}
        #: dpid -> {(kind, (src, dst)): consecutive sightings} awaiting
        #: confirmation; cleared when a sweep stops seeing them
        self._suspects: dict[int, dict] = {}
        #: dpids whose latest covering pass confirmed divergence
        self._diverged: set[int] = set()
        #: confirmed-divergence records, newest last (bundle forensics)
        self.recent: collections.deque = collections.deque(maxlen=64)
        #: records not yet shipped in a trigger detail
        self._unreported: list[dict] = []
        self._seq = 0
        #: cookie -> measured bytes of its phase rows (the congestion
        #: report's measured-vs-modeled column)
        self.collective_bytes: dict[int, int] = {}
        self._indexed_cookies: frozenset = frozenset()
        self._cookie_idx: dict = {}
        #: measured traffic matrix fed per attributed source-edge byte
        #: delta (oracle/trafficplane.py; wired by the Controller)
        self.traffic = None
        #: (clock, tenant-bytes, collective-bytes) register snapshots
        #: taken at each sweep close — the windowed measured block that
        #: report() diffs (lifetime counters vs an instantaneous model
        #: would be dimensionally dishonest)
        self._window: collections.deque = collections.deque(
            maxlen=REPORT_WINDOW_SWEEPS + 1
        )

    # -- wiring seams ------------------------------------------------------

    def trigger(self) -> FabricDivergence:
        return FabricDivergence(self)

    def take_unreported(self) -> list[dict]:
        out, self._unreported = self._unreported, []
        return out

    def request_verify(self, dpid: int) -> None:
        """Queue a priority audit of one switch ahead of the round-robin
        cursor — the verify leg a wipe-and-resync escalation ends with.
        Southbounds that cache table dumps (the one-interval-lag TCP
        pull) drop theirs: the verify must diff a post-wipe dump, not
        the table as it stood before the escalation."""
        self._verify.add(dpid)
        invalidate = getattr(
            self.southbound, "invalidate_flow_stats", None
        )
        if invalidate is not None:
            invalidate(dpid)

    def forensics(self) -> dict:
        """Flight-bundle context: where the sweep is and what it has
        confirmed — the 'is the fabric lying to me' half of an incident."""
        return {
            "cycle": self.cycle,
            "cursor": self._cursor,
            "diverged_switches": sorted(self._diverged),
            "suspects": {
                dpid: sorted(
                    f"{kind}:{src}>{dst}"
                    for (kind, (src, dst)) in table
                )
                for dpid, table in self._suspects.items() if table
            },
            "recent": list(self.recent)[-8:],
            "collective_bytes": dict(self.collective_bytes),
        }

    def report(self) -> dict:
        """The congestion report's measured block, WINDOWED: byte
        deltas and rates over the last :data:`REPORT_WINDOW_SWEEPS`
        sweep intervals per tenant and per collective install, beside
        each install's MODELED congestion figure. The old block put
        lifetime-cumulative counters next to an instantaneous modeled
        figure — a long-lived tenant dwarfed any model simply by being
        old — so the measured column is now a delta/rate over the
        audit's own sweep clock (lifetime totals stay available under
        ``*_total`` keys)."""
        live = {i.cookie: i for i in self.router.collectives}
        for cookie in list(self.collective_bytes):
            if cookie not in live:
                del self.collective_bytes[cookie]
        if len(self._window) >= 2:
            t0, tenants0, colls0 = self._window[0]
            t1, tenants1, colls1 = self._window[-1]
            window_s = max(t1 - t0, 0.0)
        else:
            # fewer than two sweep edges: the window IS the lifetime
            tenants0, colls0 = {}, {}
            tenants1 = dict(_m_tenant_bytes.values)
            colls1 = dict(self.collective_bytes)
            window_s = 0.0
        rate = (1.0 / window_s) if window_s > 0.0 else 0.0
        tenant_win = {
            t: int(tenants1.get(t, 0) - tenants0.get(t, 0))
            for t in sorted(set(tenants0) | set(tenants1))
        }
        return {
            "window_s": window_s,
            "window_sweeps": max(len(self._window) - 1, 0),
            "tenant_bytes": tenant_win,
            "tenant_bps": {t: v * rate for t, v in tenant_win.items()},
            "tenant_bytes_total": {
                t: int(v) for t, v in sorted(_m_tenant_bytes.values.items())
            },
            "collectives": [
                {
                    "cookie": cookie,
                    "measured_bytes": int(
                        colls1.get(cookie, 0) - colls0.get(cookie, 0)
                    ),
                    "measured_bps": (
                        colls1.get(cookie, 0) - colls0.get(cookie, 0)
                    ) * rate,
                    "measured_bytes_total": int(
                        self.collective_bytes.get(cookie, 0)
                    ),
                    "modeled_congestion": float(inst.max_congestion),
                    "n_phases": inst.n_phases,
                }
                for cookie, inst in sorted(live.items())
            ],
        }

    # -- the sweep ---------------------------------------------------------

    def sweep(self, now: Optional[float] = None) -> list[dict]:
        """One audit pass: queued verify requests first, then this
        flush's round-robin shard — BOTH under the per-flush pacing cap
        (a mass resync's verify queue must not turn one flush into the
        full-fabric burst the pacing exists to prevent; the overflow
        stays queued). Returns the pass's confirmed-divergence records
        (empty almost always)."""
        live = set(self.router.dps)
        # departed switches carry no audit state: their baselines are
        # moot (a redial resets counters anyway), their suspects can
        # never re-confirm, and a crashed switch must not pin the
        # diverged gauge nonzero forever
        self._diverged &= live
        self._verify &= live
        for table in (self._counters, self._suspects):
            for d in [d for d in table if d not in live]:
                del table[d]
        dpids = sorted(live)
        if not dpids:
            return []
        per = int(self.config.audit_switches_per_flush)
        take = len(dpids) if per <= 0 else min(per, len(dpids))
        verify = sorted(self._verify)[:take]
        self._verify.difference_update(verify)
        room = take - len(verify)
        start = self._cursor % len(dpids)
        shard = [dpids[(start + i) % len(dpids)] for i in range(room)]
        if room and start + room >= len(dpids):
            self.cycle += 1  # a full pass over the switch space closed
            # pair epochs/gaps older than the detector's horizon are
            # dead weight (it only ever reads >= cycle - 1): prune so
            # endpoint churn cannot grow the pair dicts forever
            stale = self.cycle - 2
            for table in (self._pair_epoch, self._pair_gap):
                for k in [k for k, v in table.items() if v < stale]:
                    del table[k]
        self._cursor = (start + room) % len(dpids)
        verify_set = set(verify)
        chosen = verify + [d for d in shard if d not in verify_set]

        t0 = time.perf_counter()
        sp = start_span("audit_sweep", n_switches=len(chosen))
        confirmed: list[dict] = []
        try:
            for dpid in chosen:
                result = self._audit_switch(dpid)
                if result is None:
                    # skipped (recovery mid-air / no stats reply): a
                    # VERIFY request is owed an actual audit — re-queue
                    # it instead of silently trusting the wipe after all
                    if dpid in verify_set:
                        self._verify.add(dpid)
                    continue
                confirmed.extend(result)
        finally:
            sp.end(n_confirmed=len(confirmed))
            _m_sweeps.inc()
            _m_sweep_s.observe(time.perf_counter() - t0)
            _m_diverged.set(len(self._diverged))
        # close the sweep on the report window: the measured block
        # diffs these register snapshots instead of lifetime totals
        self._window.append((
            self.clock(),
            dict(_m_tenant_bytes.values),
            dict(self.collective_bytes),
        ))
        return confirmed

    def _audit_switch(self, dpid: int) -> Optional[list[dict]]:
        """Audit ONE switch: pull, canonicalize, diff, attribute,
        confirm, heal. Returns confirmed-divergence records — or None
        when the switch could not be audited this pass (the caller
        re-queues verify requests on None)."""
        # recovery owns this gap; auditing it is noise — a reconcile
        # parked in the rate-shaping FIFO (e.g. a replica adoption
        # re-drive mid-air) counts as in flight
        if self.recovery.in_flight(dpid) or dpid in self.router._reconcile_pending:
            _m_skipped.inc()
            return None
        entries = self.southbound.flow_stats(dpid)
        if entries is None:
            _m_skipped.inc()
            return None  # no reply this pull — NOT an empty table
        prio = self.config.priority_default
        installed: dict[tuple[str, str], tuple] = {}
        for e in entries:
            m = e.match
            if (
                e.priority != prio
                or (e.cookie and not is_owner_cookie(e.cookie))
                or m.dl_src is None or m.dl_dst is None
            ):
                # bootstrap/control rules and block-plane rows;
                # ownership-epoch cookies on unicast rows
                # stay in scope — cookie is 0 with the pair off
                continue
            installed[(m.dl_src, m.dl_dst)] = (
                _parse_row_actions(e.actions), e.packet_count, e.byte_count
            )
        _m_rows.inc(len(installed))
        desired = {
            (s, d): spec
            for s, d, spec in self.recovery.desired.entries_for(dpid)
        }

        advanced, flat = self._attribute(dpid, installed)

        missing = [
            row for row, spec in desired.items()
            if row not in installed
            or installed[row][0] != (spec.out_port, spec.rewrite)
        ]
        orphans = [row for row in installed if row not in desired]
        for row in missing:
            self._pair_gap[row] = self.cycle
        # counter-dead: the row exists and matches its spec, but its
        # counters stayed flat across a sweep interval in which the
        # SAME pair's counters advanced on other switches — traffic is
        # flowing and this hop is not seeing (or not counting) it.
        # Pairs with a recent table-visible gap are suppressed (see
        # _pair_gap): the gap already explains the dead counters.
        horizon = self.cycle - 1
        dead = [
            row for row in flat
            if row in desired and row not in missing
            and self._pair_epoch.get(row, -1) >= horizon
            and self._pair_gap.get(row, -(1 << 30)) < horizon
        ]
        return self._confirm(dpid, missing, orphans, dead, desired)

    def _attribute(self, dpid: int, installed: dict):
        """Per-row counter deltas vs the last covering sweep: roll
        bytes up by tenant and by collective, remember the fresh
        baseline, and report which rows advanced vs stayed flat (the
        counter-dead inputs). Counter RESETS (an OF 1.0 ADD replacing
        the entry) re-baseline without attributing stale history."""
        prev = self._counters.get(dpid, {})
        tenants = self.router.admission
        registered = tenants._tenants
        cookie_idx = self._cookie_index()
        advanced: list = []
        flat: list = []
        fresh: dict = {}
        for row, (_act, pkts, bts) in installed.items():
            fresh[row] = (pkts, bts)
            last = prev.get(row)
            if last is None:
                continue  # first sight: baseline only
            if pkts < last[0] or bts < last[1]:
                continue  # counters reset (entry replaced): re-baseline
            d_bytes = bts - last[1]
            if pkts > last[0] or d_bytes > 0:
                advanced.append(row)
                self._pair_epoch[row] = self.cycle
            else:
                flat.append(row)
            if d_bytes > 0:
                src = row[0]
                tenant = registered.get(src)
                _m_tenant_bytes.inc(
                    tenant if tenant is not None else "-", d_bytes
                )
                if self.traffic is not None:
                    # the plane itself enforces source-edge attribution
                    # (each flow's bytes enter the matrix once, not
                    # once per audited hop)
                    self.traffic.ingest(
                        dpid, src, row[1],
                        tenant if tenant is not None else "-", d_bytes,
                    )
                cookie = cookie_idx.get((dpid, row[0], row[1]))
                if cookie is not None:
                    self.collective_bytes[cookie] = (
                        self.collective_bytes.get(cookie, 0) + d_bytes
                    )
        self._counters[dpid] = fresh
        return advanced, flat

    def _cookie_index(self) -> dict:
        """(dpid, src, dst) -> cookie over the phase rows of every live
        scheduled install — rebuilt only when the cookie set changes
        (the rows are immutable per install)."""
        installs = [
            i for i in self.router.collectives if i.phase_rows is not None
        ]
        cookies = frozenset(i.cookie for i in installs)
        if cookies != self._indexed_cookies:
            from sdnmpi_tpu_torch.utils.mac import int_to_mac_memo as _mac

            idx: dict = {}
            for inst in installs:
                for _phase, arr in inst.phase_rows:
                    for d, s, t in arr.tolist():
                        idx[(d, _mac(s), _mac(t))] = inst.cookie
            self._indexed_cookies = cookies
            self._cookie_idx = idx
        return self._cookie_idx

    def _confirm(self, dpid: int, missing, orphans, dead,
                 desired) -> list[dict]:
        """Promote repeat sightings to confirmed divergence and heal it
        (see module docstring). A suspicion not re-seen this pass is
        dropped — transients clear themselves."""
        need = max(1, int(self.config.audit_confirm_sweeps))
        prev = self._suspects.get(dpid, {})
        suspects: dict = {}
        confirmed: dict[str, list] = {}
        for kind, rows in (
            ("missing", missing), ("orphan", orphans),
            ("counter_dead", dead),
        ):
            # counter-dead FLOORS at two sightings regardless of the
            # config: one flat-while-pair-advanced interval is exactly
            # what ordinary traffic cessation looks like (the pair's
            # last packets landed before this hop's baseline) — only
            # table-visible kinds may confirm on first sight
            k_need = max(need, 2) if kind == "counter_dead" else need
            for row in rows:
                key = (kind, row)
                count = prev.get(key, 0) + 1
                if count >= k_need:
                    confirmed.setdefault(kind, []).append(row)
                else:
                    suspects[key] = count
        if suspects:
            self._suspects[dpid] = suspects
        else:
            self._suspects.pop(dpid, None)
        if not confirmed:
            self._diverged.discard(dpid)
            return []

        self._diverged.add(dpid)
        records: list[dict] = []
        for kind, rows in confirmed.items():
            _m_divergence.inc(kind, len(rows))
            self._seq += 1
            rec = {
                "seq": self._seq,
                "dpid": dpid,
                "kind": kind,
                "rows": sorted(f"{s}>{d}" for s, d in rows),
            }
            self.recent.append(rec)
            self._unreported.append(rec)
            records.append(rec)
        # heal: targeted re-drives through the reconcile path —
        # one row each, never a wipe. The re-driven entry's counters
        # reset, so its baseline is dropped (next sweep re-baselines).
        redrive = sorted(
            set(confirmed.get("missing", ()))
            | set(confirmed.get("counter_dead", ()))
        )
        if redrive:
            self.router.audit_redrive(
                dpid, [(s, d, desired[(s, d)]) for s, d in redrive]
            )
            _m_healed.inc(len(redrive))
            baselines = self._counters.get(dpid, {})
            for row in redrive:
                baselines.pop(row, None)
        delete = sorted(confirmed.get("orphan", ()))
        if delete:
            self.router.audit_delete(dpid, delete)
            _m_healed.inc(len(delete))
            baselines = self._counters.get(dpid, {})
            for row in delete:
                baselines.pop(row, None)
        return records

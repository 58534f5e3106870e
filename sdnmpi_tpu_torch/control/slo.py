"""Serving SLO plane: per-tenant objectives, multi-window
burn rates, and the flight-recorder trigger that freezes a diagnostic
bundle when a tenant's error budget burns.

The serving plane gave every tenant a latency distribution; an
operator needs the next layer up: *objectives* over those
distributions, evaluated the way the SRE literature evaluates them
(Beyer et al., *The Site Reliability Workbook*, ch. 5 — multi-window,
multi-burn-rate alerts):

- a :class:`SLOTarget` per tenant — ``p99_ms`` ("99% of routed requests
  complete under this many milliseconds") and ``availability`` ("this
  fraction of offered requests is served, not rejected/dropped");
- per-tenant latency histograms
  (``slo_route_latency_seconds{tenant=...}``) fed by the Router at
  window completion — park-to-install, the latency a tenant's MPI rank
  actually experiences — plus the admission plane's per-tenant
  rejection counters for the availability side;
- **burn rate** = (error fraction of the interval) / (error budget of
  the objective). Burning at 1.0 exactly spends the budget; a p99
  objective (budget 1%) with 10% of an interval's requests provably
  over target burns at 10x.
- the :class:`SLOBurn` trigger evaluates TWO windows per
  ``EventStatsFlush``, both scaled to the flush cadence instead of
  wall-clock minutes (the control plane's "hour" is however many
  flushes the Monitor performs in one): the **fast** window (the last
  flush interval) must burn AND the **slow** window (the last
  ``slow_flushes`` intervals) must burn. Fast-only would page on every
  blip; slow-only would page minutes after the incident started; the
  pair fires exactly while an incident is both fresh and sustained.

When the trigger fires, the frozen bundle names the burning tenant in
its ``detail`` and — through the ``slo`` context provider — the
**dominant pipeline stage** aggregated from the recorder's retained
span trees (self-time per span name), so the first page already says
"tenant=victim, stage=reap" instead of "something is slow".

Hot-path contract (the rule): with no targets configured the
Router's per-request cost is one attribute load + is-None test
(``router.slo`` stays None); with targets, tenants NOT under an
objective cost one dict miss.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from sdnmpi_tpu_torch.utils.metrics import LATENCY_BUCKETS_S, REGISTRY
from sdnmpi_tpu_torch.utils.timeline import estimate_p99

#: the per-tenant request-latency family the Router feeds (window
#: park-to-install wall; see Router._finish_batch)
LATENCY_HIST = "slo_route_latency_seconds"

_m_latency = REGISTRY.labeled_histogram(
    LATENCY_HIST, "tenant", LATENCY_BUCKETS_S,
    "per-tenant route-request latency (coalescer park -> install), "
    "fed for tenants under an SLO target",
)
_m_burn = REGISTRY.labeled_counter(
    "slo_burn_triggers_total", "tenant",
    "SLO burn-rate trigger firings per tenant",
)


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One tenant's serving objectives. ``p99_ms`` is the latency
    objective (99% under this bound — the error budget is the
    remaining 1%); ``availability`` is the served fraction of offered
    requests (budget = 1 - availability)."""

    tenant: str
    p99_ms: float
    availability: float = 0.999

    def __post_init__(self):
        if self.p99_ms <= 0:
            raise ValueError(f"slo target {self.tenant!r}: p99_ms must "
                             f"be > 0 (got {self.p99_ms})")
        if not 0.0 < self.availability < 1.0:
            raise ValueError(
                f"slo target {self.tenant!r}: availability must be in "
                f"(0, 1) (got {self.availability})"
            )


def parse_slo_target(spec: str) -> SLOTarget:
    """``tenant:p99_ms[:availability]`` -> :class:`SLOTarget` (the
    ``--slo-target`` CLI format; raises ValueError on malformed input
    so a typo fails the launch instead of silently not alerting)."""
    parts = spec.split(":")
    if len(parts) not in (2, 3) or not parts[0]:
        raise ValueError(
            f"--slo-target wants tenant:p99_ms[:availability], got "
            f"{spec!r}"
        )
    avail = float(parts[2]) if len(parts) == 3 else 0.999
    return SLOTarget(parts[0], float(parts[1]), avail)


def _hist_key(tenant: str) -> str:
    return f"{LATENCY_HIST}{{tenant={tenant}}}"


def _reject_key(tenant: str) -> str:
    return f"admission_rejections_total{{tenant={tenant}}}"


def _interval_burn(target: SLOTarget, base: dict, cur: dict,
                   min_count: int) -> Optional[dict]:
    """Burn rates of one interval (``base`` snapshot -> ``cur``), or
    None when the tenant served too few requests to judge (an idle
    tenant's lone outlier must not page anyone — the P99Regression
    rule). Latency badness uses the provably-above bucket semantics
    (HistogramThreshold): only observations in buckets whose LOWER
    edge is at/above the target count, so a histogram can never fire
    on values it cannot distinguish."""
    h1 = cur.get("histograms", {}).get(_hist_key(target.tenant))
    if h1 is None:
        return None
    h0 = (base or {}).get("histograms", {}).get(_hist_key(target.tenant))
    counts = list(h1["counts"])
    if h0 is not None and len(h0["counts"]) == len(counts):
        counts = [a - b for a, b in zip(counts, h0["counts"])]
    served = sum(counts)
    rej1 = cur.get("counters", {}).get(_reject_key(target.tenant), 0)
    rej0 = (base or {}).get("counters", {}).get(
        _reject_key(target.tenant), 0
    )
    rejected = max(0, rej1 - rej0)
    offered = served + rejected
    if offered < min_count:
        return None
    bounds = h1["buckets"]
    # NO clamp to the last finite edge (unlike HistogramThreshold,
    # where a dead trigger is the worse failure): clamping would count
    # +Inf-bucket observations BELOW an above-range target as provably
    # bad and page on a healthy tenant. Past the range the latency
    # side simply cannot prove a breach (SLOPlane warns at
    # construction); availability burn still fires.
    threshold = target.p99_ms / 1e3
    first = next(
        (i for i in range(1, len(counts))
         if float(bounds[i - 1]) >= threshold),
        len(counts),
    )
    slow = sum(counts[first:])
    latency_burn = (
        (slow / served) / 0.01 if served else 0.0
    )  # p99 objective: the error budget is the remaining 1%
    avail_budget = 1.0 - target.availability
    avail_burn = (rejected / offered) / avail_budget
    burn = max(latency_burn, avail_burn)
    return {
        "burn": burn,
        "slo": "latency" if latency_burn >= avail_burn else "availability",
        "latency_burn": round(latency_burn, 3),
        "availability_burn": round(avail_burn, 3),
        "served": int(served),
        "rejected": int(rejected),
        "slow_observations": int(slow),
        "p99_now_ms": round(estimate_p99(bounds, counts) * 1e3, 3),
    }


@dataclasses.dataclass
class SLOBurn:
    """Flight-recorder trigger: fire when ``target``'s error budget
    burns at >= ``burn_factor`` in BOTH the fast window (the last
    flush interval) and the slow window (the last ``slow_flushes``
    intervals of the recorder's rolling snapshot ring). Windows are
    flush-cadence-relative (see module docstring); a recorder younger
    than ``slow_flushes`` uses its whole history as the slow window,
    so a storm right after boot still fires."""

    target: SLOTarget
    burn_factor: float = 8.0
    slow_flushes: int = 12
    min_count: int = 16

    @property
    def name(self) -> str:
        return f"slo:{self.target.tenant}"

    def check(self, prev: dict, cur: dict, window=None) -> Optional[dict]:
        fast = _interval_burn(self.target, prev, cur, self.min_count)
        if fast is None or fast["burn"] < self.burn_factor:
            return None
        slow_base = prev
        if window:
            k = max(0, len(window) - self.slow_flushes)
            slow_base = window[k][1]
        slow = _interval_burn(self.target, slow_base, cur, self.min_count)
        if slow is None or slow["burn"] < self.burn_factor:
            return None
        _m_burn.inc(self.target.tenant)
        return {
            "tenant": self.target.tenant,
            "slo": fast["slo"],
            "p99_target_ms": self.target.p99_ms,
            "availability_target": self.target.availability,
            "burn_fast": round(fast["burn"], 3),
            "burn_slow": round(slow["burn"], 3),
            "burn_factor": self.burn_factor,
            "fast": fast,
            "slow": slow,
        }


def dominant_stage(trees) -> dict:
    """Aggregate SELF-time (wall minus child walls) per span name over
    completed span trees and name the dominant stage — the "where did
    the time go" half of an SLO page. Returns ``{"dominant_stage":
    name, "stage_self_ms": {name: total}}`` (empty when no trees)."""
    totals: dict[str, float] = {}
    for tree in trees:
        nodes = tree.get("nodes", {})
        for rec in nodes.values():
            wall = float(rec.get("wall_ms", 0.0))
            child_ms = sum(
                float(nodes[c].get("wall_ms", 0.0))
                for c in rec.get("children", ())
                if c in nodes
            )
            name = rec.get("name", "?")
            totals[name] = totals.get(name, 0.0) + max(
                0.0, wall - child_ms
            )
    if not totals:
        return {"dominant_stage": None, "stage_self_ms": {}}
    top = max(totals, key=lambda k: totals[k])
    return {
        "dominant_stage": top,
        "stage_self_ms": {
            k: round(v, 3)
            for k, v in sorted(totals.items(), key=lambda kv: -kv[1])
        },
    }


class SLOPlane:
    """Per-tenant SLO bookkeeping: owns the targets, the latency
    children the Router observes into, the trigger set, and the bundle
    forensics. Constructed by the Controller when
    ``Config.slo_targets`` is non-empty; ``router.slo`` points here."""

    def __init__(
        self,
        targets,
        admission,
        burn_factor: float = 8.0,
        slow_flushes: int = 12,
    ) -> None:
        self.targets: dict[str, SLOTarget] = {}
        if isinstance(targets, dict):
            # Config.slo_targets form: {tenant: (p99_ms, availability)}
            items = [
                spec if isinstance(spec, SLOTarget)
                else SLOTarget(name, *(
                    spec if isinstance(spec, (tuple, list)) else (spec,)
                ))
                for name, spec in targets.items()
            ]
        else:
            items = [
                parse_slo_target(t) if isinstance(t, str) else t
                for t in targets
            ]
        for t in items:
            self.targets[t.tenant] = t
        self.admission = admission
        self.burn_factor = float(burn_factor)
        self.slow_flushes = int(slow_flushes)
        #: tenant -> child histogram, pre-resolved so the per-request
        #: path is one dict get (targeted tenants only — cardinality is
        #: the operator's configured set, never request data)
        self._hists = {
            name: _m_latency.labels(name) for name in self.targets
        }
        #: tenants whose latency a load harness is currently feeding
        #: through :meth:`observe` — the Router's park-to-install feed
        #: SKIPS them so one served request is never counted twice
        #: (twice-counted good halves the burn fraction: an incident
        #: burning at 10x would read 5x and never page)
        self.harness_feed: set = set()
        for t in self.targets.values():
            if t.p99_ms / 1e3 > self._hists[t.tenant].bounds[-1]:
                # the histogram cannot DISTINGUISH values past its last
                # finite edge, so a target beyond it can never prove a
                # latency breach (availability burn still fires) — say
                # so once instead of silently never paging
                import logging

                logging.getLogger("slo").warning(
                    "slo target %s: p99 %.0f ms exceeds the latency "
                    "histogram's top bucket (%.0f ms); the latency burn "
                    "trigger cannot fire for it",
                    t.tenant, t.p99_ms,
                    self._hists[t.tenant].bounds[-1] * 1e3,
                )

    def observe_batch(self, batch, now: float) -> None:
        """Record every targeted tenant's park-to-install latency for
        one finished window (Router._finish_batch; ``now`` is
        time.monotonic, the clock ``t_parked`` was stamped on)."""
        tenant_of = self.admission.tenant_of
        hists = self._hists
        skip = self.harness_feed
        for p in batch:
            tenant = tenant_of(p.src)
            h = hists.get(tenant)
            if h is not None and p.t_parked and tenant not in skip:
                h.observe(now - p.t_parked)

    def observe(self, tenant: str, latency_s: float) -> None:
        """Record one request latency for a targeted tenant (no-op for
        untargeted names). The open-loop load harness feeds this with
        its schedule-anchored lateness (control/loadgen.py) — the
        latency a tenant EXPERIENCES includes the queueing before the
        controller ever parks the packet, which only the arrival
        schedule's owner can measure (the coordinated-omission point);
        the Router's park-to-install feed covers the in-controller
        half on production ingress."""
        h = self._hists.get(tenant)
        if h is not None:
            h.observe(latency_s)

    def triggers(self) -> list[SLOBurn]:
        return [
            SLOBurn(t, self.burn_factor, self.slow_flushes)
            for t in self.targets.values()
        ]

    def forensics(self, recorder=None) -> dict:
        """The ``slo`` context provider merged into every frozen
        bundle: the configured targets plus the dominant stage over
        the recorder's retained trees."""
        out: dict = {
            "targets": {
                n: {"p99_ms": t.p99_ms, "availability": t.availability}
                for n, t in self.targets.items()
            },
        }
        if recorder is not None:
            out.update(dominant_stage(recorder.trees()))
        return out

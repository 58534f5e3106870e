"""Shadow route-quality sentinel: do the routes we installed still fit
the traffic we actually carry?

The audit plane (control/audit.py) answers "does the fabric hold the rows I
installed?"; this module answers the next question up the stack. Routes
are chosen against the *modeled* load at install time, but the measured
matrix (oracle/trafficplane.py) keeps moving — a tenant's collective
finishes, a serving burst shifts pods, and yesterday's balanced
assignment quietly concentrates today's bytes onto one uplink. RAMP
(arxiv 2211.15226) frames reconfiguration around exactly this
measured-vs-provisioned gap; the sentinel is the detector that tells
the (future) co-optimization PR *when* the gap opened and *where*.

Per stats flush (after the audit sweep feeds the matrix and the
TrafficPlane publishes):

- A paced round-robin sample of installed non-collective (src, dst)
  pairs (``Config.sentinel_sample_per_flush``; 0 = the whole installed
  population) is weighted by the published measured matrix. A sweep
  with no measured weight is free — gauges publish their healthy
  values and no dispatch runs.
- The **installed** path of each pair is reconstructed by walking the
  desired-flow store hop by hop over the live link table (the rows the
  controller believes are installed — the audit plane separately
  verifies the fabric agrees).
- A **fresh optimum** for the same pairs is computed through the
  oracle's balanced batch dispatch (topology_db.find_routes_batch_
  balanced), with the batch padded to the kernels/tiling pow2 ladder
  so shadow re-scoring compiles O(log samples) shapes total, never one
  per sample count (trace-count asserted in tests).
- The measured weights are projected onto both assignments:
  ``C_meas`` is the hottest link load under the installed paths,
  ``C_model`` under the fresh optimum, and
  ``measured_vs_modeled_divergence = C_meas / C_model`` (1.0 = the
  installed routes are as good as a fresh solve; 2.0 = the hottest
  link carries twice the bytes it needs to). ``route_staleness_ratio``
  is the fraction of sampled pairs whose installed walk is broken or
  longer than the fresh path.
- Divergence >= ``Config.sentinel_divergence_factor`` counts
  ``sentinel_divergence_total{tenant}`` — which the
  :class:`SentinelDivergence` flight trigger turns into a frozen
  bundle naming the worst (tenant, collective, pod-pair). Healing
  (re-driving the worst pair through the install plane) exists behind
  ``Config.sentinel_heal`` but defaults OFF: this channel observes;
  it does not mutate routing unless the operator opts in.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

from sdnmpi_tpu_torch.kernels.tiling import col_bucket
from sdnmpi_tpu_torch.utils.metrics import REGISTRY

_m_staleness = REGISTRY.gauge(
    "route_staleness_ratio",
    "sampled installed routes broken or longer than a fresh optimum",
)
_m_divergence_gauge = REGISTRY.gauge(
    "measured_vs_modeled_divergence",
    "hottest measured link load: installed assignment / fresh optimum",
)
_m_sweeps = REGISTRY.counter(
    "sentinel_sweeps_total", "sentinel re-scoring sweeps"
)
_m_shadow = REGISTRY.counter(
    "sentinel_shadow_routes_total",
    "installed routes re-scored against a fresh oracle optimum",
)
_m_divergence = REGISTRY.labeled_counter(
    "sentinel_divergence_total", "tenant",
    "confirmed routes-don't-fit-the-traffic incidents per tenant",
)
_m_heals = REGISTRY.counter(
    "sentinel_heals_total",
    "worst diverging pairs re-driven through the install plane "
    "(Config.sentinel_heal opt-in)",
)
_m_heals_throttled = REGISTRY.counter(
    "sentinel_heals_throttled_total",
    "sentinel heals deferred because the tenant's admission token "
    "bucket was empty (the heal re-drive must not starve tenant "
    "serving traffic)",
)

#: hop bound for the installed-path walk — anything longer is a loop
_WALK_MAX = 64


class SentinelDivergence:
    """Flight-recorder trigger: any advance of the
    ``sentinel_divergence_total`` family freezes a bundle whose detail
    names the worst (tenant, collective, pod-pair) — the offered load
    no longer fits the installed routes."""

    name = "sentinel:divergence"

    def __init__(self, sentinel: "RouteSentinel") -> None:
        self.sentinel = sentinel

    @staticmethod
    def _total(snapshot: dict) -> int:
        pfx = "sentinel_divergence_total{"
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
            "recent": self.sentinel.take_unreported(),
        }


class RouteSentinel:
    """Measured-traffic re-scoring of installed routes (module
    docstring). Single-threaded by bus discipline; ``sweep`` is the one
    entry point, driven per ``EventStatsFlush`` by the Controller after
    the audit sweep and the TrafficPlane flush."""

    def __init__(self, config, router, db, traffic, audit=None,
                 clock=time.monotonic) -> None:
        self.config = config
        self.router = router
        self.db = db
        self.traffic = traffic
        self.audit = audit
        self.clock = clock
        self._cursor = 0
        self.sweep_count = 0
        #: recent confirmed divergences (forensics context window)
        self.recent: collections.deque = collections.deque(maxlen=32)
        self._unreported: list[dict] = []
        #: last sweep's summary (forensics)
        self._last: dict = {}

    def trigger(self) -> SentinelDivergence:
        return SentinelDivergence(self)

    def take_unreported(self) -> list[dict]:
        out, self._unreported = self._unreported, []
        return out

    def forensics(self) -> dict:
        return {
            "sweeps": self.sweep_count,
            "last": dict(self._last),
            "recent_divergences": list(self.recent),
            "matrix": self.traffic.matrix(),
        }

    # -- sampling ----------------------------------------------------------

    def _population(self) -> list[tuple[str, str]]:
        """Sorted unique installed non-collective host pairs (collective
        rows are phase-schedule-owned — re-routing them pairwise would
        score the wrong objective)."""
        hosts = self.db.hosts
        seen = set()
        for table in self.router.recovery.desired.flows.values():
            for (src, dst), spec in table.items():
                if spec.collective:
                    continue
                if src in hosts and dst in hosts:
                    seen.add((src, dst))
        return sorted(seen)

    def _sample(self) -> list[tuple[str, str]]:
        rows = self._population()
        k = self.config.sentinel_sample_per_flush
        if not rows or k <= 0 or k >= len(rows):
            return rows
        start = self._cursor % len(rows)
        take = [rows[(start + i) % len(rows)] for i in range(k)]
        self._cursor = (start + k) % len(rows)
        return take

    # -- path reconstruction ----------------------------------------------

    def _hop_map(self) -> dict[tuple[int, int], int]:
        """(dpid, out_port) -> next dpid over the live link table; ports
        absent here deliver to hosts and end the walk."""
        out: dict[tuple[int, int], int] = {}
        for src, dst_map in self.db.links.items():
            for dst, link in dst_map.items():
                out[(src, link.src.port_no)] = dst
        return out

    def _installed_links(
        self, src: str, dst: str, hop_map: dict
    ) -> Optional[list[tuple[int, int]]]:
        """Fabric links ((dpid, out_port) per hop, host delivery
        excluded) of the pair's installed path per the desired store;
        None when the walk is broken (missing row, loop, wrong edge)."""
        flows = self.router.recovery.desired.flows
        src_host = self.db.hosts.get(src)
        dst_host = self.db.hosts.get(dst)
        if src_host is None or dst_host is None:
            return None
        cur = src_host.port.dpid
        links: list[tuple[int, int]] = []
        for _ in range(_WALK_MAX):
            spec = flows.get(cur, {}).get((src, dst))
            if spec is None:
                return None
            nxt = hop_map.get((cur, spec.out_port))
            if nxt is None:
                # host delivery port: the walk is complete iff we are
                # standing at the destination's edge switch
                return links if cur == dst_host.port.dpid else None
            links.append((cur, spec.out_port))
            cur = nxt
        return None

    def _shadow_links(
        self, pairs: list[tuple[str, str]], hop_map: dict
    ) -> list[list[tuple[int, int]]]:
        """Fresh balanced assignment for the sampled pairs, padded to
        the pow2 bucket ladder so the device dispatch compiles O(log
        samples) shapes (the final host hop of each fdb is dropped —
        only fabric links carry projected load)."""
        n = len(pairs)
        bucket = col_bucket(n, 4096)
        padded = list(pairs) + [pairs[-1]] * (bucket - n)
        fdbs, _ = self.db.find_routes_batch_balanced(padded)
        out = []
        for fdb in fdbs[:n]:
            out.append([hop for hop in fdb if hop in hop_map])
        return out

    # -- sweep -------------------------------------------------------------

    def sweep(self, now: Optional[float] = None) -> dict:
        _m_sweeps.inc()
        self.sweep_count += 1
        pairs = self._sample()
        weights = [self.traffic.pair_bps(s, d) for s, d in pairs]
        if not pairs or not any(w > 0.0 for w in weights):
            # nothing measured to score against: healthy gauges, no
            # dispatch — steady tests without data-plane traffic pay a
            # dict scan, not a device solve
            _m_staleness.set(0.0)
            _m_divergence_gauge.set(1.0)
            self._last = {"sampled": len(pairs), "weighted": 0}
            return self._last
        hop_map = self._hop_map()
        installed = [self._installed_links(s, d, hop_map) for s, d in pairs]
        fresh = self._shadow_links(pairs, hop_map)
        _m_shadow.inc(len(pairs))

        stale = 0
        meas_load: dict[tuple[int, int], float] = {}
        model_load: dict[tuple[int, int], float] = {}
        for i, (inst, opt) in enumerate(zip(installed, fresh)):
            if inst is None or len(inst) > len(opt):
                stale += 1
            if inst is None:
                # a broken pair cannot be projected fairly; staleness
                # carries the signal, load comparison skips it
                continue
            w = weights[i]
            if w <= 0.0:
                continue
            for link in inst:
                meas_load[link] = meas_load.get(link, 0.0) + w
            for link in opt:
                model_load[link] = model_load.get(link, 0.0) + w
        c_meas = max(meas_load.values(), default=0.0)
        c_model = max(model_load.values(), default=0.0)
        divergence = (c_meas / c_model) if c_model > 0.0 else 1.0
        staleness = stale / len(pairs)
        _m_staleness.set(staleness)
        _m_divergence_gauge.set(divergence)
        self._last = {
            "sampled": len(pairs),
            "weighted": sum(1 for w in weights if w > 0.0),
            "stale": stale,
            "c_measured": c_meas,
            "c_modeled": c_model,
            "divergence": divergence,
        }
        if divergence >= self.config.sentinel_divergence_factor:
            self._confirm(pairs, weights, installed, meas_load, divergence,
                          staleness, c_meas, c_model)
        return self._last

    # -- confirmation ------------------------------------------------------

    def _confirm(self, pairs, weights, installed, meas_load, divergence,
                 staleness, c_meas, c_model) -> None:
        hot_link = max(meas_load, key=meas_load.get)
        worst_i, worst_w = None, -1.0
        for i, inst in enumerate(installed):
            if inst and hot_link in inst and weights[i] > worst_w:
                worst_i, worst_w = i, weights[i]
        if worst_i is None:
            return
        src, dst = pairs[worst_i]
        tenant = self.router.admission._tenants.get(src, "-")
        detail = {
            "divergence": divergence,
            "factor": self.config.sentinel_divergence_factor,
            "staleness": staleness,
            "c_measured": c_meas,
            "c_modeled": c_model,
            "hot_link": list(hot_link),
            "tenant": tenant,
            "pair": [src, dst],
            "pod_pair": [
                self.traffic.ep_name(src), self.traffic.ep_name(dst),
            ],
            "pair_bps": worst_w,
            "collective": self._worst_collective(),
        }
        _m_divergence.inc(tenant)
        self.recent.append(detail)
        self._unreported.append(detail)
        if self.config.sentinel_heal:
            # the heal re-drive spends the tenant's admission tokens
            # like any reactive route: a healing
            # storm competes with — never starves — serving traffic.
            # With no rate armed admit() is always True (unchanged).
            if self.router.admission.admit(src):
                self.router.reinstall_pairs([(src, dst)])
                _m_heals.inc()
            else:
                _m_heals_throttled.inc()

    def _worst_collective(self) -> Optional[int]:
        """Cookie of the collective moving the most measured bytes over
        the audit window, best-effort (None without an audit plane or
        when no collective carried traffic)."""
        if self.audit is None:
            return None
        try:
            report = self.audit.report()
        except Exception:
            return None
        best, best_bps = None, 0.0
        for entry in report.get("collectives", ()):
            bps = entry.get("measured_bps", 0.0)
            if bps > best_bps:
                best, best_bps = entry.get("cookie"), bps
        return best

"""Drive a flat collective balanced by the DAG program, as
:mod:`portbench.drivers.collective` drives one (the same calls and
spans), and judge its balancer too: after each call the oracle's
``last_fractional_congestion``, the maximum fractional link load of the
balancer's last round, is kept with the routes, and :meth:`Driver.judge`
adds :mod:`portbench.reference_dag`'s ``fractional_gap`` to the route
checks of :mod:`portbench.reference`.

A configuration's ``entry_kwargs`` give the balancer's ``rounds``; the
link capacity is its ``link_capacity_bps``. For every collective judged,
a line on standard error gives both fractional figures.
"""

from __future__ import annotations

import sys

from portbench import reference_dag
from portbench.drivers import collective


class Driver(collective.Driver):
    LIMITS = reference_dag.LIMITS

    def __init__(self, cfg: dict, db, spans):
        super().__init__(cfg, db, spans)
        self.rounds = int(self.kwargs.get("rounds", 2))
        self.capacity = float(self.kwargs["link_capacity"])
        self._oracle = db._oracle_engine()
        #: the fabric's DAG levels, made at the first judgement
        self._levels = None
        #: each job's reference maximum, worked out once from its snapshot
        self._want = {}

    def __call__(self, job):
        """The routes and the balancer's reported fractional congestion."""
        routes = super().__call__(job)
        return routes, self._oracle.last_fractional_congestion

    def close(self) -> None:
        self._oracle = None
        super().close()

    def judge(self, fab, job, answer) -> tuple[dict, int]:
        routes, reported = answer
        counts, load = super().judge(fab, job, routes)
        i = job.index
        if i not in self._want:
            if self._levels is None:
                self._levels = reference_dag.Levels(fab)
            pairs = self._pairs[i]
            base = reference_dag.link_base(fab, job.util, len(pairs), self.capacity)
            traffic = reference_dag.pair_traffic(fab, pairs)
            frac = reference_dag.fractional_load(self._levels, traffic, base, self.rounds)
            self._want[i] = float(frac.max()) if len(frac) else 0.0
        want = self._want[i]
        counts["fractional_gap"] = reference_dag.fractional_gap(reported, want)
        print(f"dag job {i}: fractional congestion {float(reported)!r} reported, "
              f"{want!r} by the reference (relative gap "
              f"{abs(float(reported) - want) / max(abs(want), 1e-300):.3e})",
              file=sys.stderr)
        return counts, load

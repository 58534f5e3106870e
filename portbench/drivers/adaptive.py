"""Drive a collective routed by UGAL, the port's ``"adaptive"`` policy,
through ``find_routes_collective``, as :mod:`portbench.drivers.collective`
drives a flat one (the same spans), and judge it with
:mod:`portbench.reference_ugal`: minimal or Valiant routes, each sub-flow
on the side UGAL-G decides from the job's own snapshot.

A configuration's ``entry_kwargs`` give the decision's ``ugal_candidates``
and ``ugal_bias``; the link capacity is its ``link_capacity_bps``. For
every collective judged, a line on standard error gives the sub-flows
judged, the pairs on detours and the near-ties.
"""

from __future__ import annotations

import sys

from portbench import reference, reference_ugal
from portbench.drivers import collective


class Driver(collective.Driver):
    LIMITS = reference_ugal.LIMITS

    def __init__(self, cfg: dict, db, spans):
        super().__init__(cfg, db, spans)
        self.k = int(self.kwargs["ugal_candidates"])
        self.bias = float(self.kwargs["ugal_bias"])
        self.capacity = float(self.kwargs["link_capacity"])
        #: each job's hop-minimal costs, worked out once from its snapshot
        self._costs = {}

    def judge(self, fab, job, result) -> tuple[dict, int]:
        i = job.index
        if i not in self._pairs:
            self._pairs[i] = reference.Pairs.of(fab, job.hosts, job.src_idx, job.dst_idx)
            cost = reference_ugal.link_costs(fab, job.util, len(job.src_idx), self.capacity)
            self._costs[i] = reference_ugal.minimal_costs(fab, cost)
        counts, load, seen = reference_ugal.judge(
            fab, result, self._pairs[i], self._costs[i], self.k, self.bias)
        pairs = len(self._pairs[i])
        print(f"ugal job {i}: {seen['subflows']} sub-flows judged, "
              f"{seen['detour_pairs']} of {pairs} pairs on detours "
              f"({100.0 * seen['detour_pairs'] / max(pairs, 1):.4f}%), "
              f"{seen['near_ties']} near-ties", file=sys.stderr)
        return counts, load

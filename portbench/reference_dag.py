"""The plain reference of the flat program's balancer: PyTorch on the CPU,
in float64.

It imports nothing of the program under test, and of the benchmark only
:mod:`portbench.reference`'s fabric arrays and pairs. From a job's
utilization snapshot (the Monitor's ``(dpid, port) -> bps``) and the
collective's pair counts per (source switch, destination switch), which
do not depend on how the program deals its pairs onto sub-flows, it
works out again the fractional link load of the DAG balancer, whose
maximum the program reports as its ``last_fractional_congestion``:

- the normalized base on every directed switch link, ``(u / capacity)
  * max(1, pairs / links)``: the flat leg scales by the collective's
  pairs, as the adaptive leg does (:func:`portbench.reference_ugal.link_costs`);
- round 1: at every level l, from the collective's farthest hop distance
  (the batch's hop budget less 1) down to 1, the mass bound for a
  destination t that stands at a switch at distance l from t moves on
  over that switch's out-links to switches at distance l - 1, split in
  proportion to ``1 / (1 + cost / mean)``, the cost the base and the mean
  taken over the directed switch links. A link's load is the mass that
  crosses it, over every destination;
- each later round does the same with the base plus the previous round's
  load as the cost. The last round's load is the answer.

It works on the directed edge list, over all destinations at once: for
each level, the entries (destination, link) of the ``[T, E]`` grid whose
link leads from distance l to distance l - 1 of the destination, found
once a fabric (:class:`Levels`). It never forms the program's dense
``[T, V] @ [V, V]`` products.

**What it judges.** ``fractional_gap``: 1 for a collective whose
reported fractional congestion differs from the reference's maximum link
load by more than :data:`RTOL` of it; limit 0. The limit lies between two
readings at the Blue Gene/Q rack's size (1,024 routers, 11 levels, 2
rounds) on an H100: the program in float32 lands within 1.7e-7 of the
reference on every job of 12 seeds, while the same balance in a lower
precision lands 9.2e-5 to 3.5e-4 away with the program's products in
TF32, 1.3e-3 to 2.4e-3 with this reference in float16 and 4.2e-3 to
1.2e-2 in bfloat16. A missing round or level moves the maximum by far
more.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import LIMITS as ROUTE_LIMITS
from portbench.reference import Fabric, Pairs

#: the route checks of :mod:`portbench.reference`, then the balancer's
LIMITS = {**ROUTE_LIMITS, "fractional_gap": 0}
#: relative gap of the reported fractional congestion (see above)
RTOL = 1e-5


def link_base(fab: Fabric, util: dict, n_pairs: int, capacity: float) -> torch.Tensor:
    """``[E]`` float64 normalized base of every directed switch link, in
    :meth:`Fabric.links` order."""
    li, lj = fab.links()
    bps = [util.get((d, p), 0.0)
           for d, p in zip(fab.dpids[li].tolist(), fab.port[li, lj].tolist())]
    u = torch.tensor(bps, dtype=torch.float64)
    return (u / max(capacity, 1.0)) * max(1.0, n_pairs / max(len(li), 1))


def pair_traffic(fab: Fabric, pairs: Pairs) -> torch.Tensor:
    """``[T, V]`` float64 mass injected at switch i bound for switch t:
    the collective's pairs from i to t."""
    v = len(fab.dpids)
    counts = np.bincount(pairs.key.astype(np.int64), minlength=v * v).reshape(v, v)
    return torch.from_numpy(counts.T.astype(np.float64))


class Levels:
    """The shortest-path DAG toward every destination, level by level:
    for each level l, the destinations and links of the ``[T, E]``
    entries whose link goes from distance l to distance l - 1 of the
    destination."""

    def __init__(self, fab: Fabric):
        li, lj = fab.links()
        self.v = len(fab.dpids)
        self.tail = torch.from_numpy(li.astype(np.int64))
        self.head = torch.from_numpy(lj.astype(np.int64))
        dist_t = torch.from_numpy(fab.dist.T.astype(np.int16))  # [T, V]: dist to t
        self.dist_t = dist_t
        at_tail, at_head = dist_t[:, self.tail], dist_t[:, self.head]  # [T, E]
        self.entries = {}
        for level in range(1, int(fab.dist.max(initial=0)) + 1):
            t, e = torch.nonzero((at_tail == level) & (at_head == level - 1), as_tuple=True)
            self.entries[level] = (t, e)

    def levels_of(self, traffic: torch.Tensor) -> int:
        """The farthest distance any mass of ``traffic`` stands from its
        destination: the program's hop budget less 1."""
        live = traffic > 0
        return int(self.dist_t[live].max()) if bool(live.any()) else 0

    def propagate(self, weights: torch.Tensor, traffic: torch.Tensor,
                  levels: int) -> torch.Tensor:
        """``[E]`` load of pushing ``traffic`` down the DAG split by
        ``weights`` (``[E]``), ``levels`` levels from the farthest."""
        v = self.v
        mass = traffic.clone().reshape(-1)  # [T * V]
        load = torch.zeros_like(weights)
        for level in range(levels, 0, -1):
            t, e = self.entries[level]
            at = t * v + self.tail[e]
            w = weights[e]
            total = torch.zeros_like(mass).index_add_(0, at, w)
            flow = mass[at] * w / total[at]
            mass[(self.dist_t == level).reshape(-1)] = 0.0  # all of it moves on
            mass.index_add_(0, t * v + self.head[e], flow)
            load.index_add_(0, e, flow)
        return load


def split_weights(cost: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + cost / mean)`` on every directed switch link."""
    mean = cost.mean() if len(cost) else cost.new_zeros(())
    return 1.0 / (1.0 + cost / mean) if mean > 0 else torch.ones_like(cost)


def fractional_load(dag: Levels, traffic: torch.Tensor, base: torch.Tensor,
                    rounds: int, levels: int | None = None) -> torch.Tensor:
    """``[E]`` float64 link load of the balancer's last round; ``levels``
    defaults to the farthest distance the traffic stands at."""
    if levels is None:
        levels = dag.levels_of(traffic)
    load = dag.propagate(split_weights(base), traffic, levels)
    for _ in range(rounds - 1):
        load = dag.propagate(split_weights(base + load), traffic, levels)
    return load


def fractional_gap(reported: float, want: float) -> int:
    """1 where the reported fractional congestion is more than
    :data:`RTOL` of ``want`` away from it, else 0."""
    return int(abs(float(reported) - want) > RTOL * abs(want))

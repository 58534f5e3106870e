"""The phased flow program, the scheduler's result.

Counterpart of ``sdnmpi_tpu/sched/program.py``.
``RouteOracle.routes_collective_phased_dispatch`` packs the collective's
pairs into phases and enqueues every phase's device work before it
returns, so the Router reaps and installs phase k while later phases
compute. Each :class:`PhasePlan` reaps to an ordinary
:class:`~sdnmpi_tpu_torch.oracle.batch.CollectiveRoutes` restricted to
its pair subset, so the flat path's consumers (member scatter, block
materialization, congestion attribution) take it unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PhasePlan:
    """One phase of a phased flow program.

    ``pair_idx`` indexes the *collective's* pair arrays (the caller's
    ``src_idx``/``dst_idx`` rows routed in this phase); ``window``
    reaps the phase's :class:`CollectiveRoutes`, whose own pair axis is
    the subset (row j of the routes is pair ``pair_idx[j]``)."""

    phase: int  # phase id, ascending program order
    pair_idx: np.ndarray  # [Fk] int64 indices into the collective's pairs
    window: object  # oracle.batch.RouteWindow -> CollectiveRoutes
    routes: object = None  # cached reap result

    @property
    def n_pairs(self) -> int:
        return len(self.pair_idx)

    def reap(self):
        """Host decode of this phase's dispatched window (idempotent)."""
        if self.routes is None:
            self.routes = self.window.reap()
        return self.routes


@dataclasses.dataclass
class PhasedFlowProgram:
    """Ordered per-phase route windows + the pair -> phase assignment.

    ``n_phases`` is the packer's K; ``phases`` lists only the NON-EMPTY
    phases (ascending phase id — install order), so K minus
    ``len(phases)`` phases packed no pairs. ``pair_phase[k]`` is pair
    k's phase (-1 = unresolved endpoint: the pair is in no phase and
    unrouted, matching the flat path's unrouted contract)."""

    n_phases: int
    pair_phase: np.ndarray  # [F] int32, -1 = unresolved
    phases: list  # [PhasePlan], ascending phase id

    @property
    def n_pairs(self) -> int:
        return len(self.pair_phase)

    def reap_all(self) -> list:
        """Reap every phase in order; returns their CollectiveRoutes."""
        return [plan.reap() for plan in self.phases]

    # -- congestion model --------------------------------------------------

    def phase_congestion(self) -> list[float]:
        """Per-phase discrete max-link load (reaps as needed)."""
        return [float(plan.reap().max_congestion) for plan in self.phases]

    def total_discrete_congestion(self) -> float:
        """Sum over phases of the discrete max-link load — the modeled
        completion time of the scheduled program in flow-per-link
        rounds (phases serialize; within a phase the bottleneck link's
        load is the phase's duration). The flat single-shot program's
        modeled completion is simply its discrete max; the fractional
        bound of the flat batch lower-bounds BOTH, so
        ``total / flat_fractional`` is the achieved-vs-bound figure."""
        return float(sum(self.phase_congestion()))

    def max_phase_congestion(self) -> float:
        """Max concurrent link load while the program runs (the hottest
        single phase) — the figure comparable to a flat install's
        ``max_congestion``."""
        return float(max(self.phase_congestion(), default=0.0))

"""The collective phase scheduler.

Counterpart of ``sdnmpi_tpu/sched``. The DAG balancer routes a
collective as one flat batch, and its discrete sampling lands above its
own fractional max-link bound; running the collective as K smaller,
nearly link-disjoint phases lets each phase's flows round onto nearly
empty links, so the program's total congestion approaches the flat
batch's bound.

- :mod:`sdnmpi_tpu_torch.sched.phases`: greedy link-load-aware packing
  of the collective's (edge, edge) traffic groups into phases, on the
  oracle's device, seeded with the utilization plane's per-switch load,
  with a numpy twin equal to it bit for bit.
- :mod:`sdnmpi_tpu_torch.sched.program`: the phased flow program the
  oracle returns, per-phase route windows the Router installs phase by
  phase.
"""

from sdnmpi_tpu_torch.sched.phases import (  # noqa: F401
    MAX_AUTO_PHASES,
    choose_n_phases,
    pack_phases,
    pack_phases_host,
)
from sdnmpi_tpu_torch.sched.program import PhasedFlowProgram, PhasePlan  # noqa: F401

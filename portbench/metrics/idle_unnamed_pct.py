"""The share of the card's idle time in the traced window during which no
stage of the program was open (``unnamed`` in
:meth:`portbench.stages.StagedTrace.idle_by_stage`): the idle time the
stage metrics leave unexplained."""

from portbench import stages

watch = stages.watch


def read(run):
    trace = run.trace
    if not isinstance(trace, stages.StagedTrace) or not trace.stages or trace.busy_s() <= 0:
        return None
    idle = trace.idle_by_stage()
    total = sum(idle.values())
    return 100.0 * idle.get(stages.UNNAMED, 0.0) / total if total > 0 else None

"""Host ms a collective in the program's ``enqueue`` stage (a child of
its ``collective`` span): the hop budget and the policy's device leg,
uploads included (two ranges a collective). Read from the traced run's
profile (:mod:`portbench.stages`); a program without the stage has
nothing to read."""

from portbench import stages

watch = stages.watch


def read(run):
    return stages.stage_ms(run, "enqueue")

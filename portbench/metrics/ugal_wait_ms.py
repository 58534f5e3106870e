"""Host ms a collective in the program's ``ugal_wait`` stage (a child of
its ``collective`` span, on the adaptive policy's path): the UGAL
program's three copies home (its intermediates and both segments' slot
streams), the host waiting on the card. Read from the traced run's
profile (:mod:`portbench.stages`); a program without the stage has
nothing to read."""

from portbench import stages

watch = stages.watch


def read(run):
    return stages.stage_ms(run, "ugal_wait")

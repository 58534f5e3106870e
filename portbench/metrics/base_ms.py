"""Host ms a collective in the program's ``base`` stage (a child of its
``collective`` span): the utilization base (``_normalized_base``). Read
from the traced run's profile (:mod:`portbench.stages`); a program
without the stage has nothing to read."""

from portbench import stages

watch = stages.watch


def read(run):
    return stages.stage_ms(run, "base")

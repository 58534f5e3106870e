"""Host ms a collective in the program's ``deal`` stage (a child of its
``collective`` span): the deal of each group's members over its sub-
flows. Read from the traced run's profile (:mod:`portbench.stages`); a
program without the stage has nothing to read."""

from portbench import stages

watch = stages.watch


def read(run):
    return stages.stage_ms(run, "deal")

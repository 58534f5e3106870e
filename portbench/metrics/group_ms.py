"""Host ms a collective in the program's ``group`` stage (a child of its
``collective`` span): the pair grouping (``native.group_pairs`` or its
NumPy twin), the unique groups and the sub-flow arrays. Read from the
traced run's profile (:mod:`portbench.stages`); a program without the
stage has nothing to read."""

from portbench import stages

watch = stages.watch


def read(run):
    return stages.stage_ms(run, "group")

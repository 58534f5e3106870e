"""Host ms a collective in the program's ``ugal`` stage (a child of its
``collective`` span, on the adaptive policy's path): the UGAL program's
launches, from the link costs through K2's second segment launch,
uploads included. Read from the traced run's profile
(:mod:`portbench.stages`); a program without the stage has nothing to
read."""

from portbench import stages

watch = stages.watch


def read(run):
    return stages.stage_ms(run, "ugal")

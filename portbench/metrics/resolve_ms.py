"""Host ms a collective in the program's ``resolve`` stage (a child of
its ``collective`` span): the topology's refresh check and the
endpoints' resolution. Read from the traced run's profile
(:mod:`portbench.stages`); a program without the stage has nothing to
read."""

from portbench import stages

watch = stages.watch


def read(run):
    return stages.stage_ms(run, "resolve")

"""Host ms a collective in the program's ``wait`` stage (a child of its
``collective_reap`` span): the blocking copy of the device's paths to
the host. Read from the traced run's profile (:mod:`portbench.stages`);
a program without the stage has nothing to read."""

from portbench import stages

watch = stages.watch


def read(run):
    return stages.stage_ms(run, "wait")

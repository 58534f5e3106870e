"""Host ms a collective in the program's ``segments`` stage (a child of its
``collective`` span, on the adaptive policy's path): the host decode of
both segments' slot streams (``decode_segments``). Read from the traced
run's profile (:mod:`portbench.stages`); a program without the stage has
nothing to read."""

from portbench import stages

watch = stages.watch


def read(run):
    return stages.stage_ms(run, "segments")

"""Host ms a collective in the program's ``stitch`` stage (a child of its
``collective`` span, on the adaptive policy's path): the join of each
sub-flow's two segments into one path (``stitch_paths``). Read from the
traced run's profile (:mod:`portbench.stages`); a program without the
stage has nothing to read."""

from portbench import stages

watch = stages.watch


def read(run):
    return stages.stage_ms(run, "stitch")

"""Host ms a collective in the program's ``pack`` stage (a child of its
``phased`` span): the phased dispatch's own refresh, resolve, grouping,
base sums and packer S2, before its phases dispatch. Read from the
traced run's profile (:mod:`portbench.stages`); a program without the
stage has nothing to read."""

from portbench import stages

watch = stages.watch


def read(run):
    return stages.stage_ms(run, "pack")

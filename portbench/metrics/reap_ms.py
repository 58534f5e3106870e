"""Mean wall of the ``reap`` span (device wait, slot decode, fdbs, the
phases in order) over the traced window's collectives."""


def read(run):
    return run.spans.mean_ms("reap")

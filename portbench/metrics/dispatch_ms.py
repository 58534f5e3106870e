"""Mean wall of the ``dispatch`` span (entry, resolve, pair grouping, hop
budget, device enqueue) over the traced window's collectives."""


def read(run):
    return run.spans.mean_ms("dispatch")

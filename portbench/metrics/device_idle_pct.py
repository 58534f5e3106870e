"""The share of the traced window in which no operation ran on the
card."""


def read(run):
    busy = run.trace.busy_s()
    return 100.0 * (1.0 - busy / run.trace.window_s()) if busy > 0 else None

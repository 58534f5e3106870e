"""Wall per collective: the whole measured window over the collectives
whose routes reached the host in it (closed loop, one caller)."""


def read(run):
    return 1e3 * run.window_s / run.collectives

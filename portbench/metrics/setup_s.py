"""Set-up: process start to the window's start (imports, the card, the
kernels built or loaded, the fabric, the jobs, one collective of each job
shape)."""


def read(run):
    return run.setup_s

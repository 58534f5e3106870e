"""Route quality: the pairs whose routes cross the most loaded directed
switch link, counted by the reference from the returned hop lists (for a
phased program the sum of each phase's maximum), averaged over each
job's first collective in the window."""


def read(run):
    return sum(run.job_loads) / len(run.job_loads)

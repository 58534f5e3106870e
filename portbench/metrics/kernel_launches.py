"""Launches of the hand-written kernels (K1, K2's set-up, K2, K3, K3's step
form, S1, S2) a collective in the window: the difference of each
wrapper's ``.launches`` counter between the window's start and end. The
counters count launches on the card only, so a CPU run has nothing to
read."""

from portbench.stages import launch_counts


def watch(run):
    """Snapshot the counters; the undo, called when the window ends,
    records each wrapper's launches in it."""
    before = launch_counts()

    def undo():
        after = launch_counts()
        run.records["kernel_launches"] = {k: v - before.get(k, 0) for k, v in after.items()}

    return undo


def read(run):
    total = sum(run.records.get("kernel_launches", {}).values())
    return total / run.collectives if total > 0 else None

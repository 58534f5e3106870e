"""Share of the flat DAG leg's slot streams that holds a hop, over the
window: 100 x ``oracle_dag_decisions_total`` over
``oracle_dag_slots_total``, the program's counters, each the difference
between the window's start and end. The rest of K2's output, of the copy
home and of the slot decode is padding past the paths' ends. A program
without the counters has nothing to read."""

NAMES = ("oracle_dag_decisions_total", "oracle_dag_slots_total")


def _values():
    from sdnmpi_tpu_torch.utils.metrics import REGISTRY

    counters = [REGISTRY.get(name) for name in NAMES]
    if any(c is None for c in counters):
        return None
    return [c.value for c in counters]


def watch(run):
    """Snapshot the counters; the undo, called when the window ends,
    records what the window added to each. None where the program has
    no such counters."""
    before = _values()
    if before is None:
        return None

    def undo():
        after = _values()
        run.records["slot_fill_pct"] = [a - b for a, b in zip(after, before)]

    return undo


def read(run):
    decisions, slots = run.records.get("slot_fill_pct", (0, 0))
    return 100.0 * decisions / slots if slots > 0 else None

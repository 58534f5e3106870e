"""Drive a collective through the program's user entry, as a caller
that waits for its routes does.

A configuration names the entry, ``find_routes_collective`` (flat: one
device program, its routes reaped before the call returns) or
``find_routes_collective_phased`` (a phased program, every phase
dispatched by the call and reaped here in order), and its keyword
arguments. A collective's time runs from the call to its routes on the
host.

With spans on (a traced run), two spans are recorded around the calls
into the program's layers: ``dispatch`` (entry, endpoint resolution,
pair grouping, hop budget and the device enqueue) and ``reap`` (device
wait, slot decode, fdbs). For the phased entry they are the call and
``reap_all()``. The flat entry reaps inside the call, so its oracle's
``routes_collective_dispatch`` is wrapped on the instance: the span
covers that call, and the window it returns is handed back with its
``reap`` timed. Where the program has no such attribute, nothing is
wrapped and the metrics that read the spans stay silent.

After the window, :meth:`Driver.judge` hands a collective's routes to
the reference.
"""

from __future__ import annotations

from portbench import reference


class _TimedWindow:
    """A dispatched window whose ``reap`` runs inside a span."""

    def __init__(self, window, spans):
        self._window = window
        self._spans = spans

    def reap(self):
        with self._spans("reap"):
            return self._window.reap()


class Driver:
    #: each number :meth:`judge` counts, with its limit
    LIMITS = reference.LIMITS

    def __init__(self, cfg: dict, db, spans):
        #: (object, attribute, original) of every wrap, undone by close()
        self._wrapped = []
        self.entry = getattr(db, cfg["entry"])
        self.kwargs = dict(cfg.get("entry_kwargs", {}))
        self.kwargs.setdefault("link_capacity", float(cfg["link_capacity_bps"]))
        self.spans = spans
        self.phased = cfg["entry"] == "find_routes_collective_phased"
        #: each job's pairs as the reference judges them, made once
        self._pairs = {}
        if spans.on and not self.phased:
            self._wrap_dispatch(db)

    def _wrap_dispatch(self, db) -> None:
        oracle = db._oracle_engine()
        inner = getattr(oracle, "routes_collective_dispatch", None)
        if inner is None:
            return
        spans = self.spans

        def dispatch(*args, **kwargs):
            with spans("dispatch"):
                window = inner(*args, **kwargs)
            return _TimedWindow(window, spans)

        self._wrap(oracle, "routes_collective_dispatch", dispatch)

    def _wrap(self, owner, name: str, fn) -> None:
        self._wrapped.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, fn)

    def close(self) -> None:
        """Undo every wrap and let go of the program."""
        self.entry = None
        for owner, name, original in reversed(self._wrapped):
            if original is None:
                delattr(owner, name)
            else:
                setattr(owner, name, original)
        self._wrapped = []

    def __call__(self, job):
        """Route one collective of ``job``; returns the program's result
        with every route on the host."""
        if self.phased:
            with self.spans("dispatch"):
                program = self.entry(job.macs, job.src_idx, job.dst_idx,
                                     link_util=job.util, **self.kwargs)
            with self.spans("reap"):
                program.reap_all()
            return program
        return self.entry(job.macs, job.src_idx, job.dst_idx, link_util=job.util,
                          **self.kwargs)

    def judge(self, fab, job, result) -> tuple[dict, int]:
        """The reference's counts under :data:`LIMITS`' names for one
        collective's result, and its max link load."""
        if job.index not in self._pairs:
            self._pairs[job.index] = reference.Pairs.of(fab, job.hosts, job.src_idx,
                                                         job.dst_idx)
        if self.phased:
            pair_phase = result.pair_phase
            phases = [(plan.phase, plan.pair_idx, plan.reap()) for plan in result.phases]
        else:
            pair_phase, phases = None, [(0, None, result)]
        return reference.judge(fab, phases, pair_phase, self._pairs[job.index])

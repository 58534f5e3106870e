"""The program's stages in a traced run, and its kernels' launch counts.

While the profiler records, every span the program opens
(``sdnmpi_tpu_torch/utils/tracing.py``) is also a profiler range named
``sdnmpi.<span>``: the collective path's ``collective`` (``resolve``,
``group``, ``deal``, ``enqueue``, ``base``), ``collective_reap``
(``wait``, ``decode``, ``fdbs``, ``congestion``) and ``phased``
(``pack``). :func:`watch` has the traced run's profile read into a
:class:`StagedTrace`: :class:`~portbench.trace.Trace` with those ranges
kept as ``stages`` on the same clock as the device's operations, so an
idle gap on the device can be put down to the stage the program was in
(:meth:`StagedTrace.idle_by_stage`). A program without such spans leaves
``stages`` empty, and the metrics that read them find nothing.

:func:`launch_counts` reads the hand-written kernels' ``.launches``
counters (CUDA launches only; CPU calls do not count).
"""

from __future__ import annotations

import dataclasses
import importlib

from portbench.trace import Trace

#: the prefix of the program's ranges
PREFIX = "sdnmpi."
#: where no stage of the program was open
UNNAMED = "unnamed"
#: the hand-written kernels' wrappers, each counting its launches: K1, K2's
#: set-up, K2, K3, K3's step form, S1, S2
KERNELS = (
    ("sdnmpi_tpu_torch.kernels.bfs", "bfs_distances"),
    ("sdnmpi_tpu_torch.kernels.sampler", "sampler_tables"),
    ("sdnmpi_tpu_torch.kernels.sampler", "sample_slots"),
    ("sdnmpi_tpu_torch.kernels.ring", "ring_all_gather"),
    ("sdnmpi_tpu_torch.kernels.ring", "ring_step"),
    ("sdnmpi_tpu_torch.oracle.congestion", "route_flows_balanced"),
    ("sdnmpi_tpu_torch.sched.phases", "_pack_greedy_device"),
)


@dataclasses.dataclass
class StagedTrace(Trace):
    """A :class:`~portbench.trace.Trace` with the program's stage ranges."""

    stages: list = dataclasses.field(default_factory=list)  # (name, start_s, end_s)

    def stage_s(self, name: str) -> float:
        """Host seconds spent in stage ``name`` (every range of it)."""
        return sum(e - s for n, s, e in self.stages if n == name)

    def idle_intervals(self) -> list:
        """``(start, end)`` of each interval of the window in which no
        operation ran on the device."""
        t0, t1 = self.window
        idle, reach = [], t0
        for _, s, e in sorted(self.ops, key=lambda x: x[1]):
            if min(s, t1) > reach:
                idle.append((reach, min(s, t1)))
            reach = max(reach, e)
        if reach < t1:
            idle.append((reach, t1))
        return idle

    def pieces(self) -> list:
        """The window cut at every stage's start and end into
        ``(start, end, name)``, each piece named by the innermost stage
        open over it (the latest started: a thread's ranges nest), or
        :data:`UNNAMED`."""
        t0, t1 = self.window
        cuts = sorted({t0, t1, *(min(max(x, t0), t1)
                                 for _, s, e in self.stages for x in (s, e))})
        by_start = sorted(self.stages, key=lambda x: x[1])
        active, k, out = [], 0, []
        for a, b in zip(cuts, cuts[1:]):
            while k < len(by_start) and by_start[k][1] <= a:
                active.append(by_start[k])
                k += 1
            active = [st for st in active if st[2] > a]
            name = max(active, key=lambda st: (st[1], -st[2]))[0] if active else UNNAMED
            out.append((a, b, name))
        return out

    def idle_by_stage(self) -> dict:
        """The device's idle seconds in the window, each put down to the
        innermost stage open at the time, or to :data:`UNNAMED`."""
        pieces, out, i = self.pieces(), {}, 0
        for s, e in self.idle_intervals():
            while i < len(pieces) and pieces[i][1] <= s:
                i += 1
            j = i
            while j < len(pieces) and pieces[j][0] < e:
                a, b, name = pieces[j]
                part = min(b, e) - max(a, s)
                if part > 0:
                    out[name] = out.get(name, 0.0) + part
                j += 1
        return out


def staged(trace: Trace, results) -> StagedTrace:
    """``trace`` with the program's host ranges from the profiler's
    ``results`` as its stages; their device-side annotation copies are
    never operations."""
    from torch.autograd import DeviceType

    stages = []
    for ev in results.events():
        name = ev.name()
        if name.startswith(PREFIX) and ev.device_type() == DeviceType.CPU:
            start = ev.start_ns() * 1e-9
            stages.append((name[len(PREFIX):], start, start + ev.duration_ns() * 1e-9))
    ops = [op for op in trace.ops if not op[0].startswith(PREFIX)]
    return StagedTrace(trace.window, ops, trace.spans, stages)


def watch(run):
    """Read the run's profile into a :class:`StagedTrace`; returns the
    undo, or None where a metric of the run has done so already."""
    from portbench import trace

    if run.records.get("stages"):
        return None
    run.records["stages"] = True
    inner = trace.read

    def read(results):
        return staged(inner(results), results)

    trace.read = read
    return lambda: setattr(trace, "read", inner)


def stage_ms(run, name: str):
    """Host ms of stage ``name`` a collective in the window, or None
    where the program recorded no such stage."""
    trace = run.trace
    if not isinstance(trace, StagedTrace) or not any(n == name for n, _, _ in trace.stages):
        return None
    return 1e3 * trace.stage_s(name) / run.collectives


def launch_counts() -> dict:
    """Each kernel wrapper's launch count, by its name; a wrapper the
    program lacks is left out."""
    out = {}
    for module, name in KERNELS:
        fn = getattr(importlib.import_module(module), name, None)
        if hasattr(fn, "launches"):
            out[name] = int(fn.launches)
    return out

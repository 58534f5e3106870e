"""Spans and the device trace of a traced run.

:class:`Spans` times the benchmark's own spans around the calls into the
program's layers, on the host clock, and in a traced run marks each one
in the profiler's timeline (``record_function``), so an idle gap on the
device can be named by the span that was open. :func:`profile` runs the
measured window under ``torch.profiler`` and reads back, from the
profiler's raw events, every device operation (kernels, copies, sets)
and every span, all on the profiler's clock.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

class Spans:
    """Host-clock spans ``(name, start_s, end_s)``; off unless traced."""

    def __init__(self, on: bool):
        self.on = on
        self.done: list[tuple[str, float, float]] = []
        self._null = contextlib.nullcontext()

    @contextlib.contextmanager
    def _span(self, name: str):
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(f"portbench.{name}"):
            yield
        self.done.append((name, t0, time.perf_counter()))

    def __call__(self, name: str):
        return self._span(name) if self.on else self._null

    def mean_ms(self, name: str) -> float | None:
        walls = [t1 - t0 for n, t0, t1 in self.done if n == name]
        return 1e3 * sum(walls) / len(walls) if walls else None


@dataclasses.dataclass
class Trace:
    """What the profiler saw in the window, in seconds from its start."""

    window: tuple[float, float]
    ops: list  # (name, start_s, end_s) of every device operation
    spans: list  # (name, start_s, end_s) of every benchmark span

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the
        device (the union of their intervals)."""
        t0, t1 = self.window
        busy, reach = 0.0, t0
        for _, s, e in sorted(self.ops, key=lambda x: x[1]):
            s, e = max(s, reach), min(e, t1)
            if e > s:
                busy += e - s
                reach = e
        return busy

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def device_s(self, names: set) -> float:
        """Device seconds of the operations whose function, namespaces
        left out, is in ``names``."""
        return sum(e - s for n, s, e in self.ops if n.split("::")[-1] in names)

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s)
        return sorted(([k, v] for k, v in by.items()), key=lambda x: -x[1])[:n]

    def gaps(self) -> list:
        """Idle intervals of the device inside the window, each as
        ``(seconds, {span name: seconds of it})``: the idle time split
        by the benchmark span that was open (``harness`` where none
        was)."""
        t0, t1 = self.window
        idle, reach = [], t0
        for _, s, e in sorted(self.ops, key=lambda x: x[1]):
            if s > reach:
                idle.append((reach, min(s, t1)))
            reach = max(reach, e)
        if reach < t1:
            idle.append((reach, t1))
        # the benchmark's spans follow one another without nesting
        spans = sorted(self.spans, key=lambda x: x[1])
        ends = [b for _, _, b in spans]
        out = []
        for s, e in idle:
            split = {}
            i = bisect.bisect_right(ends, s)
            while i < len(spans) and spans[i][1] < e:
                name, a, b = spans[i]
                part = min(b, e) - max(a, s)
                if part > 0:
                    split[name] = split.get(name, 0.0) + part
                i += 1
            rest = (e - s) - sum(split.values())
            if rest > 0:
                split["harness"] = split.get("harness", 0.0) + rest
            out.append((e - s, split))
        return out

    def idle_breakdown(self, n: int = 10) -> list:
        """Idle seconds summed by the span that was open, then the longest
        single gaps, each named by the span that held most of it, at most
        ``n`` entries in all."""
        gaps = self.gaps()
        total = {}
        for _, split in gaps:
            for name, sec in split.items():
                total[name] = total.get(name, 0.0) + sec
        out = [[f"all idle in {k}", v] for k, v in
               sorted(total.items(), key=lambda x: -x[1])]
        longest = sorted(gaps, key=lambda x: -x[0])[: max(0, n - len(out))]
        return out + [[f"longest gap, mostly in {max(split, key=split.get)}", sec]
                      for sec, split in longest]


def kernel_name(raw: str) -> str:
    """A device operation's qualified function name: no return type,
    anonymous namespace, template arguments or parameter list."""
    name = raw.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0].strip()


def profile(fn):
    """Run ``fn()`` under the profiler; returns ``(fn's result, Trace)``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("portbench.window"):
            out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return out, read(prof.profiler.kineto_results)


def _is_op(ev, name: str) -> bool:
    """Whether a device event is an operation (a kernel, a copy, a set)
    and not the device-side copy of an annotation: the profiler gives no
    activity type, but marks annotations, which carry the spans' names."""
    return not (ev.is_user_annotation() or name.startswith("portbench."))


def read(results) -> Trace:
    from torch.autograd import DeviceType

    ops, spans, window = [], [], None
    for ev in results.events():
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if name == "portbench.window":
                window = (start, end)
            elif name.startswith("portbench."):
                spans.append((name[len("portbench."):], start, end))
            continue
        if _is_op(ev, name):
            ops.append((kernel_name(name), start, end))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return Trace(window, ops, spans)

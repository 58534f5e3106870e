"""The program's stage ranges in a traced run: the idle time put down to
the innermost stage, a profile with the ranges read as one without them,
the launch counters' difference over the window, and the new per-layer
metrics of a tiny traced cell on the CPU."""

from __future__ import annotations

import json
import time
import types

import pytest

from portbench import harness, stages, trace
from portbench.stages import UNNAMED, StagedTrace


def test_idle_by_stage_takes_the_innermost_stage():
    t = StagedTrace(
        (0.0, 10.0),
        [("k", 1.0, 2.0), ("k", 5.0, 6.0)],
        [],
        [("collective", 0.5, 4.0), ("resolve", 0.5, 1.5), ("enqueue", 2.5, 3.0),
         ("collective_reap", 4.5, 8.0), ("wait", 4.5, 5.5), ("fdbs", 6.5, 7.0)])
    idle = t.idle_by_stage()
    # idle 0-1, 2-5, 6-10; the device runs through most of ``wait``
    assert idle == pytest.approx({
        UNNAMED: 0.5 + 0.5 + 2.0,  # before the call, between the spans, after the reap
        "resolve": 0.5,
        "collective": 0.5 + 1.0,  # 2.0-2.5 and 3.0-4.0: no stage open
        "enqueue": 0.5,
        "wait": 0.5,
        "collective_reap": 0.5 + 1.0,  # 6.0-6.5 and 7.0-8.0, beside the fdbs
        "fdbs": 0.5,
    })
    assert sum(idle.values()) == pytest.approx(t.window_s() - t.busy_s())
    assert t.stage_s("resolve") == pytest.approx(1.0)
    assert [p[2] for p in t.pieces()][:3] == [UNNAMED, "resolve", "collective"]


def test_idle_by_stage_without_stages_or_ops():
    t = StagedTrace((0.0, 4.0), [("k", 1.0, 3.0)], [], [])
    assert t.idle_by_stage() == pytest.approx({UNNAMED: 2.0})
    t = StagedTrace((0.0, 4.0), [], [], [("collective", -1.0, 5.0)])
    assert t.idle_by_stage() == pytest.approx({"collective": 4.0})


class _Event:
    """One raw profiler event as :func:`portbench.trace.read` sees it."""

    def __init__(self, name, start, end, cpu=True, annotation=False):
        self._name, self._s, self._d = name, int(start * 1e9), int((end - start) * 1e9)
        self._cpu, self._annotation = cpu, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CPU if self._cpu else DeviceType.CUDA

    def is_user_annotation(self):
        return self._annotation


def _results(events):
    return types.SimpleNamespace(events=lambda: list(events))


def test_ranges_leave_what_the_trace_read_unmoved():
    """A profile holding the program's ranges, and the device-side
    copies of them a profiler may keep unmarked, reads as the same
    profile without them."""
    base = [
        _Event("portbench.window", 0.0, 10.0),
        _Event("portbench.dispatch", 0.5, 3.0),
        _Event("portbench.reap", 3.0, 5.5),
        _Event("void scan_resident(int)", 1.0, 2.0, cpu=False),
        _Event("Memcpy HtoD (Pageable -> Device)", 1.5, 2.5, cpu=False),
        _Event("sample_slots", 5.0, 6.0, cpu=False),
        _Event("aten::add", 0.7, 0.8),
    ]
    ranges = [
        _Event("sdnmpi.collective", 0.6, 2.9),
        _Event("sdnmpi.enqueue", 0.9, 2.8),
        _Event("sdnmpi.enqueue", 1.0, 2.5, cpu=False),  # a device-side copy
        _Event("sdnmpi.wait", 3.1, 5.2, cpu=False, annotation=True),
        _Event("sdnmpi.wait", 3.1, 5.2),
    ]
    plain = trace.read(_results(base))
    staged = stages.staged(trace.read(_results(base + ranges)), _results(base + ranges))
    assert sorted(staged.ops) == sorted(plain.ops)
    assert staged.spans == plain.spans and staged.window == plain.window
    assert staged.busy_s() == pytest.approx(plain.busy_s())
    assert staged.gaps() == plain.gaps()
    assert staged.idle_breakdown() == plain.idle_breakdown()
    assert sorted((n, round(s, 6), round(e, 6)) for n, s, e in staged.stages) == [
        ("collective", 0.6, 2.9), ("enqueue", 0.9, 2.8), ("wait", 3.1, 5.2)]


def test_a_cpu_profile_reads_the_same_with_the_stages():
    """A real CPU profile of one collective: the staged read keeps every
    field of the plain one and adds the program's stages."""
    import numpy as np
    import torch

    from sdnmpi_tpu_torch.topogen import fattree

    db = fattree(4).to_topology_db(backend="torch", device="cpu")
    macs = sorted(db.hosts)
    src, dst = np.nonzero(~np.eye(len(macs), dtype=bool))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("portbench.window"):
            db._oracle_engine().routes_collective(
                db, macs, src.astype(np.int32), dst.astype(np.int32), "balanced")
    results = prof.profiler.kineto_results
    plain = trace.read(results)
    staged = stages.staged(trace.read(results), results)
    assert (staged.window, staged.ops, staged.spans) == (plain.window, plain.ops, plain.spans)
    assert staged.gaps() == plain.gaps()
    assert staged.idle_breakdown() == plain.idle_breakdown()
    assert {n for n, _, _ in staged.stages} == {
        "collective", "resolve", "group", "deal", "enqueue", "base",
        "collective_reap", "wait", "decode", "fdbs", "congestion"}


def test_watch_reads_the_profile_staged_once_a_run(monkeypatch):
    run = harness.Run()
    inner = trace.read
    undo = stages.watch(run)
    assert stages.watch(run) is None  # a second metric of the run
    assert trace.read is not inner
    undo()
    assert trace.read is inner


def test_launch_counts_over_the_window(monkeypatch):
    from sdnmpi_tpu_torch.kernels import sampler
    from sdnmpi_tpu_torch.sched import phases

    kernel_launches = harness.load_module(
        harness.metric_path(harness.pathlib.Path(stages.__file__).parents[1],
                            "kernel_launches.phased"))
    monkeypatch.setattr(sampler.sample_slots, "launches", 7)
    monkeypatch.setattr(phases._pack_greedy_device, "launches", 1)
    run = harness.Run()
    undo = kernel_launches.watch(run)
    assert kernel_launches.read(run) is None  # the window has not ended
    sampler.sample_slots.launches += 4
    phases._pack_greedy_device.launches += 2
    undo()
    run.collectives = 2
    assert run.records["kernel_launches"]["sample_slots"] == 4
    assert kernel_launches.read(run) == pytest.approx(3.0)
    assert set(stages.launch_counts()) == {name for _, name in stages.KERNELS}


@pytest.mark.parametrize("cell", ["tiny-flat-a2a", "tiny-phased-a2a"])
def test_a_traced_cpu_cell_reports_each_stage_metric(tiny, cell):
    result, _ = harness.run_cell(tiny, cell, 2**31 + 7, 0.3, True, "cpu",
                                 time.perf_counter())
    assert result["correct"] is True
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    entries = harness.metric_entries(bench, cell, True)
    spans = {m["name"] for m in entries if m["source"] == "program_span"}
    assert spans >= ({"resolve_ms.phased", "pack_ms", "wait_ms.phased"}
                     if "phased" in cell else {"resolve_ms", "group_ms", "decode_ms"})
    for name in spans:
        value = result["metrics"][name]["value"]
        assert isinstance(value, float) and value > 0, name
    # no card: nothing of the device to read, and no launch counted
    for name in ("kernel_launches", "idle_unnamed_pct"):
        assert not any(k.split(".")[0] == name for k in result["metrics"])

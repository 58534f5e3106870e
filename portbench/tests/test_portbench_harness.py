"""The harness end to end on the CPU at tiny cells (the look for a card
skipped): its result line, the timed path broken underneath it, the
command's refusals, a cell added by files alone, and the card's own
run."""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

from portbench import harness, reference

ROOT = pathlib.Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, cell, trace=False, seconds=0.3, seed=2**31 + 99):
    return harness.run_cell(root, cell, seed, seconds, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell, trace", [
    ("tiny-flat-a2a", False), ("tiny-phased-a2a", False),
    ("tiny-flat-allreduce-rd", True), ("tiny-phased-a2a", True),
])
def test_result_line(tiny, cell, trace):
    result, lines = _run(tiny, cell, trace)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == want  # the comparison comes last
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 8
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    # the CPU has no device trace: those metrics find nothing to read
    names = {m["name"] for m in harness.metric_entries(bench, cell, trace)
             if m["source"] != "device_trace"}
    assert names and set(result["metrics"]) == names
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert result["checks"] == {k: {"value": 0, "limit": 0} for k in reference.LIMITS}
    assert lines[-1].startswith("check congestion_gap")
    json.loads(json.dumps(result))


class _Broken:
    """A dispatched window whose routes are broken as they are reaped."""

    last = None

    def __init__(self, window, fault):
        self.window, self.fault = window, fault

    def reap(self):
        routes = self.window.reap()
        if self.fault == "stale" and _Broken.last is not None:
            out = _Broken.last  # the state a previous call left, returned unchanged
        else:
            out = routes
        if self.fault == "drop_half":
            routes.pair_sub[::2] = -1
        elif self.fault == "alter_hop":
            routes.hop_dpid[0, 0] = routes.hop_dpid[-1, 0] + 1
        _Broken.last = routes
        return out


@pytest.mark.parametrize("cell", ["tiny-flat-a2a", "tiny-phased-a2a"])
@pytest.mark.parametrize("fault", ["drop_half", "alter_hop", "stale"])
def test_broken_path_is_not_correct(tiny, monkeypatch, cell, fault):
    from sdnmpi_tpu_torch.oracle.engine import RouteOracle

    inner = RouteOracle.routes_collective_dispatch

    def dispatch(self, *args, **kwargs):
        return _Broken(inner(self, *args, **kwargs), fault)

    _Broken.last = None
    monkeypatch.setattr(RouteOracle, "routes_collective_dispatch", dispatch)
    result, lines = _run(tiny, cell)
    assert result["correct"] is False and result["failed"] > 0
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def _command(root, cell="k16-phased-a2a512", env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "5",
         "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300, env=env)


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_command_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _command(tmp_path, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


#: a loop and a metric that watches the program, each a new file
PACED = """import time

def window(driver, jobs, seconds, keep):
    walls, t0 = [], time.perf_counter()
    for n in range(2 * len(jobs)):
        t = time.perf_counter()
        keep(n, driver(jobs[n % len(jobs)]))
        walls.append(time.perf_counter() - t)
    return len(walls), time.perf_counter() - t0, walls
"""
GROUPINGS = """def watch(run):
    from sdnmpi_tpu_torch import native

    inner = native.group_pairs
    calls = run.records.setdefault("groupings", [])

    def count(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    native.group_pairs = count
    return lambda: setattr(native, "group_pairs", inner)


def read(run):
    return len(run.records.get("groupings", [])) / run.collectives
"""


@pytest.mark.parametrize("new", ["traffic", "loop_and_metric"])
def test_a_cell_added_by_files_alone(tiny, new):
    mix = {"pairs": {"partner": "add", "steps": [1, 2]}, "loop": "closed", "jobs": 3,
           "placement": {"kind": "block", "align": [0.25]}, "util": {"max_share": 0.05, "seed": 2}}
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    if new == "loop_and_metric":
        mix["loop"] = "paced"
        (tiny / "portbench" / "loops" / "paced.py").write_text(PACED)
        (tiny / "portbench" / "metrics" / "groupings.py").write_text(GROUPINGS)
        bench["per_layer"].append({
            "name": "groupings", "unit": "calls", "better": "lower",
            "source": "program_counter", "layer": "entry and engine",
            "moves": "collective_ms", "workloads": ["tiny-flat-ring"]})
    (tiny / "portbench" / "traffic" / "ring-test.json").write_text(json.dumps(mix))
    bench["workloads"].append({"name": "tiny-flat-ring", "config": "tiny-flat",
                               "traffic": "ring-test", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("collective_ms", "max_link_load"):
            m["workloads"].append("tiny-flat-ring")
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    traced = new == "loop_and_metric"
    code = ("import sys, time, json; sys.path.insert(0, sys.argv[1]); "
            "from portbench import harness; "
            "r, _ = harness.run_cell(__import__('pathlib').Path(sys.argv[1]), "
            f"'tiny-flat-ring', 11, 0.3, {traced}, 'cpu', time.perf_counter()); "
            "print(json.dumps(r))")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code, str(tiny)], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    if traced:
        # the new loop sends each of the 3 jobs twice; one grouping each
        assert result["attempted"] == 6
        assert result["metrics"] == {"groupings": {"value": 1.0, "unit": "calls"}}
    else:
        assert set(result["metrics"]) == {"collective_ms", "max_link_load", "setup_s"}


@pytest.mark.card
def test_a_cell_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "k28-flat-a2a4096",
         "--seed", "2147483659", "--seconds", "5", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert 0 < result["metrics"]["sampler_roofline"]["value"] <= 100

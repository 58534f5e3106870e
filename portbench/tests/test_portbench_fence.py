"""The fence: a run loads neither JAX nor the JAX package, compared by
whole top-level module names (``sdnmpi_tpu_torch`` begins with
``sdnmpi_tpu`` and is not it), and the reference, the control and the
traffic generator load nothing of the program."""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]

#: a finder that refuses the fenced names, then the code under test
BLOCK = """
import sys, importlib.abc
class Fence(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "sdnmpi_tpu"):
            raise ImportError(f"fenced: {name}")
        return None
sys.meta_path.insert(0, Fence())
sys.path.insert(0, sys.argv[1])
"""


def _python(code: str, root: pathlib.Path) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", BLOCK + code, str(root)],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


#: a metric file that loads a fenced module as it reads, as a library that
#: pulls JAX in by itself would, after the window has closed
PROBE = """import sys, types

def read(run):
    sys.modules["jaxlib"] = types.ModuleType("jaxlib")
    return 1.0
"""


@pytest.mark.parametrize("probe", [False, True])
def test_a_run_loads_no_fenced_module(tiny, probe):
    if probe:
        (tiny / "portbench" / "metrics" / "fence_probe.py").write_text(PROBE)
        bench = json.loads((tiny / "BENCHMARK.json").read_text())
        bench["per_layer"].append({
            "name": "fence_probe", "unit": "%", "better": "higher",
            "source": "program_counter", "layer": "device", "moves": "collective_ms",
            "workloads": ["tiny-phased-a2a"]})
        (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    got = _python(
        "import time, json, pathlib\n"
        "from portbench import harness\n"
        "try:\n"
        "    r, _ = harness.run_cell(pathlib.Path(sys.argv[1]), 'tiny-phased-a2a', 3, 0.3,"
        " True, 'cpu', time.perf_counter())\n"
        "except harness.FencedImport as exc:\n"
        "    r = {'fenced': exc.names}\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'result': r, 'tops': tops}))\n", tiny)
    assert "sdnmpi_tpu_torch" in got["tops"]
    if probe:
        # loaded after the window, by a reader: no result comes back
        assert got["result"] == {"fenced": ["jaxlib"]}
        return
    assert got["result"]["correct"] is True
    assert not {"jax", "jaxlib", "flax", "sdnmpi_tpu"} & set(got["tops"])


def test_the_reference_loads_nothing_of_the_program():
    got = _python(
        "import json, numpy as np\n"
        "from portbench import control, reference, traffic\n"
        "from portbench.fabrics import fattree\n"
        "fab = fattree.reference_fabric({'k': 4})\n"
        "h = np.arange(16); s, d = np.nonzero(~np.eye(16, dtype=bool))\n"
        "r = control.detour_routes(fab, h, s, d)\n"
        "counts, _ = reference.judge(fab, [(0, None, r)], None, reference.Pairs.of(fab, h, s, d))\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'counts': counts, 'tops': tops}))\n", ROOT)
    assert got["counts"]["longer_than_shortest"] > 0
    assert "sdnmpi_tpu_torch" not in got["tops"]


def test_fenced_names_are_compared_whole(monkeypatch):
    import sdnmpi_tpu_torch  # noqa: F401

    assert harness.fenced_modules() == []
    monkeypatch.setitem(sys.modules, "sdnmpi_tpu.core", object())
    assert harness.fenced_modules() == ["sdnmpi_tpu"]

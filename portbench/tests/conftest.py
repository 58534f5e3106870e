"""Shared pieces of the benchmark's tests: the checkout root on the path,
the ``card`` marker, and a temporary copy of the benchmark with tiny
cells (a k=4 fat-tree, 8 ranks) that the CPU can run through the
harness."""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: tiny stand-ins of the two configurations: same entries, a k=4 fabric
TINY = {
    "tiny-phased": "fattree-k16-phased",
    "tiny-flat": "fattree-k28-flat",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips itself without one")


def make_tiny_copy(dest: pathlib.Path, traffics=("a2a", "allreduce-rd")) -> pathlib.Path:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` under ``dest``,
    with a tiny cell for each configuration and traffic mix added as
    files and entries, as a later change would add a cell."""
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells_of = {}
    for cell in bench["workloads"]:
        cells_of.setdefault(cell["config"], set()).add(cell["name"])
    for name, like in TINY.items():
        cfg = json.loads((ROOT / "portbench" / "configs" / f"{like}.json").read_text())
        cfg.update(name=name, fabric={"kind": "fattree", "k": 4}, ranks=8, db_kwargs={})
        path = f"portbench/configs/{name}.json"
        (dest / path).write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test", "file": path,
                                 "reduced": [], "why": "test"})
        for traffic in traffics:
            cell = f"{name}-{traffic}"
            bench["workloads"].append({"name": cell, "config": name, "traffic": traffic,
                                       "chips": 1, "why": "test"})
            # the tiny cell reports what the configuration it stands for reports
            for m in bench["end_to_end"] + bench["per_layer"]:
                if "workloads" in m and cells_of[like] & set(m["workloads"]):
                    m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture
def tiny(tmp_path) -> pathlib.Path:
    return make_tiny_copy(tmp_path)

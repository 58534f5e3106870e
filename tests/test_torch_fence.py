"""sdnmpi_tpu_torch stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless asked otherwise.

The import check runs in a fresh interpreter with ``jax`` and
``sdnmpi_tpu`` blocked in ``sys.modules`` (any import of them raises),
and a source scan catches imports the import check cannot reach (inside
functions).
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "sdnmpi_tpu_torch"
BLOCKED = ("jax", "jaxlib", "sdnmpi_tpu")


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil\n"
        "import sdnmpi_tpu_torch\n"
        "for m in pkgutil.walk_packages(sdnmpi_tpu_torch.__path__, 'sdnmpi_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'sdnmpi_tpu') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, f"{path}: import {name}"


def test_entry_points_default_to_the_card():
    """The default device is CUDA: without a card, asking for it raises
    instead of moving to the CPU."""
    from sdnmpi_tpu_torch.core.topology_db import TopologyDB
    from sdnmpi_tpu_torch.oracle.engine import RouteOracle
    from sdnmpi_tpu_torch.topogen import linear

    if torch.cuda.is_available():
        assert TopologyDB().device.type == "cuda"
        assert RouteOracle().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TopologyDB()
        with pytest.raises(RuntimeError):
            RouteOracle()
        with pytest.raises(RuntimeError):
            linear(3).to_topology_db()
    assert TopologyDB(device="cpu").device.type == "cpu"
    assert TopologyDB(backend="py").backend == "py"


def test_wrappers_refuse_other_devices():
    from sdnmpi_tpu_torch.kernels import bfs_distances, sample_slots

    meta = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError):
        bfs_distances(meta, 2)
    idx = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        sample_slots(meta, meta, idx, idx, 2)

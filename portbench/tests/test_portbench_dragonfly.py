"""The dragonfly fabric, the UGAL reference and a tiny dragonfly cell on
the CPU: the reference's fabric is the port generator's, dpid for dpid
and port for port; the placement maps the fabric onto itself; a tiny
dragonfly cell (4 groups of 4 routers, 2 hosts a router, 32 ranks)
through the harness is correct with every UGAL check at 0, traced or
not; and the fence holds with the UGAL reference loaded."""

from __future__ import annotations

import json
import pathlib
import time

import numpy as np
import pytest

from portbench import harness, reference_ugal
from portbench.fabrics import dragonfly
from portbench.tests.test_portbench_fence import _python

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPECS = [
    {"groups": 4, "routers": 4, "hosts_per_router": 2, "global_links": 2},
    {"groups": 5, "routers": 6, "hosts_per_router": 1, "global_links": 2},
]
CELL = "tiny-dragonfly-a2a"


@pytest.mark.parametrize("spec", SPECS, ids=["df4x4h2", "df5x6h1"])
def test_reference_fabric_is_the_generators(spec):
    from sdnmpi_tpu_torch.topogen import dragonfly as generator

    fab = dragonfly.reference_fabric(spec)
    gen = generator(spec["groups"], spec["routers"], spec["hosts_per_router"],
                    spec["global_links"])
    assert fab.dpids.tolist() == sorted(gen.switches)
    port = np.full_like(fab.port, -1)
    for a, pa, b, pb in gen.links:
        port[a - 1, b - 1], port[b - 1, a - 1] = pa, pb
    np.testing.assert_array_equal(fab.port, port)
    assert [(m, int(fab.dpids[s]), int(p)) for m, s, p
            in zip(fab.host_mac, fab.host_sw, fab.host_port)] == gen.hosts
    assert int(fab.dist.max()) == 3


@pytest.mark.parametrize("spec", SPECS, ids=["df4x4h2", "df5x6h1"])
def test_placement_rows_map_the_fabric_onto_itself(spec):
    fab = dragonfly.reference_fabric(spec)
    place = dragonfly.placement(spec)
    assert place.pod_hosts == fab.n_hosts
    assert place.edge_hosts == spec["hosts_per_router"]
    # a job moves by whole machines, so every router stays where it is
    rows = place.rows(0)
    np.testing.assert_array_equal(fab.port[np.ix_(rows, rows)], fab.port)
    np.testing.assert_array_equal(rows[fab.host_sw], fab.host_sw)


@pytest.fixture
def tiny_df(tiny) -> pathlib.Path:
    """The tiny copy of the benchmark with a dragonfly cell that reports
    what ``df8x32-ugal-a2a1024`` reports, added by files and entries
    alone."""
    root = tiny
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/dragonfly-8x32-ugal.json").read_text())
    cfg.update(name="tiny-dragonfly", fabric={"kind": "dragonfly", **SPECS[0]}, ranks=32)
    path = "portbench/configs/tiny-dragonfly.json"
    (root / path).write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-dragonfly", "source": "test", "file": path,
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-dragonfly", "traffic": "a2a",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "df8x32-ugal-a2a1024" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_a_tiny_dragonfly_cell(tiny_df, trace, capsys):
    result, lines = harness.run_cell(tiny_df, CELL, 2**31 + 77, 0.3, trace, "cpu",
                                     time.perf_counter())
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"] == {k: {"value": 0, "limit": 0} for k in reference_ugal.LIMITS}
    assert result["attempted"] >= 8
    bench = json.loads((tiny_df / "BENCHMARK.json").read_text())
    names = {m["name"] for m in harness.metric_entries(bench, CELL, trace)
             if m["source"] != "device_trace"}
    assert set(result["metrics"]) == names
    if trace:
        assert {"ugal_ms", "ugal_wait_ms", "segments_ms", "stitch_ms"} <= names
    assert lines[-1].startswith("check congestion_gap")
    # the driver's line for every collective judged
    judged = next(int(line.split()[1]) for line in lines if line.startswith("judged "))
    assert capsys.readouterr().err.count("ugal job ") == judged >= 8


def test_the_fence_holds_with_the_ugal_reference_loaded(tiny_df):
    got = _python(
        "import time, json, pathlib\n"
        "from portbench import harness, reference_ugal\n"
        "r, _ = harness.run_cell(pathlib.Path(sys.argv[1]), 'tiny-dragonfly-a2a', 5, 0.3,"
        " True, 'cpu', time.perf_counter())\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'result': r, 'tops': tops}))\n", tiny_df)
    assert got["result"]["correct"] is True
    assert "sdnmpi_tpu_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "sdnmpi_tpu"} & set(got["tops"])


def test_the_ugal_reference_loads_nothing_of_the_program():
    """The reference, the fabric and the driver's module without the
    program: routes through a border router are Valiant routes, so only
    the choice check fails them."""
    got = _python(
        "import json, numpy as np\n"
        "from portbench import control, reference, reference_ugal\n"
        "from portbench.drivers import adaptive\n"
        "from portbench.fabrics import dragonfly\n"
        "fab = dragonfly.reference_fabric({'groups': 4, 'routers': 4, 'hosts_per_router': 2})\n"
        "h = np.arange(32); s, d = np.nonzero(~np.eye(32, dtype=bool))\n"
        "r = control.detour_routes(fab, h, s, d)\n"
        "cost = reference_ugal.link_costs(fab, {}, len(s), 1e10)\n"
        "counts, _, _ = reference_ugal.judge(fab, r, reference.Pairs.of(fab, h, s, d),\n"
        "    reference_ugal.minimal_costs(fab, cost), 8, 1.0)\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'counts': counts, 'tops': tops}))\n", ROOT)
    assert got["counts"]["ugal_choice_errors"] > 0
    assert got["counts"]["not_minimal_or_valiant"] == 0
    assert "sdnmpi_tpu_torch" not in got["tops"]

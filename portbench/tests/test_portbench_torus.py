"""The torus fabric, the balancer's reference and a tiny torus cell on the
CPU: the reference's fabric is the port generator's and the program
TopologyDB's, switch for switch and port for port; the placement moves a
job by whole slabs of the first axis; a tiny torus cell (4x4x2, one host
a switch, 32 ranks) through the harness is correct with every check at
0, ``fractional_gap`` included, traced or not; a balancer that runs one
round short, or rounds its split weights to bfloat16, fails
``fractional_gap``, and a route one hop made longer fails
``longer_than_shortest``; and the reference loads nothing of the
program."""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time

import numpy as np
import pytest

from portbench import harness, reference_dag, traffic
from portbench.drivers import dag as dag_driver
from portbench.fabrics import torus
from portbench.tests.test_portbench_fence import _python
from portbench.trace import Spans

ROOT = pathlib.Path(__file__).resolve().parents[2]
SMALL = [[4, 4, 2], [3, 3, 3]]
CELL = "tiny-torus-a2a"
RACK = "t5d-bgq-flat-a2a1024"


def _config() -> dict:
    return json.loads((ROOT / "portbench/configs/torus5d-bgq-rack-flat.json").read_text())


@pytest.mark.parametrize("dims", SMALL + [[4, 4, 4, 4, 2]],
                         ids=["t4x4x2", "t3x3x3", "t4x4x4x4x2"])
def test_reference_fabric_is_the_programs(dims):
    from sdnmpi_tpu_torch.topogen import torus as generator

    spec = {"dims": dims, "hosts_per_switch": 1}
    fab = torus.reference_fabric(spec)
    db = torus.program_db(spec, {}, "cpu")
    assert fab.dpids.tolist() == sorted(db.switches)
    port = np.full_like(fab.port, -1)
    for a, ends in db.links.items():
        for b, link in ends.items():
            port[a - 1, b - 1] = link.src.port_no
    np.testing.assert_array_equal(fab.port, port)
    assert sorted((m, int(fab.dpids[s]), int(p)) for m, s, p
                  in zip(fab.host_mac, fab.host_sw, fab.host_port)) == sorted(
        (mac, h.port.dpid, h.port.port_no) for mac, h in db.hosts.items())
    assert int(fab.dist.max()) == sum(s // 2 for s in dims)
    if dims in SMALL:  # and the generator's own lists, in their order
        gen = generator(tuple(dims))
        assert [(m, int(fab.dpids[s]), int(p)) for m, s, p
                in zip(fab.host_mac, fab.host_sw, fab.host_port)] == gen.hosts
        assert len(gen.links) == int((fab.port >= 0).sum()) // 2


@pytest.mark.parametrize("dims", SMALL + [[8, 4, 4, 4, 2]],
                         ids=["t4x4x2", "t3x3x3", "rack"])
def test_placement_moves_a_job_by_slabs(dims):
    spec = {"dims": dims, "hosts_per_switch": 1}
    fab = torus.reference_fabric(spec)
    place = torus.placement(spec)
    slab = fab.n_hosts // dims[0]
    assert place.pod_hosts == slab and place.edge_hosts == 1
    links = fab.port >= 0
    for p in range(dims[0]):
        rows = place.rows(p)
        assert sorted(rows.tolist()) == list(range(len(rows)))
        # every link lands on a link, and host h on host h + p slabs
        np.testing.assert_array_equal(links[np.ix_(rows, rows)], links)
        h = np.arange(fab.n_hosts)
        np.testing.assert_array_equal(rows[fab.host_sw[h]],
                                      fab.host_sw[(h + p * slab) % fab.n_hosts])
        np.testing.assert_array_equal(fab.dist[np.ix_(rows, rows)], fab.dist)


@pytest.fixture
def tiny_torus(tiny) -> pathlib.Path:
    """The tiny copy of the benchmark with a torus cell that reports what
    ``t5d-bgq-flat-a2a1024`` reports, added by files and entries alone."""
    root = tiny
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = _config()
    cfg.update(name="tiny-torus", fabric={"kind": "torus", "dims": [4, 4, 2],
                                          "hosts_per_switch": 1},
               ranks=32, db_kwargs={})
    path = "portbench/configs/tiny-torus.json"
    (root / path).write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-torus", "source": "test", "file": path,
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-torus", "traffic": "a2a",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if RACK in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_a_tiny_torus_cell(tiny_torus, trace, capsys):
    result, lines = harness.run_cell(tiny_torus, CELL, 2**31 + 91, 0.3, trace, "cpu",
                                     time.perf_counter())
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"] == {k: {"value": 0, "limit": 0} for k in reference_dag.LIMITS}
    assert result["attempted"] >= 8
    bench = json.loads((tiny_torus / "BENCHMARK.json").read_text())
    names = {m["name"] for m in harness.metric_entries(bench, CELL, trace)
             if m["source"] != "device_trace"}
    assert set(result["metrics"]) == names
    if trace:
        # every sub-flow one pair; the 4x4x2 torus's distances 1-5 over a
        # stream of 4 sampled hops: a path of d hops fills min(d, 4) cells
        fab = torus.reference_fabric({"dims": [4, 4, 2]})
        d = fab.dist[~np.eye(32, dtype=bool)]
        want = 100.0 * np.minimum(d, 4).sum() / (4 * len(d))
        assert result["metrics"]["slot_fill_pct"]["value"] == pytest.approx(want)
    else:
        assert result["metrics"]["max_link_load"]["value"] > 0
    judged = next(int(line.split()[1]) for line in lines if line.startswith("judged "))
    assert capsys.readouterr().err.count("dag job ") == judged >= 8


def _routed(dims, rounds: int = 2, seed: int = 2**31 + 5):
    """The fabric, the first job of the a2a mix (a whole-machine
    alltoall) on a small torus, and the dag driver over the program's
    TopologyDB, its reference running ``rounds`` rounds."""
    spec = {"dims": dims, "hosts_per_switch": 1}
    fab = torus.reference_fabric(spec)
    cfg = {**_config(), "fabric": {"kind": "torus", **spec}, "ranks": fab.n_hosts}
    cfg["entry_kwargs"] = {**cfg["entry_kwargs"], "rounds": rounds}
    job = traffic.make_jobs(traffic.load(ROOT, "a2a"), fab.n_hosts, fab,
                            torus.placement(spec), 1e10, seed)[0]
    db = torus.program_db(spec, {}, "cpu")
    driver = dag_driver.Driver(cfg, db, Spans(False))
    return fab, job, driver


def test_the_port_passes_the_dag_judge():
    for dims in SMALL:
        fab, job, driver = _routed(dims)
        counts, load = driver.judge(fab, job, driver(job))
        assert counts == {k: 0 for k in reference_dag.LIMITS}
        assert load > 0


def test_a_round_short_fails_the_fractional_gap():
    fab, job, driver = _routed([4, 4, 2])
    driver.kwargs["rounds"] = 1  # the program runs one round; the reference two
    counts, _ = driver.judge(fab, job, driver(job))
    assert counts["fractional_gap"] == 1
    assert sum(counts.values()) == 1


def test_bfloat16_split_weights_fail_the_fractional_gap(monkeypatch):
    import torch

    from sdnmpi_tpu_torch.oracle import dag

    inner = dag.congestion_weights
    monkeypatch.setattr(dag, "congestion_weights",
                        lambda a, c: inner(a, c).to(torch.bfloat16).to(torch.float32))
    fab, job, driver = _routed([4, 4, 2])
    routes, reported = driver(job)
    counts, _ = driver.judge(fab, job, (routes, reported))
    assert counts["fractional_gap"] == 1
    monkeypatch.setattr(dag, "congestion_weights", inner)
    assert driver.judge(fab, job, driver(job))[0]["fractional_gap"] == 0


def _one_hop_longer(fab, routes):
    """``routes`` with sub-flow 0's first hop a -> b replaced by a ->
    x -> y -> b, three real links with their ports."""
    rows = fab.rows_of(routes.hop_dpid[0])
    a, b = int(rows[0]), int(rows[1])
    links = fab.port >= 0
    x, y = next((x, y) for x in np.nonzero(links[a])[0] if x != b
                for y in np.nonzero(links[x])[0] if y not in (a, b) and links[y, b])
    n = int(routes.hop_len[0])
    path = [a, int(x), int(y)] + rows[1:n].tolist()
    width = routes.hop_dpid.shape[1] + 2
    hop_dpid = np.full((routes.n_subflows, width), -1, np.int64)
    hop_port = np.full((routes.n_subflows, width), -1, np.int32)
    hop_dpid[:, :width - 2] = routes.hop_dpid
    hop_port[:, :width - 2] = routes.hop_port
    hop_dpid[0, :len(path)] = fab.dpids[path]
    hop_port[0, :len(path) - 1] = fab.port[path[:-1], path[1:]]
    hop_port[0, len(path) - 1:] = -1
    hop_len = routes.hop_len.copy()
    hop_len[0] = len(path)
    return dataclasses.replace(routes, hop_dpid=hop_dpid, hop_port=hop_port,
                               hop_len=hop_len)


def test_a_longer_hop_fails_longer_than_shortest():
    fab, job, driver = _routed([4, 4, 2])
    routes, reported = driver(job)
    counts, _ = driver.judge(fab, job, (_one_hop_longer(fab, routes), reported))
    assert counts["longer_than_shortest"] == 1  # every sub-flow one pair
    assert counts["off_fabric_hops"] == counts["wrong_ports"] == 0
    assert counts["fractional_gap"] == 0


def test_the_dag_reference_loads_nothing_of_the_program():
    """The balancer's reference and the torus fabric without the program,
    and its levels against a brute force: on a 3x3x3 torus every link of
    a DAG level leads one hop nearer its destination."""
    got = _python(
        "import json, numpy as np, torch\n"
        "from portbench import reference, reference_dag\n"
        "from portbench.drivers import dag\n"
        "from portbench.fabrics import torus\n"
        "fab = torus.reference_fabric({'dims': [3, 3, 3]})\n"
        "h = np.arange(27); s, d = np.nonzero(~np.eye(27, dtype=bool))\n"
        "pairs = reference.Pairs.of(fab, h, s, d)\n"
        "lv = reference_dag.Levels(fab)\n"
        "tr = reference_dag.pair_traffic(fab, pairs)\n"
        "base = reference_dag.link_base(fab, {}, len(pairs), 1e10)\n"
        "load = reference_dag.fractional_load(lv, tr, base, 2)\n"
        "li, lj = fab.links()\n"
        "ok = all(bool((fab.dist[li[e], t] == l) & (fab.dist[lj[e], t] == l - 1))\n"
        "         for l, (ts, es) in lv.entries.items() for t, e in zip(ts.tolist(), es.tolist()))\n"
        "n = sum(len(es) for _, es in lv.entries.values())\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'load': load.tolist(), 'total': float(tr.sum()), 'ok': ok,\n"
        "                  'entries': n, 'tops': tops}))\n", ROOT)
    assert got["ok"]
    fab = torus.reference_fabric({"dims": [3, 3, 3]})
    li, lj = fab.links()
    # every destination's DAG: each switch at distance l has one closer
    # neighbour per axis it is off the destination on
    off = fab.dist[li][:, :] - fab.dist[lj][:, :]
    assert got["entries"] == int((off == 1).sum())
    # no snapshot: every link alike, each pair's mass crosses its distance
    load = np.asarray(got["load"])
    assert load.sum() == pytest.approx(float(fab.dist[~np.eye(27, dtype=bool)].sum()))
    assert load == pytest.approx(np.full(len(load), load.mean()))
    assert not {"jax", "jaxlib", "flax", "sdnmpi_tpu", "sdnmpi_tpu_torch"} & set(got["tops"])

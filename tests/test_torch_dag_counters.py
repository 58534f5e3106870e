"""The flat DAG leg's slot counters and its fractional congestion.

``oracle_dag_subflows_total``, ``oracle_dag_slots_total`` and
``oracle_dag_decisions_total`` advance, on a balanced flat collective, by
what the returned routes show: the sub-flows, the sub-flows times the
sampled hops (the hop budget less the forced last hop and the source,
``dag.sampled_hops``), and the slot cells that hold a hop, which are also
the non-negative cells of the stream kernel K2's plain version wrote.
The UGAL and phased legs leave all three alone, and so do balanced pair
batches below the DAG threshold; a pair batch at the threshold takes the
DAG leg and counts alike. The balancer's reported fractional
congestion (``last_fractional_congestion``) is the maximum fractional
link load of ``portbench/reference_dag.py``, plain float64 PyTorch over
the directed edge list that imports nothing of the program, within
rtol 1e-5 (``reference_dag.RTOL``), on small tori and a fat-tree under
seeded random snapshots.
"""

import numpy as np
import pytest

from portbench import reference, reference_dag
from portbench.fabrics import fattree, torus
from sdnmpi_tpu_torch.oracle import dag
from sdnmpi_tpu_torch.topogen import dragonfly
from sdnmpi_tpu_torch.utils.metrics import REGISTRY

NAMES = ("oracle_dag_subflows_total", "oracle_dag_slots_total",
         "oracle_dag_decisions_total")
FABRICS = {
    "t4x4x2": (torus, {"dims": [4, 4, 2], "hosts_per_switch": 1}),
    "t3x3x3": (torus, {"dims": [3, 3, 3], "hosts_per_switch": 1}),
    "t4x2x2h2": (torus, {"dims": [4, 2, 2], "hosts_per_switch": 2}),
    "k4": (fattree, {"k": 4}),
}
CAPACITY = 10e9


def _counters() -> list:
    return [REGISTRY.counter(n).value for n in NAMES]


def _snapshot(fab, seed: int) -> dict:
    li, lj = fab.links()
    bps = np.random.default_rng(seed).uniform(0.0, 0.1 * CAPACITY, len(li))
    return {(int(fab.dpids[a]), int(fab.port[a, b])): float(x)
            for a, b, x in zip(li, lj, bps)}


def _alltoall(name: str, seed: int, rounds: int = 2, **kwargs):
    """A seeded alltoall of a random half of the fabric's hosts (at least
    8), under a seeded snapshot: the fabric, the pairs, the snapshot,
    the routes and the oracle."""
    mod, spec = FABRICS[name]
    fab = mod.reference_fabric(spec)
    db = mod.program_db(spec, {}, "cpu")
    rng = np.random.default_rng(seed)
    hosts = rng.permutation(fab.n_hosts)[: max(8, fab.n_hosts // 2)]
    n = len(hosts)
    src, dst = np.nonzero(~np.eye(n, dtype=bool))
    util = _snapshot(fab, seed)
    routes = db.find_routes_collective(
        [fab.host_mac[h] for h in hosts], src.astype(np.int32), dst.astype(np.int32),
        policy="balanced", rounds=rounds, ecmp_ways=4, link_util=util,
        link_capacity=CAPACITY, **kwargs)
    return fab, reference.Pairs.of(fab, hosts, src, dst), util, routes, db._oracle_engine()


@pytest.mark.parametrize("name", ["t4x4x2", "t4x2x2h2", "k4"])
def test_counters_follow_the_routes(name, monkeypatch):
    streams = []
    inner = dag.sample_slots

    def keep(*args, **kwargs):
        out = inner(*args, **kwargs)
        streams.append(out)
        return out

    monkeypatch.setattr(dag, "sample_slots", keep)
    before = _counters()
    _, _, _, routes, _ = _alltoall(name, seed=3)
    got = [a - b for a, b in zip(_counters(), before)]
    n_sub = routes.n_subflows
    hop_len = routes.hop_len.astype(np.int64)
    assert (hop_len >= 1).all()
    # the hop budget is the longest path's switches; the stream leaves out
    # the source and the forced last hop
    width = max(1, int(hop_len.max()) - 2)
    decisions = int(np.minimum(hop_len - 1, width).sum())
    assert got == [n_sub, n_sub * width, decisions]
    (slots,) = streams
    assert slots.shape[1] == width
    assert int((slots[:n_sub] >= 0).sum()) == decisions
    assert 0 < decisions < n_sub * width


def test_other_legs_leave_the_counters_alone():
    db = dragonfly(4, 4, 2, 2).to_topology_db(backend="torch", device="cpu")
    macs = sorted(db.hosts)
    src, dst = np.nonzero(~np.eye(len(macs), dtype=bool))
    src, dst = src.astype(np.int32), dst.astype(np.int32)
    before = _counters()
    ugal = db.find_routes_collective(macs, src, dst, policy="adaptive", ugal_candidates=8)
    phased = db.find_routes_collective_phased(macs, src, dst, policy="balanced")
    for plan in phased.phases:
        plan.reap()
    shortest = db.find_routes_collective(macs, src, dst, policy="shortest")
    pairs = [(macs[0], macs[5]), (macs[3], macs[9])]
    db._oracle_engine().routes_batch_balanced(db, pairs)  # below the DAG threshold
    assert ugal.n_subflows > 0 and shortest.n_subflows > 0 and len(phased.phases) >= 2
    assert _counters() == before
    db.find_routes_collective(macs, src, dst, policy="balanced")
    assert all(a > b for a, b in zip(_counters(), before))


@pytest.mark.parametrize("name", list(FABRICS))
@pytest.mark.parametrize("seed", [1, 2])
def test_fractional_congestion_is_the_references(name, seed):
    fab, pairs, util, routes, oracle = _alltoall(name, seed)
    base = reference_dag.link_base(fab, util, len(pairs), CAPACITY)
    traffic = reference_dag.pair_traffic(fab, pairs)
    load = reference_dag.fractional_load(reference_dag.Levels(fab), traffic, base, 2)
    want = float(load.max())
    assert oracle.last_fractional_congestion == pytest.approx(want, rel=1e-5)
    assert reference_dag.fractional_gap(oracle.last_fractional_congestion, want) == 0
    # one round is another answer, and the judge says so
    one = float(reference_dag.fractional_load(
        reference_dag.Levels(fab), traffic, base, 1).max())
    assert reference_dag.fractional_gap(one, want) == 1
    assert routes.max_congestion >= 1


def test_a_dag_pair_batch_counts_its_slots(monkeypatch):
    """A balanced pair batch at the DAG threshold takes the same leg and
    counts alike: the decisions are the stream's non-negative cells."""
    streams = []
    inner = dag.sample_slots
    monkeypatch.setattr(dag, "sample_slots",
                        lambda *a, **k: streams.append(inner(*a, **k)) or streams[-1])
    mod, spec = FABRICS["t4x4x2"]
    fab = mod.reference_fabric(spec)
    db = mod.program_db(spec, {}, "cpu")
    macs = fab.host_mac
    pairs = [(macs[i], macs[(5 * i + 3) % len(macs)]) for i in range(len(macs))]
    before = _counters()
    fdbs, _ = db._oracle_engine().routes_batch_balanced(db, pairs, dag_threshold=1)
    got = [a - b for a, b in zip(_counters(), before)]
    (slots,) = streams
    assert got[0] > 0 and got[1] == got[0] * slots.shape[1]
    assert got[2] == int((slots[: got[0]] >= 0).sum()) > 0
    assert len(fdbs) == len(pairs) and all(fdbs)

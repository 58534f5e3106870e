"""The reference: its own fabric, its distances, its judgement of the
port's CPU path at a k=4 fat-tree, the control that it must fail, and
K2's byte count."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from portbench import control, reference, roofline
from portbench.fabrics import fattree


def test_reference_fabric_is_the_ports_fattree():
    from sdnmpi_tpu_torch.topogen import fattree as port_fattree

    for k in (4, 16):
        fab = fattree.reference_fabric({"k": k})
        spec = port_fattree(k)
        assert fab.dpids.tolist() == sorted(spec.switches)
        row = {d: i for i, d in enumerate(fab.dpids.tolist())}
        want = np.full_like(fab.port, -1)
        for a, pa, b, pb in spec.links:
            want[row[a], row[b]] = pa
            want[row[b], row[a]] = pb
        np.testing.assert_array_equal(fab.port, want)
        assert fab.host_mac == [m for m, _, _ in spec.hosts]
        assert fab.host_sw.tolist() == [row[d] for _, d, _ in spec.hosts]
        assert fab.host_port.tolist() == [p for _, _, p in spec.hosts]


def test_distances():
    fab = fattree.reference_fabric({"k": 4})
    e0, e1, e2 = fab.host_sw[0], fab.host_sw[2], fab.host_sw[4]  # edges: pod 0, 0, 1
    assert fab.dist[e0, e0] == 0 and fab.dist[e0, e1] == 2 and fab.dist[e0, e2] == 4
    assert (fab.dist >= 0).all() and (fab.dist == fab.dist.T).all()


def _port_routes(phased: bool, ranks: int = 16):
    from sdnmpi_tpu_torch.topogen import fattree as port_fattree

    fab = fattree.reference_fabric({"k": 4})
    db = port_fattree(4).to_topology_db(backend="torch", device="cpu")
    rng = np.random.default_rng(0)
    hosts = rng.permutation(fab.n_hosts)[:ranks]
    src, dst = np.nonzero(~np.eye(ranks, dtype=bool))
    macs = [fab.host_mac[h] for h in hosts]
    pairs = reference.Pairs.of(fab, hosts, src, dst)
    if phased:
        prog = db.find_routes_collective_phased(macs, src, dst, policy="balanced")
        phases = [(p.phase, p.pair_idx, p.reap()) for p in prog.phases]
        return fab, phases, prog.pair_phase, pairs
    routes = db.find_routes_collective(macs, src, dst, policy="balanced")
    return fab, [(0, None, routes)], None, pairs


@pytest.mark.parametrize("phased", [False, True])
def test_the_ports_cpu_path_passes(phased):
    fab, phases, pair_phase, pairs = _port_routes(phased)
    counts, load = reference.judge(fab, phases, pair_phase, pairs)
    assert counts == {k: 0 for k in reference.LIMITS}
    assert load == sum(int(r.max_congestion) for _, _, r in phases) > 0


@pytest.mark.parametrize("fault, check", [
    ("drop_half", "unrouted_pairs"),
    ("alter_hop", "off_fabric_hops"),
    ("wrong_port", "wrong_ports"),
    ("misreport", "congestion_gap"),
    ("phase_twice", "phase_coverage_errors"),
])
def test_each_fault_fails_its_check(fault, check):
    fab, phases, pair_phase, pairs = _port_routes(phased=True)
    pid, idx, r = phases[0]
    r = dataclasses.replace(r, pair_sub=r.pair_sub.copy(), hop_dpid=r.hop_dpid.copy(),
                            final_port=r.final_port.copy())
    if fault == "drop_half":
        r.pair_sub[::2] = -1
    elif fault == "alter_hop":
        r.hop_dpid[0, 1] = r.hop_dpid[0, 0]
    elif fault == "wrong_port":
        r.final_port[0] += 1
    elif fault == "misreport":
        r.max_congestion = r.max_congestion + 1
    else:
        phases = phases + [(phases[1][0], phases[1][1], phases[1][2])]
    phases = [(pid, idx, r)] + phases[1:]
    counts, _ = reference.judge(fab, phases, pair_phase, pairs)
    assert counts[check] > reference.LIMITS[check]


@pytest.mark.parametrize("ranks", [16, 7])
def test_the_control_fails_only_on_shortest_paths(ranks):
    fab = fattree.reference_fabric({"k": 4})
    hosts = np.arange(ranks)
    src, dst = np.nonzero(~np.eye(ranks, dtype=bool))
    routes = control.detour_routes(fab, hosts, src, dst)
    counts, load = reference.judge(fab, [(0, None, routes)], None,
                                   reference.Pairs.of(fab, hosts, src, dst))
    assert counts["longer_than_shortest"] > 0
    assert {k: v for k, v in counts.items() if k != "longer_than_shortest"} == {
        k: 0 for k in reference.LIMITS if k != "longer_than_shortest"}
    assert load == routes.max_congestion > 0


def test_sampler_bytes_match_the_slice():
    # chip_smoke's K2 bound at config 4's slice: V = 1024, a table of
    # width 32 over 21,952 links, 293 destinations in a set of 384,
    # 343,400 sub-flows of 3 sampled hops
    assert roofline.sampler_bytes(1024, 32, 21_952, 293, 384, 343_400, 3) == 5_197_944
    assert roofline.bytes_seconds(5_197_944) * 1e3 == pytest.approx(0.00155, abs=5e-6)

"""The traffic generator: pair counts and patterns, and jobs made from
the seed alone."""

from __future__ import annotations

import pathlib

import numpy as np
import pytest

from portbench import traffic
from portbench.fabrics import fattree

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("mix, ranks, want", [
    ("a2a", 512, 261_632),
    ("a2a", 4096, 16_773_120),
    ("allreduce-rd", 4096, 49_152),
])
def test_pair_counts(mix, ranks, want):
    src, dst = traffic.rank_pairs(traffic.load(ROOT, mix)["pairs"], ranks)
    assert len(src) == len(dst) == want
    assert (src != dst).all()
    assert src.min() >= 0 and max(src.max(), dst.max()) < ranks


@pytest.mark.parametrize("mix, pattern", [
    ("a2a", "alltoall_pairs"),
    ("allreduce-rd", "allreduce_recursive_doubling_pairs"),
])
def test_patterns_are_the_ports_collectives(mix, pattern):
    from sdnmpi_tpu_torch import collectives

    src, dst = traffic.rank_pairs(traffic.load(ROOT, mix)["pairs"], 64)
    want = getattr(collectives, pattern)(64)
    np.testing.assert_array_equal(np.stack([src, dst], axis=1), want)


def test_ring_and_dissemination_rules():
    src, dst = traffic.rank_pairs({"partner": "add", "steps": [1]}, 6)
    np.testing.assert_array_equal(dst, (np.arange(6) + 1) % 6)
    src, dst = traffic.rank_pairs({"partner": "add", "steps": "pow2"}, 8)
    assert len(src) == 24
    with pytest.raises(ValueError):
        traffic.rank_pairs({"partner": "xor", "steps": "pow2"}, 12)


def _jobs(seed, k=16, ranks=512, mix="a2a"):
    fab = fattree.reference_fabric({"k": k})
    return fab, traffic.make_jobs(traffic.load(ROOT, mix), ranks, fab,
                                  fattree.placement({"k": k}), 10e9, seed)


def test_jobs_come_from_the_seed():
    fab, a = _jobs(2**31 + 12345)
    _, b = _jobs(2**31 + 12345)
    _, c = _jobs(7)
    assert [j.hosts.tolist() for j in a] == [j.hosts.tolist() for j in b]
    assert [j.util for j in a] == [j.util for j in b]
    assert [j.hosts.tolist() for j in a] != [j.hosts.tolist() for j in c]
    # every seed places the same set of job shapes, in another order
    assert sorted(j.shape for j in a) == sorted(j.shape for j in c) == [0.0] * 4 + [0.5] * 4
    for job in a:
        # a contiguous block of hosts, wrapping at the end
        assert ((np.diff(job.hosts) % fab.n_hosts) == 1).all()
        assert job.hosts[0] % 8 in (0, 4)
        assert job.macs == [fab.host_mac[h] for h in job.hosts]


def test_util_covers_every_switch_link():
    fab, jobs = _jobs(3)
    li, lj = fab.links()
    assert len(li) == 4096  # k=16: 2 x (128 x 8 + 128 x 8) directed links
    for job in jobs:
        assert len(job.util) == len(li)
        vals = np.array(list(job.util.values()))
        assert vals.min() >= 0 and vals.max() < 1e9
        assert set(job.util) == set(zip(fab.dpids[li].tolist(),
                                        fab.port[li, lj].tolist()))


@pytest.mark.parametrize("k", [4, 16])
def test_moving_pods_maps_the_fabric_onto_itself(k):
    fab = fattree.reference_fabric({"k": k})
    place = fattree.placement({"k": k})
    for pods in range(k):
        rows = place.rows(pods)
        assert sorted(rows.tolist()) == list(range(len(rows)))
        moved = fab.port[np.ix_(rows, rows)]
        np.testing.assert_array_equal(moved >= 0, fab.port >= 0)
        # ports stay but for a core's, whose port to pod q is q + 1
        core = len(fab.top)
        np.testing.assert_array_equal(moved[core:], fab.port[core:])
        live = fab.port[:core] >= 0
        assert ((moved[:core][live] - 1) % k == (fab.port[:core][live] - 1 + pods) % k).all()
        hosts = (np.arange(fab.n_hosts) + pods * place.pod_hosts) % fab.n_hosts
        np.testing.assert_array_equal(fab.host_sw[hosts], rows[fab.host_sw])
        np.testing.assert_array_equal(fab.host_port[hosts], fab.host_port)


def test_every_seed_routes_the_same_jobs_moved():
    """Undo each job's move: every seed gives the same set of (align,
    snapshot) jobs, so a seed changes where the work lands, not the
    work."""
    place = fattree.placement({"k": 16})

    def canonical(seed):
        fab, jobs = _jobs(seed)
        li, lj = fab.links()
        out = []
        for job in jobs:
            pods = int(job.hosts[0] // place.pod_hosts)
            rows = place.rows(pods)
            keys = zip(fab.dpids[rows[li]].tolist(), fab.port[rows[li], rows[lj]].tolist())
            out.append((job.shape, int(job.hosts[0] - pods * place.pod_hosts),
                        tuple(job.util[key] for key in keys)))
        return sorted(out)

    a, b = canonical(2**31 + 5), canonical(17)
    assert a == b
    assert len({u for _, _, u in a}) == 8  # eight distinct snapshots

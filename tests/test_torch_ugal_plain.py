"""The port's UGAL collective against the benchmark's plain reference.

``find_routes_collective(policy="adaptive")`` routes an alltoall over
two small dragonflies on the CPU, under a uniform snapshot and under
config 5's skew (the direct global links from each group to the next
hot), and ``portbench/reference_ugal.py``, plain PyTorch that imports
nothing of the program, judges the routes: every count is 0, and the
intermediates the program chose are the reference's wherever neither a
decision nor the best candidate is a near-tie (near-ties are printed).
Under the skew some pairs detour. The control: with a bias so large
that UGAL never detours, the program's routes break the reference's
choice check.
"""

import numpy as np
import pytest

from portbench import reference, reference_ugal
from portbench.fabrics import dragonfly as fabrics
from sdnmpi_tpu_torch.oracle.engine import RouteOracle

FABRICS = {
    "df4x4h2": {"groups": 4, "routers": 4, "hosts_per_router": 2, "global_links": 2},
    "df5x6h1": {"groups": 5, "routers": 6, "hosts_per_router": 1, "global_links": 2},
}
#: config 5's decision: 8 hashed candidates, bias 1
K, BIAS = 8, 1.0
CAPACITY = 10e9


def _snapshot(fab, spec, kind: str, seed: int = 7) -> dict:
    """``(dpid, port) -> bps`` on every directed switch link: uniform in
    [0, 10%) of capacity, or with config 5's skew, every global link
    from group x to group x + 1 at 90%."""
    li, lj = fab.links()
    bps = np.random.default_rng(seed).uniform(0.0, 0.1 * CAPACITY, len(li))
    if kind == "skew":
        group = np.arange(len(fab.dpids)) // spec["routers"]
        hot = group[lj] == (group[li] + 1) % spec["groups"]
        bps = np.where(hot, 0.9 * CAPACITY, bps)
    keys = zip(fab.dpids[li].tolist(), fab.port[li, lj].tolist())
    return dict(zip(keys, bps.tolist()))


def _route(monkeypatch, spec, kind: str, bias: float):
    """An alltoall over every host through the program; returns the
    fabric, the pairs, the snapshot, the routes and the program's
    ``inter`` (each sub-flow's intermediate, -1 for minimal)."""
    fab = fabrics.reference_fabric(spec)
    db = fabrics.program_db(spec, {}, "cpu")
    hosts = np.arange(fab.n_hosts)
    src, dst = np.nonzero(~np.eye(len(hosts), dtype=bool))
    src, dst = src.astype(np.int32), dst.astype(np.int32)
    util = _snapshot(fab, spec, kind)
    seen = []
    inner = RouteOracle._adaptive_paths

    def record(self, *args, **kwargs):
        out = inner(self, *args, **kwargs)
        seen.append(out[0].copy())
        return out

    monkeypatch.setattr(RouteOracle, "_adaptive_paths", record)
    routes = db.find_routes_collective(
        [fab.host_mac[h] for h in hosts], src, dst, policy="adaptive",
        ugal_candidates=K, ugal_bias=bias, rounds=2, ecmp_ways=4, link_util=util,
        link_capacity=CAPACITY)
    assert len(seen) == 1
    return fab, reference.Pairs.of(fab, hosts, src, dst), util, routes, seen[0]


def _costs(fab, util, n_pairs):
    return reference_ugal.minimal_costs(
        fab, reference_ugal.link_costs(fab, util, n_pairs, CAPACITY))


@pytest.mark.parametrize("kind", ["uniform", "skew"])
@pytest.mark.parametrize("name", sorted(FABRICS))
def test_port_routes_as_the_plain_ugal_reference(monkeypatch, name, kind):
    spec = FABRICS[name]
    fab, pairs, util, routes, inter = _route(monkeypatch, spec, kind, BIAS)
    dmin = _costs(fab, util, len(pairs))
    counts, load, seen = reference_ugal.judge(fab, routes, pairs, dmin, K, BIAS)
    print(f"{name} {kind}: {seen}")
    assert counts == {k: 0 for k in reference_ugal.LIMITS}
    assert load == routes.max_congestion > 0
    # every sub-flow with members is judged (the deal may leave one empty)
    fid = np.unique(routes.pair_sub)
    assert seen["subflows"] == len(fid)
    # the intermediates, sub-flow by sub-flow, outside near-ties
    v = len(fab.dpids)
    key = np.full(routes.n_subflows, -1, np.int64)
    key[routes.pair_sub] = pairs.key
    dec = reference_ugal.Decision(dmin, fid, key[fid] // v, key[fid] % v, K, BIAS)
    other = (dec.good & (dec.cand != dec.inter[:, None])).any(axis=1) & (dec.inter >= 0)
    exact = ~dec.near & ~other
    print(f"{name} {kind}: {int((~exact).sum())} of {len(exact)} sub-flows near a tie "
          "(of the decision, or of another candidate with the best)")
    np.testing.assert_array_equal(inter[fid][exact], dec.inter[exact])
    assert routes.n_detours == seen["detour_pairs"]
    if kind == "skew":
        assert routes.n_detours > 0 and (inter >= 0).any()


@pytest.mark.parametrize("name", sorted(FABRICS))
def test_a_program_that_never_detours_breaks_the_choice_check(monkeypatch, name):
    """The control: bias 1e9 routes every sub-flow minimally; the
    reference, deciding with the configuration's bias 1, finds detours
    not taken, while every other guarantee holds."""
    spec = FABRICS[name]
    fab, pairs, util, routes, inter = _route(monkeypatch, spec, "skew", 1e9)
    assert (inter == -1).all() and routes.n_detours == 0
    counts, _, _ = reference_ugal.judge(fab, routes, pairs, _costs(fab, util, len(pairs)),
                                        K, BIAS)
    assert counts["ugal_choice_errors"] > 0
    assert {k: v for k, v in counts.items() if k != "ugal_choice_errors"} == {
        k: 0 for k in reference_ugal.LIMITS if k != "ugal_choice_errors"}

"""The port's collective slice end to end against the JAX package, on
the CPU: ``TopologyDB.find_routes_collective`` (torch backend,
``device="cpu"``) against ``sdnmpi_tpu``'s ``TopologyDB(backend="jax")``
on the same fabric (carried across with ``topology_from_dict``), and
``route_collective`` with and without cached distances and a destination
set.

Host-side results (pair grouping, sub-flow deal, final ports, hop
counts) must agree exactly. Routed hops follow the near-tie rule of
``test_torch_kernels``: a sub-flow's route must equal the reference's
unless the reference's own sampling met a near-tie on it, in which case
it must be a valid shortest route; the near-tie count is reported. The
fractional max congestion agrees to rtol 1e-5 (f32 sums in another
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnmpi_tpu.oracle import dag as jdag
from sdnmpi_tpu.oracle.apsp import apsp_distances as j_apsp
from sdnmpi_tpu.oracle.congestion import aggregate_pairs as j_aggregate
from sdnmpi_tpu import topogen as j_topogen
from sdnmpi_tpu.collectives import patterns as j_patterns
from sdnmpi_tpu.protocol import vmac as j_vmac
from sdnmpi_tpu.oracle.engine import tensorize as j_tensorize
from sdnmpi_tpu.topogen import fattree as j_fattree
from sdnmpi_tpu.topogen import random_regular as j_random_regular
from sdnmpi_tpu_torch import topogen as p_topogen
from sdnmpi_tpu_torch.collectives import alltoall_pairs
from sdnmpi_tpu_torch.collectives import patterns as p_patterns
from sdnmpi_tpu_torch.protocol import vmac as p_vmac
from sdnmpi_tpu_torch.convert import topology_from_dict
from sdnmpi_tpu_torch.core.topology_db import Link, Port, TopologyDB
from sdnmpi_tpu_torch.oracle import dag
from tests.test_torch_kernels import _jax_lw, assert_slots_match, near_ties


def t_(x):
    return torch.tensor(np.asarray(x))


def _spec(name: str):
    return {
        "fattree4": lambda: j_fattree(4),
        "fattree6": lambda: j_fattree(6),
        "random40": lambda: j_random_regular(40, 4, hosts_per_switch=1, seed=3),
    }[name]()


def _reference_ties(captured):
    """First near-tie hop of every sub-flow the port's route_collective
    call routed, judged on the reference's own sampling of the same
    inputs (JAX balance_rounds + sample_paths_dense)."""
    a = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in captured.items()}
    v = a["adj"].shape[0]
    base = np.zeros((v, v), np.float32)
    base[a["link_src"], a["link_dst"]] = a["link_util"]
    dn = None if a["dst_nodes"] is None else jnp.asarray(a["dst_nodes"])
    w, _, maxc = jdag.balance_rounds(
        jnp.asarray(a["adj"]), jnp.asarray(a["dist"]), jnp.asarray(base),
        jnp.asarray(a["traffic"]), levels=a["levels"], rounds=a["rounds"],
        dst_nodes=dn,
    )
    hops = jdag.sampled_hops(a["max_len"])
    ref_nodes, ref_slots = jdag.sample_paths_dense(
        w, jnp.asarray(a["dist"]), jnp.asarray(a["src"]), jnp.asarray(a["dst"]),
        hops, dst_nodes=dn,
    )
    first, scored = near_ties(
        _jax_lw(w), a["dist"], a["src"], a["dst"], np.asarray(ref_nodes), hops, 0
    )
    return first < hops, scored, float(maxc)


@pytest.mark.parametrize("name,n_hosts,util", [
    ("fattree4", 16, False), ("fattree6", 54, True), ("random40", 40, True),
])
def test_find_routes_collective_matches_jax(monkeypatch, name, n_hosts, util):
    spec = _spec(name)
    jdb = spec.to_topology_db(backend="jax")
    pdb = topology_from_dict(jdb.to_dict(), device="cpu")
    macs = [m for m, _, _ in spec.hosts[:n_hosts]]
    pairs = alltoall_pairs(len(macs))
    kwargs = {}
    if util:
        rng = np.random.default_rng(4)
        kwargs["link_util"] = {
            (a, pa): float(rng.random() * 5e9) for a, pa, _, _ in spec.links
        }

    captured = {}
    real = dag.route_collective

    def spy(adj, link_src, link_dst, link_util, traffic, src, dst, **kw):
        captured.update(
            adj=adj, link_src=link_src, link_dst=link_dst, link_util=link_util,
            traffic=traffic, src=src, dst=dst, **kw,
        )
        return real(adj, link_src, link_dst, link_util, traffic, src, dst, **kw)

    monkeypatch.setattr(dag, "route_collective", spy)
    ref = jdb.find_routes_collective(macs, pairs[:, 0], pairs[:, 1], "balanced", **kwargs)
    got = pdb.find_routes_collective(macs, pairs[:, 0], pairs[:, 1], "balanced", **kwargs)

    for field in ("pair_sub", "final_port", "hop_len", "endpoint_port"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field), field)
    tied, scored, maxc = _reference_ties(captured)
    tied = tied[: got.n_subflows]
    same = ~tied
    np.testing.assert_array_equal(got.hop_dpid[same], ref.hop_dpid[same])
    np.testing.assert_array_equal(got.hop_port[same], ref.hop_port[same])
    n_ties = int(tied.sum())
    assert n_ties <= 1e-3 * scored, (n_ties, scored)
    print(f"near-ties: {n_ties} sub-flows of {scored} scored decisions")
    assert (got.routed_mask() == ref.routed_mask()).all()
    if not tied.any():
        assert got.max_congestion == ref.max_congestion
    oracle = pdb._oracle_engine()
    np.testing.assert_allclose(oracle.last_fractional_congestion, maxc, rtol=1e-5)
    np.testing.assert_allclose(
        oracle.last_fractional_congestion,
        jdb._jax_oracle().last_fractional_congestion, rtol=1e-5,
    )


def _program(k: int):
    """A bench-config-4-shaped problem at small scale: fattree(k)
    alltoall aggregated to edge-switch pairs."""
    spec = j_fattree(k)
    t = j_tensorize(spec.to_topology_db(backend="jax"), pad_multiple=128)
    host_edge = np.array([t.index[d] for _, d, _ in spec.hosts], np.int32)
    n = len(host_edge)
    src_sw, dst_sw = np.repeat(host_edge, n), np.tile(host_edge, n)
    keep = src_sw != dst_sw
    usrc, udst, weight = j_aggregate(src_sw[keep], dst_sw[keep])
    v = t.adj.shape[0]
    adj = np.asarray(t.adj)
    li, lj = np.nonzero(adj > 0)
    traffic = np.zeros((v, v), np.float32)
    traffic[udst, usrc] = weight
    dist = np.asarray(j_apsp(t.adj))
    levels = int(dist[np.isfinite(dist)].max())
    util = (np.random.default_rng(2).random(len(li)) * 0.1).astype(np.float32)
    return dict(
        adj=adj, li=li.astype(np.int32), lj=lj.astype(np.int32), util=util,
        traffic=traffic, src=usrc, dst=udst, dist=dist, levels=levels,
        dst_nodes=jdag.make_dst_nodes(udst),
    )


@pytest.fixture(scope="module")
def program():
    return _program(6)


@pytest.mark.parametrize("cached,restrict", [(True, True), (False, False)])
def test_route_collective_matches_jax(program, cached, restrict):
    p = program
    kw = dict(levels=p["levels"], rounds=2, max_len=p["levels"] + 1, salt=3)
    dist = p["dist"] if cached else None
    dn = p["dst_nodes"] if restrict else None
    buf = jdag.route_collective(
        jnp.asarray(p["adj"]), jnp.asarray(p["li"]), jnp.asarray(p["lj"]),
        jnp.asarray(p["util"]), jnp.asarray(p["traffic"]), jnp.asarray(p["src"]),
        jnp.asarray(p["dst"]), dist=None if dist is None else jnp.asarray(dist),
        dst_nodes=None if dn is None else jnp.asarray(dn), max_degree=8, **kw,
    )
    ref_slots, ref_maxc = jdag.unpack_result(buf, len(p["src"]), kw["max_len"])
    slots, maxc = dag.route_collective(
        t_(p["adj"]), t_(p["li"]), t_(p["lj"]), t_(p["util"]), t_(p["traffic"]),
        t_(p["src"]), t_(p["dst"]), dist=None if dist is None else t_(dist),
        dst_nodes=None if dn is None else t_(dn), **kw,
    )
    np.testing.assert_allclose(float(maxc), ref_maxc, rtol=1e-5)
    # the reference's sampling inputs, for the near-tie rule
    v = p["adj"].shape[0]
    base = np.zeros((v, v), np.float32)
    base[p["li"], p["lj"]] = p["util"]
    w, _, _ = jdag.balance_rounds(
        jnp.asarray(p["adj"]), jnp.asarray(p["dist"]), jnp.asarray(base),
        jnp.asarray(p["traffic"]), levels=p["levels"], rounds=2,
    )
    hops = jdag.sampled_hops(kw["max_len"])
    ref_nodes, _ = jdag.sample_paths_dense(
        w, jnp.asarray(p["dist"]), jnp.asarray(p["src"]), jnp.asarray(p["dst"]),
        hops, salt=3,
    )
    first, scored = near_ties(
        _jax_lw(w), p["dist"], p["src"], p["dst"], np.asarray(ref_nodes), hops, 3
    )
    assert scored > 0
    assert_slots_match(
        slots.numpy(), ref_slots, first, p["adj"], p["src"], p["dst"], p["dist"],
        scored,
    )


def test_route_collective_layouts_identical(program):
    """Cached or BFS distances, full or restricted destination axis: the
    port routes the same slots in all four combinations."""
    p = program
    kw = dict(levels=p["levels"], rounds=2, max_len=p["levels"] + 1)
    outs = []
    for dist in (t_(p["dist"]), None):
        for dn in (t_(p["dst_nodes"]), None):
            outs.append(dag.route_collective(
                t_(p["adj"]), t_(p["li"]), t_(p["lj"]), t_(p["util"]),
                t_(p["traffic"]), t_(p["src"]), t_(p["dst"]), dist=dist,
                dst_nodes=dn, **kw,
            ))
    for slots, maxc in outs[1:]:
        torch.testing.assert_close(slots, outs[0][0], rtol=0, atol=0)
        np.testing.assert_allclose(float(maxc), float(outs[0][1]), rtol=1e-6)


def test_single_routes_and_mutation_match():
    """find_route through the torch oracle's next hops, the pure-Python
    backend, and the JAX oracle agree, also after a link goes down (which
    both oracles absorb by the in-place repair, not a full refresh)."""
    spec = j_random_regular(24, 3, seed=5)
    jdb = spec.to_topology_db(backend="jax")
    d = jdb.to_dict()
    pdb = topology_from_dict(d, device="cpu")
    ydb = topology_from_dict(d, backend="py")
    macs = [m for m, _, _ in spec.hosts]
    pairs = [(macs[i], macs[j]) for i in range(0, 24, 3) for j in range(1, 24, 4)]
    for s, t in pairs:
        ref = jdb.find_route(s, t)
        assert pdb.find_route(s, t) == ref and ydb.find_route(s, t) == ref
    a, pa, b, pb = spec.links[0]
    from sdnmpi_tpu.core.topology_db import Link as JLink, Port as JPort

    jdb.delete_link(JLink(JPort(a, pa), JPort(b, pb)))
    pdb.delete_link(Link(Port(a, pa), Port(b, pb)))
    ydb.delete_link(Link(Port(a, pa), Port(b, pb)))
    for s, t in pairs:
        ref = jdb.find_route(s, t)
        assert pdb.find_route(s, t) == ref and ydb.find_route(s, t) == ref
    p_oracle, j_oracle = pdb._oracle_engine(), jdb._jax_oracle()
    assert (p_oracle.full_refresh_count, p_oracle.repair_count) == (1, 1)
    assert (j_oracle.full_refresh_count, j_oracle.repair_count) == (1, 1)
    # the py backends of both packages route whole collectives alike
    jpy = spec.to_topology_db(backend="py")
    got = ydb.find_routes_collective(macs[:6], [0, 1, 2], [3, 4, 5])
    jpy.delete_link(JLink(JPort(a, pa), JPort(b, pb)))
    ref = jpy.find_routes_collective(macs[:6], [0, 1, 2], [3, 4, 5])
    np.testing.assert_array_equal(got.hop_dpid, ref.hop_dpid)
    assert got.max_congestion == ref.max_congestion


def test_unported_surface_raises():
    d = j_fattree(4).to_topology_db(backend="jax").to_dict()
    pdb = topology_from_dict(d, device="cpu", mesh_devices=2)
    macs = list(pdb.hosts)[:4]
    # the phased and delta legs work (tests/test_torch_{sched,delta_reval}.py);
    # on a shard mesh they still reach the sharded legs that do not
    with pytest.raises(NotImplementedError, match="A12 item 3"):
        pdb.find_routes_collective(macs, [0], [1], policy="adaptive", schedule=2)
    with pytest.raises(NotImplementedError, match="A12 item 3"):
        pdb.find_routes_collective_phased(macs, [0], [1], policy="adaptive")
    sdb = topology_from_dict(d, device="cpu", mesh_devices=2, shard_oracle=True)
    # past the host chase's hop budget: the device chase of row-sharded
    # next hops
    big = [(a, b) for a in sdb.hosts for b in sdb.hosts if a != b] * 3
    with pytest.raises(NotImplementedError, match="A12 item 3"):
        sdb.find_routes_batch_delta_dispatch(big, [1])
    with pytest.raises(NotImplementedError, match="A12 item 3"):
        TopologyDB(device="cpu", mesh_devices=2, shard_oracle=True).warm_serving()


@pytest.mark.parametrize("name,args", [
    ("fattree", (4,)), ("fattree", (6, 2, 3)), ("linear", (5, 2)), ("ring", (6,)),
    ("torus2d", (3, 4)), ("random_regular", (20, 3, 1, 7)), ("torus", ((3, 2, 2),)),
    ("torus2d", (1, 5)), ("ring", (3, 2)),
])
def test_topogen_matches_jax(name, args):
    """Each port generator emits the reference's switches, links, hosts
    and pod map, and materializes the same TopologyDB snapshot."""
    ref = getattr(j_topogen, name)(*args)
    got = getattr(p_topogen, name)(*args)
    assert (got.name, got.switches, got.links, got.hosts) == (
        ref.name, ref.switches, ref.links, ref.hosts
    )
    assert (got.podmap is None) == (ref.podmap is None)
    if ref.podmap is not None:
        assert got.podmap.to_dict() == ref.podmap.to_dict()
    pdb = got.to_topology_db(backend="py")
    assert pdb.to_dict() == ref.to_topology_db(backend="py").to_dict()


@pytest.mark.parametrize("coll", sorted(p_patterns._GENERATORS))
def test_collective_pairs_match_jax(coll):
    """Each collective's rank pairs (and their rounds, where the pattern
    has them) and their vMAC keys, as the reference generates them."""
    for n in (1, 6, 8):
        got = p_patterns.collective_pairs(coll, n)
        np.testing.assert_array_equal(got, j_patterns.collective_pairs(coll, n))
        np.testing.assert_array_equal(
            p_vmac.encode_batch_ints(coll, got[:, 0], got[:, 1]),
            j_vmac.encode_batch_ints(coll, got[:, 0], got[:, 1]),
        )
        for s, d in got[:3]:
            mac = p_vmac.VirtualMac(coll, int(s), int(d)).encode()
            assert mac == j_vmac.VirtualMac(coll, int(s), int(d)).encode()
            assert p_vmac.VirtualMac.decode(mac) == p_vmac.VirtualMac(coll, int(s), int(d))
    for name in ("bcast_binomial_pairs", "allreduce_recursive_doubling_pairs",
                 "barrier_dissemination_pairs"):
        for a, b in zip(getattr(p_patterns, name)(8, with_rounds=True),
                        getattr(j_patterns, name)(8, with_rounds=True)):
            np.testing.assert_array_equal(a, b)

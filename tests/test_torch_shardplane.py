"""The port's sharded oracle against the JAX package's shardplane, on the
CPU: the reference on its 8-device virtual mesh, the port on
``make_mesh(8, device="cpu")``, both fed the same fabrics (fat-tree k=4,
linear, torus, as in ``tests/test_shardplane.py``) and the same numpy
inputs.

Sharded distances and next hops (gather and ring modes, with and
without the occupied-column bucket) must be bit-equal to the
reference's. The sharded collective follows the near-tie rule of
``test_torch_kernels``: slots exact up to a flow's first decision whose
float64 reference margin is below 4e-6, a valid shortest path after it,
near-ties at most 0.1% of scored decisions; the fractional max
congestion agrees to rtol 1e-5 (f32 sums in another order).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnmpi_tpu import shardplane as jshard
from sdnmpi_tpu.oracle import dag as jdag
from sdnmpi_tpu.oracle.apsp import apsp_distances as j_apsp
from sdnmpi_tpu.oracle.apsp import occ_bucket
from sdnmpi_tpu.oracle.engine import tensorize as j_tensorize
from sdnmpi_tpu.topogen import fattree, linear, torus
from sdnmpi_tpu_torch import shardplane as pshard
from sdnmpi_tpu_torch.convert import gather_rows, shard_rows, topology_from_dict
from sdnmpi_tpu_torch.kernels import sampler
from sdnmpi_tpu_torch.oracle import dag
from sdnmpi_tpu_torch.topogen import fattree as p_fattree
from tests.conftest import N_VIRTUAL_DEVICES
from tests.test_torch_kernels import (  # noqa: F401  (sampler_problem: fixture)
    _jax_lw,
    assert_slots_match,
    near_ties,
    sampler_problem,
)
from tests.test_torch_slice import _reference_ties

TOPOS = {
    "linear": lambda: linear(10, hosts_per_switch=2),
    "fattree": lambda: fattree(4),
    "torus": lambda: torus((2, 2, 2), hosts_per_switch=2),
}


def t_(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def p_mesh():
    return pshard.make_mesh(N_VIRTUAL_DEVICES, device="cpu")


def _tensors(spec, pad: int = 8):
    return j_tensorize(spec.to_topology_db(backend="jax", pad_multiple=pad), pad)


# -- APSP -----------------------------------------------------------------


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_sharded_apsp_bit_identical(topo, virtual_mesh, p_mesh):
    """Row-sharded and "v"-axis distances, and next hops in gather and
    ring modes, equal the reference's sharded results."""
    t = _tensors(TOPOS[topo]())
    adj = t_(t.adj)
    j_dist = jshard.apsp_distances_rowsharded(t.adj, virtual_mesh)
    dist = pshard.apsp_distances_rowsharded(adj, p_mesh)
    assert len(dist) == N_VIRTUAL_DEVICES
    np.testing.assert_array_equal(gather_rows(dist), np.asarray(j_dist))
    np.testing.assert_array_equal(
        gather_rows(pshard.apsp_distances_sharded(adj, p_mesh)),
        np.asarray(jshard.apsp_distances_sharded(t.adj, virtual_mesh)),
    )
    want = np.asarray(jshard.apsp_next_hops_rowsharded(
        t.adj, j_dist, virtual_mesh, t.max_degree
    ))
    np.testing.assert_array_equal(
        np.asarray(jshard.apsp_next_hops_ringed(t.adj, j_dist, virtual_mesh, t.max_degree)),
        want,
    )
    for fn in (pshard.apsp_next_hops_rowsharded, pshard.apsp_next_hops_ringed):
        got = fn(adj, dist, p_mesh, t.max_degree)
        np.testing.assert_array_equal(gather_rows(got), want, fn.__name__)


def test_next_hops_occupancy_bit_identical(virtual_mesh, p_mesh):
    """The occupied-column bucket in both modes: equal to the
    reference's bucketed and full-width results."""
    t = _tensors(fattree(4), pad=64)
    v = t.adj.shape[0]
    b = occ_bucket(t.n_real, v, math.lcm(8, N_VIRTUAL_DEVICES))
    assert t.n_real <= b < v
    j_dist = jshard.apsp_distances_rowsharded(t.adj, virtual_mesh)
    want = np.asarray(jshard.apsp_next_hops_ringed(
        t.adj, j_dist, virtual_mesh, t.max_degree, n_occ=b
    ))
    adj = t_(t.adj)
    dist = pshard.apsp_distances_rowsharded(adj, p_mesh)
    full = gather_rows(pshard.apsp_next_hops_rowsharded(adj, dist, p_mesh, t.max_degree))
    np.testing.assert_array_equal(full, want)
    for fn in (pshard.apsp_next_hops_rowsharded, pshard.apsp_next_hops_ringed):
        got = fn(adj, dist, p_mesh, t.max_degree, n_occ=b)
        np.testing.assert_array_equal(gather_rows(got), want, fn.__name__)


# -- the sharded collective -------------------------------------------------


@pytest.fixture(scope="module")
def collective():
    """Alltoall over fat-tree k=4's hosts, aggregated to edge-switch
    pairs and end-padded to the shard count; an idle fabric (config 13's
    case)."""
    spec = fattree(4)
    t = _tensors(spec)
    host_edge = np.array([t.index[d] for _, d, _ in spec.hosts], np.int32)
    edges, counts = np.unique(host_edge, return_counts=True)
    ga, gb = np.meshgrid(edges, edges, indexing="ij")
    wa, wb = np.meshgrid(counts, counts, indexing="ij")
    off = ga != gb
    src, dst = ga[off].astype(np.int32), gb[off].astype(np.int32)
    weight = (wa[off] * wb[off]).astype(np.float32)
    pad = (-len(src)) % N_VIRTUAL_DEVICES
    src = np.concatenate([src, np.full(pad, -1, np.int32)])
    dst = np.concatenate([dst, np.full(pad, -1, np.int32)])
    v = t.adj.shape[0]
    adj = np.asarray(t.adj)
    li, lj = (a.astype(np.int32) for a in np.nonzero(adj > 0))
    traffic = np.zeros((v, v), np.float32)
    live = src >= 0
    np.add.at(traffic, (dst[live], src[live]), weight[: live.sum()])
    dist = np.asarray(j_apsp(t.adj))
    levels = int(dist[np.isfinite(dist)].max())
    return dict(
        adj=adj, li=li, lj=lj, util=np.zeros(len(li), np.float32),
        traffic=traffic, src=src, dst=dst, dist=dist, levels=levels,
        dst_nodes=jdag.make_dst_nodes(dst[live]),
    )


@pytest.mark.parametrize("ring,cached,restrict", [
    (False, True, True), (False, False, False), (True, True, False),
    (True, False, True),
])
def test_route_collective_sharded_matches_jax(
    collective, ring, cached, restrict, virtual_mesh, p_mesh
):
    """Both modes, with and without cached distances and a destination
    set: the reference's sharded slots under the near-tie rule, its
    fractional congestion to rtol 1e-5; and, on this idle fabric, the
    port's single-device route_collective's slots exactly."""
    p = collective
    kw = dict(levels=p["levels"], rounds=2, max_len=p["levels"] + 1, salt=3)
    dn = p["dst_nodes"] if restrict else None
    j_slots, j_maxc = jshard.route_collective_sharded(
        jnp.asarray(p["adj"]), jnp.asarray(p["li"]), jnp.asarray(p["lj"]),
        jnp.asarray(p["util"]), jnp.asarray(p["traffic"]), jnp.asarray(p["src"]),
        jnp.asarray(p["dst"]), virtual_mesh,
        dist=jnp.asarray(p["dist"]) if cached else None,
        dst_nodes=None if dn is None else jnp.asarray(dn), ring_exchange=ring, **kw,
    )
    if cached:  # the engine's row-sharded form in ring mode, replicated else
        dist = shard_rows(p["dist"], p_mesh) if ring else t_(p["dist"])
    else:
        dist = None
    args = [t_(p[k]) for k in ("adj", "li", "lj", "util", "traffic", "src", "dst")]
    slots, maxc = pshard.route_collective_sharded(
        *args, p_mesh, dist=dist, dst_nodes=None if dn is None else t_(dn),
        ring_exchange=ring, **kw,
    )
    assert len(slots) == N_VIRTUAL_DEVICES
    got = gather_rows(slots)
    np.testing.assert_allclose(float(maxc), float(j_maxc), rtol=1e-5)
    # the reference's sampling inputs (one device; every flow's global id)
    v = p["adj"].shape[0]
    w, _, _ = jdag.balance_rounds(
        jnp.asarray(p["adj"]), jnp.asarray(p["dist"]), jnp.zeros((v, v)),
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
        got, np.asarray(j_slots), first, p["adj"], p["src"], p["dst"], p["dist"],
        scored,
    )
    single, single_maxc = dag.route_collective(
        *args, dist=t_(p["dist"]), dst_nodes=None if dn is None else t_(dn), **kw,
    )
    np.testing.assert_array_equal(got, single.numpy())
    np.testing.assert_allclose(float(maxc), float(single_maxc), rtol=1e-6)


@pytest.mark.parametrize("topo,util", [("fattree", False), ("torus", True)])
def test_sharded_find_routes_collective_matches_jax(monkeypatch, topo, util):
    """TopologyDB(mesh_devices=8, shard_oracle, ring_exchange) in both
    packages on the same fabric: same grouping, final ports and hop
    counts; routes under the near-tie rule; congestion to rtol 1e-5."""
    spec = TOPOS[topo]()
    flags = dict(mesh_devices=N_VIRTUAL_DEVICES, shard_oracle=True,
                 ring_exchange=True)
    jdb = spec.to_topology_db(backend="jax", **flags)
    pdb = topology_from_dict(jdb.to_dict(), device="cpu", **flags)
    macs = [m for m, _, _ in spec.hosts]
    n = len(macs)
    src_idx = np.repeat(np.arange(n), n).astype(np.int32)
    dst_idx = np.tile(np.arange(n), n).astype(np.int32)
    keep = src_idx != dst_idx
    src_idx, dst_idx = src_idx[keep], dst_idx[keep]
    kwargs = {}
    if util:
        rng = np.random.default_rng(4)
        kwargs["link_util"] = {
            (a, pa): float(rng.random() * 5e9) for a, pa, _, _ in spec.links
        }
    captured = {}
    real = pshard.route_collective_sharded

    def spy(adj, link_src, link_dst, link_util, traffic, src, dst, mesh, **kw):
        d = kw["dist"]
        captured.update(
            adj=adj, link_src=link_src, link_dst=link_dst, link_util=link_util,
            traffic=traffic, src=src, dst=dst, levels=kw["levels"],
            rounds=kw["rounds"], max_len=kw["max_len"], dst_nodes=kw["dst_nodes"],
            dist=gather_rows(d) if isinstance(d, list) else d,
        )
        return real(adj, link_src, link_dst, link_util, traffic, src, dst, mesh, **kw)

    monkeypatch.setattr(pshard, "route_collective_sharded", spy)
    ref = jdb.find_routes_collective(macs, src_idx, dst_idx, "balanced", **kwargs)
    got = pdb.find_routes_collective(macs, src_idx, dst_idx, "balanced", **kwargs)
    oracle = pdb._oracle_engine()
    assert oracle.ring_exchange and isinstance(oracle._dist_d, list)
    for field in ("pair_sub", "final_port", "hop_len", "endpoint_port"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field), field)
    tied, scored, maxc = _reference_ties(captured)
    tied = tied[: got.n_subflows]
    np.testing.assert_array_equal(got.hop_dpid[~tied], ref.hop_dpid[~tied])
    np.testing.assert_array_equal(got.hop_port[~tied], ref.hop_port[~tied])
    assert int(tied.sum()) <= 1e-3 * scored, (int(tied.sum()), scored)
    np.testing.assert_allclose(oracle.last_fractional_congestion, maxc, rtol=1e-5)
    np.testing.assert_allclose(
        oracle.last_fractional_congestion,
        jdb._jax_oracle().last_fractional_congestion, rtol=1e-5,
    )
    # the sharded refresh's host twins are the reference's matrices
    jo = jdb._jax_oracle()
    np.testing.assert_array_equal(oracle._dist, np.asarray(jo._dist))
    np.testing.assert_array_equal(oracle._next, np.asarray(jo._next))


def test_oracle_mesh_rules():
    """The reference's flag rules, without its fallback to one device:
    shard_oracle needs a mesh, ring_exchange needs shard_oracle (the
    hierarchical oracle's ring needs only the mesh), the pad multiple
    covers the shard count, and a mesh that cannot be built raises."""
    from sdnmpi_tpu_torch.core.topology_db import TopologyDB
    from sdnmpi_tpu_torch.oracle.engine import RouteOracle

    o = RouteOracle(shard_oracle=True, ring_exchange=True, device="cpu")
    assert not o.shard_oracle and not o.ring_exchange and o._shard_mesh() is None
    o = RouteOracle(mesh_devices=3, ring_exchange=True, device="cpu")
    assert o._dag_mesh().n_shards == 3 and o.pad_multiple == 24
    assert not o.ring_exchange and o._shard_mesh() is None
    o = RouteOracle(mesh_devices=8, shard_oracle=True, ring_exchange=True,
                    device="cpu")
    assert o.ring_exchange and o._shard_mesh() is o._dag_mesh()
    with pytest.raises(ValueError):
        RouteOracle(mesh_devices=1000, device="cpu")
    from sdnmpi_tpu_torch.oracle.hier import HierOracle

    # the hierarchical oracle takes the mesh and the ring flag itself:
    # its pod blocks and border rows shard, the dense refresh stays off
    o = TopologyDB(device="cpu", hier_oracle=True, mesh_devices=8,
                   ring_exchange=True)._oracle_engine()
    assert isinstance(o, HierOracle) and o.hier_ring and not o.shard_oracle
    assert o._dag_mesh().n_shards == 8
    o = TopologyDB(device="cpu", hier_oracle=True, ring_exchange=True)._oracle_engine()
    assert isinstance(o, HierOracle) and not o.hier_ring and o._dag_mesh() is None
    db = TopologyDB(device="cpu", mesh_devices=4, shard_oracle=True)
    assert db._oracle_engine().mesh_devices == 4
    # the flow-sharded legs take batches that divide by the shard count
    with pytest.raises(ValueError, match="divide"):
        pshard.route_flows_sharded(
            torch.zeros(8, 8), torch.zeros(8, 8), torch.zeros(8, 8),
            torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
            torch.ones(3), db._oracle_engine()._dag_mesh(), 4)


@pytest.mark.parametrize("mode", ["mesh", "shard"])
def test_mesh_only_and_gather_refresh_match(mode):
    """The mesh-only refresh (v-axis BFS, next hops on one device) and
    the gather-mode shardplane refresh give the single-device matrices
    and routes."""
    spec = p_fattree(4)
    macs = [m for m, _, _ in spec.hosts[:8]]
    src_idx = np.repeat(np.arange(8), 8).astype(np.int32)
    dst_idx = np.tile(np.arange(8), 8).astype(np.int32)
    flags = {"mesh_devices": N_VIRTUAL_DEVICES, "shard_oracle": mode == "shard"}
    out = {}
    for name, kw in (("single", {}), (mode, flags)):
        pdb = spec.to_topology_db(device="cpu", **kw)
        out[name] = (pdb.find_routes_collective(macs, src_idx, dst_idx),
                     pdb._oracle_engine())
    (a, oa), (b, ob) = out["single"], out[mode]
    np.testing.assert_array_equal(oa._dist, ob._dist)
    np.testing.assert_array_equal(oa._next, ob._next)
    np.testing.assert_array_equal(a.hop_dpid, b.hop_dpid)
    assert a.max_congestion == b.max_congestion


@pytest.mark.parametrize("ring_exchange", [True, False])
def test_sharded_occupancy_bucket_dispatch(ring_exchange):
    """A padded fabric routes on its occupied block: the sharded
    dispatch cuts the occupied rows from the distances gathered once per
    topology version and routes as the single-device oracle does."""
    spec = p_fattree(4)
    macs = [m for m, _, _ in spec.hosts[:8]]
    src_idx = np.repeat(np.arange(8), 8).astype(np.int32)
    dst_idx = np.tile(np.arange(8), 8).astype(np.int32)
    single = spec.to_topology_db(device="cpu", pad_multiple=256)
    sharded = spec.to_topology_db(
        device="cpu", pad_multiple=256, mesh_devices=N_VIRTUAL_DEVICES,
        shard_oracle=True, ring_exchange=ring_exchange,
    )
    ref = single.find_routes_collective(macs, src_idx, dst_idx)
    got = sharded.find_routes_collective(macs, src_idx, dst_idx)
    oracle = sharded._oracle_engine()
    t = oracle.refresh(sharded)
    assert oracle._occ_v(t) == 128 < t.v == 256
    gathered = oracle._dist_full_d
    assert gathered is not None
    np.testing.assert_array_equal(gathered.numpy(), single._oracle_engine()._dist)
    for field in ("pair_sub", "hop_dpid", "hop_port", "hop_len"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))
    assert got.max_congestion == ref.max_congestion
    sharded.find_routes_collective(macs, src_idx, dst_idx)
    assert oracle._dist_full_d is gathered  # one gather per version


# -- K2 with a flow-id base -------------------------------------------------


@pytest.mark.parametrize("fid_base", [37, 0xFFFFFF00])  # the second wraps
def test_sampler_fid_base_matches_jax(sampler_problem, fid_base):  # noqa: F811
    """The plain sampler with fid_base != 0 against the reference's
    sample_paths_dense(fid_base=), fed the reference's bf16 log weights,
    under the near-tie rule; the CPU wrapper passes fid_base through."""
    p = sampler_problem
    lw = _jax_lw(p["weights"])
    hops = 3
    ref_nodes, ref_slots = jdag.sample_paths_dense(
        jnp.asarray(p["weights"]), jnp.asarray(p["dist"]), jnp.asarray(p["src"]),
        jnp.asarray(p["dst"]), hops, salt=2, fid_base=jnp.uint32(fid_base),
    )
    _, got = sampler.sample_paths_lw(
        t_(lw).to(torch.bfloat16), t_(p["dist"]), t_(p["src"]), t_(p["dst"]), hops,
        salt=2, fid_base=fid_base,
    )
    first, scored = near_ties(
        lw, p["dist"], p["src"], p["dst"], np.asarray(ref_nodes), hops, 2,
        fid_base=fid_base,
    )
    assert scored > 0
    assert_slots_match(got.numpy(), np.asarray(ref_slots), first, p["adj"],
                       p["src"], p["dst"], p["dist"], scored)
    args = (t_(p["weights"]), t_(p["dist"]), t_(p["src"]), t_(p["dst"]), hops)
    _, plain = sampler.sample_paths_dense(*args, salt=2, fid_base=fid_base)
    wrapped = sampler.sample_slots(*args, salt=2, fid_base=fid_base)
    torch.testing.assert_close(wrapped, plain, rtol=0, atol=0)
    _, zero = sampler.sample_paths_dense(*args, salt=2)
    assert not torch.equal(plain, zero)  # the base moves the noise

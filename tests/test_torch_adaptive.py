"""The port's UGAL adaptive routing and dragonfly generator against the
JAX package on the CPU.

Tolerances. ``congestion_cost``'s mean and the balancer's float32
products sum in another order than XLA's, so ``congestion_cost``,
``weighted_apsp`` and ``dag_weighted_costs`` are held to rtol 1e-6 and
the balanced load to rtol 1e-5. ``ugal_choose`` on the same costs is
exact. ``route_adaptive``'s intermediates are exact wherever the
reference's decision margin ``|best_cost + bias - c_min|`` exceeds
1e-5 (and, for a detour, the cost gap to the cheapest candidate naming
another intermediate); the sampled slots
follow the near-tie rule of ``test_torch_kernels`` on the reference's own
weights. Near-tie counts are printed. The dragonfly generator, the
stitch and the host decode are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnmpi_tpu.oracle import adaptive as jad
from sdnmpi_tpu.oracle import dag as jdag
from sdnmpi_tpu.oracle.apsp import apsp_distances as j_apsp
from sdnmpi_tpu.oracle.engine import tensorize as j_tensorize
from sdnmpi_tpu import topogen as j_topogen
from sdnmpi_tpu_torch import topogen as p_topogen
from sdnmpi_tpu_torch.oracle import adaptive
from tests.test_torch_kernels import (
    _jax_lw,
    assert_slots_match,
    near_ties,
    np_hash_u32,
)

#: intermediates are held exactly where the reference's margin exceeds this
UGAL_MARGIN = 1e-5


def t_(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def dfly():
    """dragonfly(4, 4, 1, 2): 16 routers, diameter 3, with measured load:
    the direct group 0 -> 1 global links hot, small noise elsewhere."""
    spec = j_topogen.dragonfly(4, 4, 1, 2)
    t = j_tensorize(spec.to_topology_db(backend="jax"))
    adj = np.asarray(t.adj)
    v = adj.shape[0]
    groups = np.arange(v) // 4
    rng = np.random.default_rng(11)
    util = np.where(adj > 0, rng.random(adj.shape) * 3.0, 0.0).astype(np.float32)
    hot = (groups[:, None] == 0) & (groups[None, :] == 1) & (adj > 0)
    util[hot] = 1000.0
    dist = np.asarray(j_apsp(t.adj))
    return {"adj": adj, "util": util, "dist": dist, "n_real": t.n_real, "v": v}


@pytest.mark.parametrize("args", [
    (4, 4, 1, 2), (4, 4), (8, 32, 1, 2), (3, 2, 2, 1), (5, 3, 1, 2), (2, 1, 3, 1),
])
def test_dragonfly_matches_jax(args):
    """Switches, links (with ports), hosts and the pod map equal the
    reference's, and so does the TopologyDB snapshot."""
    ref = j_topogen.dragonfly(*args)
    got = p_topogen.dragonfly(*args)
    assert (got.name, got.switches, got.links, got.hosts) == (
        ref.name, ref.switches, ref.links, ref.hosts
    )
    assert got.podmap.to_dict() == ref.podmap.to_dict()
    assert (got.to_topology_db(backend="py").to_dict()
            == ref.to_topology_db(backend="py").to_dict())


@pytest.mark.parametrize("args", [(1, 4), (5, 1, 1, 1)])
def test_dragonfly_refuses_what_the_reference_refuses(args):
    with pytest.raises(ValueError):
        j_topogen.dragonfly(*args)
    with pytest.raises(ValueError):
        p_topogen.dragonfly(*args)


def test_congestion_cost_matches(dfly):
    for util in (dfly["util"], np.zeros_like(dfly["util"])):
        ref = np.asarray(jad.congestion_cost(jnp.asarray(dfly["adj"]), jnp.asarray(util)))
        got = adaptive.congestion_cost(t_(dfly["adj"]), t_(util)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_array_equal(got, ref)  # idle: exactly hop counts


@pytest.mark.parametrize("max_iters", [0, 2])
def test_weighted_apsp_matches(dfly, max_iters):
    adj = dfly["adj"]
    cost = np.random.default_rng(7).uniform(0.5, 4.0, adj.shape).astype(np.float32)
    ref = jad.weighted_apsp(jnp.asarray(adj), jnp.asarray(cost), max_iters=max_iters,
                            max_degree=adj.shape[0])
    got = adaptive.weighted_apsp(t_(adj), t_(cost), max_iters=max_iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    assert np.isinf(got.numpy()).sum() == np.isinf(np.asarray(ref)).sum()


@pytest.mark.parametrize("levels", [3, 1])
def test_dag_weighted_costs_matches(dfly, levels):
    adj, dist = dfly["adj"], dfly["dist"]
    cost = np.asarray(jad.congestion_cost(jnp.asarray(adj), jnp.asarray(dfly["util"])))
    ref = jad.dag_weighted_costs(jnp.asarray(adj), jnp.asarray(dist), jnp.asarray(cost),
                                 levels=levels, max_degree=adj.shape[0])
    got = adaptive.dag_weighted_costs(t_(adj), t_(dist), t_(cost), levels)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    assert (np.isinf(got.numpy()) == np.isinf(np.asarray(ref))).all()


def _flows(v: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, n).astype(np.int32)
    dst = rng.integers(0, v, n).astype(np.int32)
    src[::13] = -1  # padding rows
    dst[5::13] = -1
    dst[3::11] = src[3::11]  # src == dst
    return src, dst


@pytest.mark.parametrize("n_valid,k,bias,salt,fid_base", [
    (16, 4, 1.0, 0, 0), (16, 8, 0.5, 7, 1000), (3, 4, 0.0, 0xFFFFFFFF + 5, 2**31 - 7),
    (1, 2, 1.0, 3, 0), (0, 4, 1.0, 1, 0),
])
def test_ugal_choose_exact(dfly, n_valid, k, bias, salt, fid_base):
    """The same costs give the same intermediates: padding rows,
    ``fid_base`` (past 2**31), salts wider than 32 bits and
    degenerate candidates (``n_valid`` of 0 to 3: most candidates are an
    endpoint) included."""
    adj, dist = dfly["adj"], dfly["dist"]
    cost = jad.congestion_cost(jnp.asarray(adj), jnp.asarray(dfly["util"]))
    dw = np.asarray(jad.dag_weighted_costs(jnp.asarray(adj), jnp.asarray(dist), cost,
                                           levels=3, max_degree=adj.shape[0]))
    src, dst = _flows(adj.shape[0], 300, seed=k)
    ref = jad.ugal_choose(jnp.asarray(dw), jnp.asarray(src), jnp.asarray(dst),
                          jnp.int32(n_valid), n_candidates=k, bias=bias, salt=salt,
                          fid_base=fid_base)
    got = adaptive.ugal_choose(t_(dw), t_(src), t_(dst), n_valid, n_candidates=k,
                               bias=bias, salt=salt, fid_base=fid_base)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy()[(src < 0) | (dst < 0)] == -1).all()
    if n_valid == 16 and bias < 1.0:
        assert (got.numpy() >= 0).any()  # the hot links make detours win


def _reference_margins(dw, src, dst, n_valid, k, bias, salt):
    """Per flow: whether the reference's UGAL decision is a near-tie, from
    its own costs and a numpy uint32 replay of the candidate hash."""
    f = len(src)
    with np.errstate(over="ignore"):
        fid = np.arange(f, dtype=np.uint32) * np.uint32(2654435761)
        ks = np.arange(k, dtype=np.uint32) * np.uint32(0x85EBCA77)
        r = np_hash_u32(fid[:, None] ^ ks[None, :] ^ np.uint32(salt & 0xFFFFFFFF))
    m = (r % np.uint32(max(n_valid, 1))).astype(np.int64)
    s, t = np.maximum(src, 0), np.maximum(dst, 0)
    c_min = dw[s, t].astype(np.float64)
    c_val = (dw[s[:, None], m] + dw[m, t[:, None]]).astype(np.float64)
    c_val[(m == src[:, None]) | (m == dst[:, None])] = np.inf
    best = np.argmin(c_val, axis=1)
    best_cost = c_val[np.arange(f), best]
    m_best = m[np.arange(f), best]
    # the cheapest candidate naming another intermediate
    other = np.where(m != m_best[:, None], c_val, np.inf).min(axis=1)
    live = (src >= 0) & (dst >= 0) & np.isfinite(best_cost)
    margin = np.abs(best_cost + bias - c_min)
    detour = best_cost + bias < c_min
    return live & ((margin <= UGAL_MARGIN)
                   | (detour & (other - best_cost <= UGAL_MARGIN)))


def _shift_flows(v: int, seed: int):
    """Every router of group g sends to group g + 1 (the adversarial
    pattern), plus random pairs and padding rows."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(16), 4).astype(np.int32)
    dst = (((src // 4 + 1) % 4) * 4 + rng.integers(0, 4, len(src))).astype(np.int32)
    rs, rd = rng.integers(0, 16, 40).astype(np.int32), rng.integers(0, 16, 40).astype(np.int32)
    src = np.concatenate([src, rs, np.full(8, -1, np.int32)])
    dst = np.concatenate([dst, rd, np.full(8, -1, np.int32)])
    return src, dst, np.where(src >= 0, 1.0, 0.0).astype(np.float32)


def reference_adaptive(adj, util, src, dst, w, n_real, dist, levels, rounds, max_len,
                       n_candidates, bias, salt):
    """The reference's packed ``route_adaptive`` on these inputs and its
    near-ties: ``(inter, (slots1, slots2), load, near_ugal [F] bool,
    [(a, b, first tie hop [F], scored) per segment], hops)``, the
    segments' endpoints and near-ties judged on the reference's own
    traffic, weights and sampling (``near_ties``)."""
    kw = dict(levels=levels, rounds=rounds, max_len=max_len,
              n_candidates=n_candidates, bias=bias, salt=salt)
    r_inter, r_s1, r_s2, r_load = (np.asarray(x) for x in jad.route_adaptive(
        jnp.asarray(adj), jnp.asarray(util), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(w), jnp.int32(n_real), dist=jnp.asarray(dist), packed=True,
        max_degree=adj.shape[0], **kw))
    cost = jad.congestion_cost(jnp.asarray(adj), jnp.asarray(util))
    dw = np.asarray(jad.dag_weighted_costs(jnp.asarray(adj), jnp.asarray(dist), cost,
                                           levels=levels, max_degree=adj.shape[0]))
    near = _reference_margins(dw, src, dst, n_real, n_candidates, bias, salt)
    detour = r_inter >= 0
    mid = np.where(detour, r_inter, dst)
    s2, d2 = np.where(detour, mid, -1), np.where(detour, dst, -1)
    v = adj.shape[0]
    traffic = np.zeros((v, v), np.float32)
    live = (src >= 0) & (dst >= 0)
    np.add.at(traffic, (np.maximum(mid, 0), np.maximum(src, 0)), np.where(live, w, 0.0))
    np.add.at(traffic, (np.maximum(d2, 0), np.maximum(s2, 0)),
              np.where(detour & live, w, 0.0))
    weights, _, _ = jdag.balance_rounds(
        jnp.asarray(adj), jnp.asarray(dist), jnp.asarray(util), jnp.asarray(traffic),
        levels=levels, rounds=rounds)
    hops = jdag.sampled_hops(max_len)
    segments = []
    for ref, a, b, sl in ((r_s1, src, mid, salt), (r_s2, s2, d2, salt ^ 0x5BD1E995)):
        a, b = a.astype(np.int32), b.astype(np.int32)
        ref_nodes, ref_slots = jdag.sample_paths_dense(
            weights, jnp.asarray(dist), jnp.asarray(a), jnp.asarray(b), hops, salt=sl)
        np.testing.assert_array_equal(np.asarray(ref_slots), ref)
        first, scored = near_ties(_jax_lw(weights), dist, a, b, np.asarray(ref_nodes),
                                  hops, sl)
        segments.append((a, b, first, scored))
    return r_inter, (r_s1, r_s2), r_load, near, segments, hops


@pytest.mark.parametrize("salt,bias", [(5, 1.0), (0, 0.25)])
def test_route_adaptive_matches_jax(dfly, salt, bias):
    """End to end, packed and unpacked: intermediates exact up to the
    margin rule, both segments' slots under the near-tie rule on the
    reference's weights, the load to rtol 1e-5, and the unpacked nodes
    the host decode of the packed slots."""
    adj, util, dist = dfly["adj"], dfly["util"], dfly["dist"]
    src, dst, w = _shift_flows(dfly["v"], seed=salt)
    kw = dict(levels=4, rounds=2, max_len=8, n_candidates=8, bias=bias, salt=salt)
    pargs = (t_(adj), t_(util), t_(src), t_(dst), t_(w), dfly["n_real"])
    r_inter, r_slots, r_load, near, segments, _ = reference_adaptive(
        adj, util, src, dst, w, dfly["n_real"], dist, **kw)
    inter, s1, s2, load = adaptive.route_adaptive(*pargs, dist=t_(dist), packed=True, **kw)
    inter, s1, s2 = inter.numpy(), s1.numpy(), s2.numpy()
    np.testing.assert_array_equal(inter[~near], r_inter[~near])
    print(f"UGAL near-ties: {int(near.sum())} of {int((src >= 0).sum())} live "
          f"flows, {int((inter != r_inter).sum())} of them decided otherwise")
    assert (r_inter >= 0).any() and (r_inter == -1).any()  # both kinds present
    same = inter == r_inter
    if same.all():
        np.testing.assert_allclose(load.numpy(), r_load, rtol=1e-5, atol=1e-5)
    for got, ref, (a, b, first, scored) in zip((s1, s2), r_slots, segments):
        assert_slots_match(got[same], ref[same], first[same], adj, a[same], b[same],
                           dist, scored)
    live = (src >= 0) & (dst >= 0)

    # unpacked: the host decode of the packed slots, and valid stitched paths
    u_inter, n1, n2, u_load = adaptive.route_adaptive(*pargs, dist=t_(dist), **kw)
    assert np.array_equal(u_inter.numpy(), inter) and torch.equal(u_load, load)
    d1, d2 = adaptive.decode_segments(adj, src, dst, inter, s1, s2, 8)
    np.testing.assert_array_equal(n1.numpy(), d1)
    np.testing.assert_array_equal(n2.numpy(), d2)
    paths = adaptive.stitch_paths(n1.numpy(), n2.numpy(), inter)
    for f in np.nonzero(live)[0]:
        p = paths[f][paths[f] >= 0]
        assert p[0] == src[f] and p[-1] == dst[f], (f, p)
        assert all(adj[x, y] > 0 for x, y in zip(p, p[1:]))
        m = inter[f]
        want = dist[src[f], dst[f]] if m < 0 else dist[src[f], m] + dist[m, dst[f]]
        assert len(p) - 1 == want  # each segment a shortest path


def test_route_adaptive_k1_path_and_forced_minimal(dfly):
    """Without cached distances (kernel K1's plain version on the CPU)
    the program gives the same result; a huge bias keeps every flow
    minimal, in both packages."""
    adj, util, dist = dfly["adj"], dfly["util"], dfly["dist"]
    src, dst, w = _shift_flows(dfly["v"], seed=1)
    pargs = (t_(adj), t_(util), t_(src), t_(dst), t_(w), dfly["n_real"])
    kw = dict(levels=4, max_len=8, n_candidates=8)
    a = adaptive.route_adaptive(*pargs, dist=t_(dist), **kw)
    b = adaptive.route_adaptive(*pargs, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    m = adaptive.route_adaptive(*pargs, bias=1e9, **kw)
    assert (m[0].numpy() == -1).all() and (m[2].numpy() == -1).all()
    ref = jad.route_adaptive(
        jnp.asarray(adj), jnp.asarray(util), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(w), jnp.int32(dfly["n_real"]), bias=1e9, max_degree=16, **kw)
    assert (np.asarray(ref[0]) == -1).all()


def test_stitch_and_decode_match_reference(dfly):
    """``stitch_paths`` and ``decode_segments`` equal the reference's on
    the reference's own segment streams."""
    adj, util, dist = dfly["adj"], dfly["util"], dfly["dist"]
    src, dst, w = _shift_flows(dfly["v"], seed=2)
    inter, s1, s2, _ = (np.asarray(x) for x in jad.route_adaptive(
        jnp.asarray(adj), jnp.asarray(util), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(w), jnp.int32(dfly["n_real"]), levels=4, max_len=8,
        n_candidates=8, bias=0.25, dist=jnp.asarray(dist), packed=True,
        max_degree=16))
    ref = jad.decode_segments(adj, src, dst, inter, s1, s2, 8)
    got = adaptive.decode_segments(adj, src, dst, inter, s1, s2, 8)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(adaptive.stitch_paths(*got, inter),
                                  jad.stitch_paths(*ref, inter))
    n1 = np.array([[0, 1, 2, -1], [0, 3, -1, -1], [5, -1, -1, -1]], np.int32)
    n2 = np.array([[-1, -1, -1, -1], [3, 4, 5, -1], [-1, -1, -1, -1]], np.int32)
    it = np.array([-1, 3, -1], np.int32)
    np.testing.assert_array_equal(adaptive.stitch_paths(n1, n2, it),
                                  jad.stitch_paths(n1, n2, it))
    np.testing.assert_array_equal(
        adaptive.link_loads(adaptive.stitch_paths(n1, n2, it), np.ones(3, np.float32), 8),
        jad.link_loads(jad.stitch_paths(n1, n2, it), np.ones(3, np.float32), 8))

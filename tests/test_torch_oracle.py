"""sdnmpi_tpu_torch's oracle modules against the JAX package, on the CPU.

Same numpy inputs (made from a seed) go through the JAX function and
its port. Distances, next hops, neighbour tables, tensors, slot decodes
and host helpers must agree exactly. The DAG balancer sums f32 products
in another order than XLA, so its weights, load and max congestion agree
to rtol 1e-5 / atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnmpi_tpu.oracle import apsp as japsp
from sdnmpi_tpu.oracle import congestion as jcong
from sdnmpi_tpu.oracle import dag as jdag
from sdnmpi_tpu.oracle.engine import tensorize as j_tensorize
from sdnmpi_tpu.topogen import fattree as j_fattree
from sdnmpi_tpu.topogen import linear as j_linear
from sdnmpi_tpu.topogen import random_regular as j_random_regular
from sdnmpi_tpu_torch import native
from sdnmpi_tpu_torch.convert import tensors_from_numpy, topology_from_dict
from sdnmpi_tpu_torch.oracle import apsp, congestion, dag
from sdnmpi_tpu_torch.oracle.engine import tensorize


def t_(x):
    return torch.tensor(np.asarray(x))


def _fabric(name: str, pad: int = 8):
    spec = {
        "fattree4": lambda: j_fattree(4),
        "fattree6": lambda: j_fattree(6),
        "linear5": lambda: j_linear(5),
        "random40": lambda: j_random_regular(40, 4, seed=2),
    }[name]()
    jdb = spec.to_topology_db(backend="jax")
    return spec, jdb, j_tensorize(jdb, pad_multiple=pad)


FABRICS = ["fattree4", "fattree6", "linear5", "random40"]


@pytest.mark.parametrize("name", FABRICS)
def test_tensorize_matches(name):
    _, jdb, jt = _fabric(name)
    t = tensorize(topology_from_dict(jdb.to_dict(), device="cpu"), 8, "cpu")
    np.testing.assert_array_equal(t.dpids, jt.dpids)
    assert t.index == jt.index and t.n_real == jt.n_real
    assert t.max_degree == jt.max_degree and t.n_links == jt.n_links
    np.testing.assert_array_equal(t.adj.numpy(), np.asarray(jt.adj))
    np.testing.assert_array_equal(t.port.numpy(), np.asarray(jt.port))
    carried = tensors_from_numpy(jt.dpids, np.asarray(jt.adj), np.asarray(jt.port), "cpu")
    np.testing.assert_array_equal(carried.adj.numpy(), t.adj.numpy())
    assert carried.max_degree == t.max_degree


@pytest.mark.parametrize("name,max_diameter,n_occ", [
    ("fattree4", 0, 0), ("fattree6", 0, 0), ("linear5", 2, 0),
    ("random40", 0, 0), ("fattree4", 0, 24),
])
def test_apsp_distances_exact(name, max_diameter, n_occ):
    _, _, jt = _fabric(name, pad=8 if not n_occ else 32)
    adj = np.asarray(jt.adj)
    ref = np.asarray(japsp.apsp_distances(jnp.asarray(adj), max_diameter, n_occ=n_occ))
    got = apsp.apsp_distances(t_(adj), max_diameter, n_occ=n_occ).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name,max_degree,block,n_occ", [
    ("fattree4", 0, 0, 0), ("fattree4", 8, 0, 0), ("fattree6", 16, 4, 0),
    ("random40", 8, 0, 0), ("random40", 0, 10, 0), ("linear5", 8, 0, 0),
    ("fattree4", 8, 0, 24),
])
def test_apsp_next_hops_exact(name, max_degree, block, n_occ):
    _, _, jt = _fabric(name, pad=8 if not n_occ else 32)
    adj = np.asarray(jt.adj)
    dist = np.asarray(japsp.apsp_distances(jnp.asarray(adj)))
    ref = np.asarray(japsp.apsp_next_hops(
        jnp.asarray(adj), jnp.asarray(dist), block=block, max_degree=max_degree,
        n_occ=n_occ,
    ))
    got = apsp.apsp_next_hops(
        t_(adj), t_(dist), block=block, max_degree=max_degree, n_occ=n_occ
    ).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["fattree4", "random40"])
def test_neighbor_table_exact(name):
    _, _, jt = _fabric(name)
    adj = np.asarray(jt.adj)
    for got, ref in zip(dag.neighbor_table(t_(adj), 6), jdag.neighbor_table(jnp.asarray(adj), 6)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _collective(name: str, seed: int):
    """A weighted all-to-all among the fabric's host-attached switches."""
    _, jdb, jt = _fabric(name)
    v = jt.adj.shape[0]
    rng = np.random.default_rng(seed)
    edges = np.array(sorted({jt.index[h.port.dpid] for h in jdb.hosts.values()}))
    traffic = np.zeros((v, v), np.float32)
    for a in edges:
        for b in edges:
            if a != b:
                traffic[b, a] = rng.integers(1, 7)
    adj = np.asarray(jt.adj)
    base = (rng.random((v, v)) * 3.0 * adj).astype(np.float32)
    dist = np.asarray(japsp.apsp_distances(jnp.asarray(adj)))
    levels = int(dist[np.isfinite(dist)].max())
    return adj, dist, base, traffic, edges, levels


@pytest.mark.parametrize("name,rounds,restrict", [
    ("fattree4", 2, False), ("fattree6", 2, True), ("random40", 3, False),
    ("random40", 1, True),
])
def test_balance_rounds_within_f32_tolerance(name, rounds, restrict):
    adj, dist, base, traffic, edges, levels = _collective(name, 5)
    dn = jdag.make_dst_nodes(edges, pad_to=8) if restrict else None
    jw, jl, jm = jdag.balance_rounds(
        jnp.asarray(adj), jnp.asarray(dist), jnp.asarray(base), jnp.asarray(traffic),
        levels=levels, rounds=rounds, dst_nodes=None if dn is None else jnp.asarray(dn),
    )
    w, l, m = dag.balance_rounds(
        t_(adj), t_(dist), t_(base), t_(traffic), levels=levels, rounds=rounds,
        dst_nodes=None if dn is None else t_(dn),
    )
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(m), float(jm), rtol=1e-5, atol=1e-5)


def test_restrict_dst_exact():
    adj, dist, _, traffic, edges, _ = _collective("fattree4", 1)
    dn = jdag.make_dst_nodes(edges, pad_to=16)
    for got, ref in zip(
        dag.restrict_dst(t_(dist), t_(traffic), t_(dn)),
        jdag.restrict_dst(jnp.asarray(dist), jnp.asarray(traffic), jnp.asarray(dn)),
    ):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_gather_sampler_matches():
    """The cumulative-weight gather sampler (``sample_paths``)."""
    adj, dist, base, traffic, edges, levels = _collective("fattree6", 2)
    jw, _, _ = jdag.balance_rounds(
        jnp.asarray(adj), jnp.asarray(dist), jnp.asarray(base), jnp.asarray(traffic),
        levels=levels, rounds=2,
    )
    w = np.asarray(jw)
    rng = np.random.default_rng(3)
    src = rng.choice(edges, 300).astype(np.int32)
    dst = rng.choice(edges, 300).astype(np.int32)
    src[::17] = -1
    ref = jdag.sample_paths(
        jnp.asarray(w), jnp.asarray(dist), jnp.asarray(src), jnp.asarray(dst),
        levels + 1, 16, salt=6,
    )
    got = dag.sample_paths(t_(w), t_(dist), t_(src), t_(dst), levels + 1, 16, salt=6)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("name", ["fattree4", "random40"])
def test_slot_decoders_agree(name):
    """decode_slots_device, slots_to_nodes and the reference's
    decode_slots_jax on the same slot streams, including dead flows."""
    adj, dist, _, _, edges, levels = _collective(name, 4)
    rng = np.random.default_rng(8)
    f, hops = 200, max(1, levels - 1)
    src = rng.choice(edges, f).astype(np.int32)
    dst = rng.choice(edges, f).astype(np.int32)
    src[::13] = -1
    slots = rng.integers(-1, 3, (f, hops)).astype(np.int8)
    ref = np.asarray(jdag.decode_slots_jax(
        jnp.asarray(adj), jnp.asarray(slots), jnp.asarray(src), jnp.asarray(dst)
    ))
    dev = dag.decode_slots_device(t_(adj), t_(slots), t_(src), t_(dst)).numpy()
    host = dag.slots_to_nodes(adj, src, slots, dst=dst, complete=True)
    np.testing.assert_array_equal(dev, ref)
    np.testing.assert_array_equal(host, ref)


def test_native_fallbacks_match_library(monkeypatch):
    """The port's C++ codecs (built from native/) and its numpy
    fallbacks give the same results."""
    adj, dist, _, _, edges, _ = _collective("random40", 6)
    rng = np.random.default_rng(9)
    f = 120
    src = rng.choice(edges, f).astype(np.int32)
    dst = rng.choice(edges, f).astype(np.int32)
    slots = rng.integers(-1, 3, (f, 4)).astype(np.int8)
    order = native.neighbor_order(adj)
    paths = native.decode_slots(slots, order, src, dst, complete=True)
    port = np.where(adj > 0, 7, -1).astype(np.int32)
    dpids = np.arange(adj.shape[0], dtype=np.int64) + 100
    results = {}
    for mode in ("native", "numpy"):
        if mode == "numpy":
            monkeypatch.setattr(native, "_lib", None)
            monkeypatch.setattr(native, "_tried", True)
        elif not native.available():
            pytest.skip("no C++ compiler for the native codecs")
        results[mode] = (
            native.decode_slots(slots, order, src, dst, complete=True),
            native.link_loads(paths, np.ones(f, np.float32), adj.shape[0]),
            native.materialize_fdbs(paths, port, dpids, dst, np.full(f, 3, np.int32)),
            native.deal_subflows(
                np.arange(f, dtype=np.int32) % 5, src, dst,
                np.full(5, 3, np.int32), np.arange(5, dtype=np.int64) * 3,
            ),
        )
    for a, b in zip(results["native"], results["numpy"]):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)


def test_host_helpers_match():
    rng = np.random.default_rng(11)
    src_sw = rng.integers(0, 30, 500).astype(np.int32)
    dst_sw = rng.integers(0, 30, 500).astype(np.int32)
    for got, ref in zip(
        congestion.aggregate_pairs(src_sw, dst_sw), jcong.aggregate_pairs(src_sw, dst_sw)
    ):
        np.testing.assert_array_equal(got, ref)
    _, jdb, jt = _fabric("fattree4")
    t = tensorize(topology_from_dict(jdb.to_dict(), device="cpu"), 8, "cpu")
    util = {(int(d), p): float(rng.random() * 1e9)
            for d in jt.dpids for p in range(1, 5)}
    util[(999, 1)] = 5.0  # unknown dpid: ignored
    np.testing.assert_array_equal(
        congestion.utilization_matrix(t, util), jcong.utilization_matrix(jt, util)
    )
    for n in (1, 3, 8):
        assert dag.sampled_hops(n) == jdag.sampled_hops(n)
    dst = rng.integers(-1, 50, 90)
    np.testing.assert_array_equal(dag.make_dst_nodes(dst), jdag.make_dst_nodes(dst))

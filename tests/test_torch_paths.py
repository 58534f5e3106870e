"""The port's path chase, greedy scanner and window arrays against the
JAX package on the CPU.

``oracle/paths.py`` (``batch_paths``, ``batch_fdb``, ``fdb_ports``) must
be bit-identical to the reference on the reference's own next-hop and
port matrices, unreachable pairs, padding flows and too short a
``max_len`` included. The greedy scanner
(``oracle/congestion.route_flows_balanced``) and its load must be exact
where the weights are integers (every float32 sum then exact in any
order), at two chunk sizes, with tied candidates dealt round-robin.
``bucket_pow2`` and ``WindowRoutes`` must behave as the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnmpi_tpu.oracle import batch as jbatch
from sdnmpi_tpu.oracle import congestion as jcong
from sdnmpi_tpu.oracle import paths as jpaths
from sdnmpi_tpu.oracle.apsp import apsp_distances as j_apsp
from sdnmpi_tpu.oracle.apsp import apsp_next_hops as j_next
from sdnmpi_tpu.oracle.engine import tensorize as j_tensorize
from sdnmpi_tpu.topogen import dragonfly as j_dragonfly
from sdnmpi_tpu.topogen import fattree as j_fattree
from sdnmpi_tpu.topogen import torus as j_torus
from sdnmpi_tpu_torch.kernels.bfs import neighbor_rows
from sdnmpi_tpu_torch.oracle import batch, congestion, paths
from tests.test_torch_kernels import _random_digraph


def t_(x):
    return torch.tensor(np.asarray(x))


def _fabric(name: str):
    """(adj, port, dist, next_hop) numpy matrices of one fabric, from the
    JAX package."""
    if name == "digraph":  # asymmetric and sparse: many unreachable pairs
        adj = _random_digraph(4, 40, 0.04)
        v = adj.shape[0]
        port = np.where(adj > 0, np.arange(v)[None, :] + 1, -1).astype(np.int32)
    else:
        spec = {
            "fattree4": lambda: j_fattree(4),
            "dragonfly": lambda: j_dragonfly(4, 4, 1, 2),
            "torus": lambda: j_torus((3, 4)),
        }[name]()
        t = j_tensorize(spec.to_topology_db(backend="jax"))
        adj, port = np.asarray(t.adj), np.asarray(t.port)
    dist = j_apsp(jnp.asarray(adj))
    nxt = j_next(jnp.asarray(adj), dist)
    return adj, port, np.asarray(dist), np.asarray(nxt)


def _pairs(v: int, seed: int, n: int = 200):
    """Random pairs over the padded index range, some of them -1 pads."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, n).astype(np.int32)
    dst = rng.integers(0, v, n).astype(np.int32)
    src[::17] = -1
    dst[::17] = -1
    return src, dst


@pytest.mark.parametrize("name", ["fattree4", "dragonfly", "torus", "digraph"])
@pytest.mark.parametrize("extra", [0, 3, -1])
def test_batch_fdb_bit_identical(name, extra):
    """Nodes, ports and lengths equal the reference's, at a hop budget of
    exactly diameter + 1, longer, and one short (long flows then read
    unreachable)."""
    adj, port, dist, nxt = _fabric(name)
    v = adj.shape[0]
    src, dst = _pairs(v, seed=len(name))
    diameter = int(dist[np.isfinite(dist)].max())
    max_len = diameter + 1 + extra
    fport = np.random.default_rng(1).integers(1, 9, len(src)).astype(np.int32)
    ref = jpaths.batch_fdb(
        jnp.asarray(nxt), jnp.asarray(port), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(fport), max_len,
    )
    got = paths.batch_fdb(t_(nxt), t_(port), t_(src), t_(dst), t_(fport), max_len)
    for g, r, what in zip(got, ref, ("nodes", "ports", "length")):
        assert g.dtype == torch.int32, what
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), what)
    length = got[2].numpy()
    live = (src >= 0) & (dst >= 0)
    reach = live & np.isfinite(dist[np.maximum(src, 0), np.maximum(dst, 0)])
    fits = reach & (dist[np.maximum(src, 0), np.maximum(dst, 0)] + 1 <= max_len)
    assert (length[~fits] == 0).all() and (length[fits] > 0).all()
    if extra < 0:
        assert (reach & ~fits).any()  # the short budget cut some flows
    if name == "digraph":
        assert (live & ~reach).any()  # and the digraph has unreachable pairs


def test_batch_paths_and_fdb_ports_alone():
    """``batch_paths`` and ``fdb_ports`` called on their own (the parts
    the collective shortest policy and the ring chase use)."""
    adj, port, dist, nxt = _fabric("fattree4")
    src, dst = _pairs(adj.shape[0], seed=9, n=64)
    ref_nodes, ref_len = jpaths.batch_paths(
        jnp.asarray(nxt), jnp.asarray(src), jnp.asarray(dst), 6)
    nodes, length = paths.batch_paths(t_(nxt), t_(src), t_(dst), 6)
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(ref_nodes))
    np.testing.assert_array_equal(length.numpy(), np.asarray(ref_len))
    fport = np.full(len(src), 7, np.int32)
    ref_ports = jpaths.fdb_ports(jnp.asarray(port), ref_nodes, ref_len, jnp.asarray(fport))
    ports = paths.fdb_ports(t_(port), nodes, length, t_(fport))
    np.testing.assert_array_equal(ports.numpy(), np.asarray(ref_ports))


def _scanner_problem(name: str, seed: int, n: int, util: bool):
    adj, _, dist, _ = _fabric(name)
    v = adj.shape[0]
    rng = np.random.default_rng(seed)
    real = np.nonzero(adj.sum(axis=1) > 0)[0]
    src = rng.choice(real, n).astype(np.int32)
    dst = rng.choice(real, n).astype(np.int32)
    src[5] = -1  # a padding row
    # repeated (src, dst) flows in one chunk tie on their candidates
    src[10:20], dst[10:20] = src[10], dst[10]
    weight = rng.integers(1, 5, n).astype(np.float32)
    base = (
        np.where(adj > 0, rng.integers(0, 3, adj.shape), 0).astype(np.float32)
        if util else np.zeros(adj.shape, np.float32)
    )
    diameter = int(dist[np.isfinite(dist)].max())
    return adj, dist, base, src, dst, weight, diameter + 1


@pytest.mark.parametrize("name,chunk,util", [
    ("fattree4", 4096, False), ("fattree4", 16, True), ("dragonfly", 8, True),
    ("torus", 4096, True), ("digraph", 32, False),
])
def test_route_flows_balanced_exact_with_integer_weights(name, chunk, util):
    """Nodes, load and max congestion equal the reference's exactly:
    integer weights and costs keep every float32 sum exact in any order,
    so the same ties meet the same round-robin deal."""
    adj, dist, base, src, dst, weight, max_len = _scanner_problem(
        name, seed=chunk, n=120, util=util)
    v = adj.shape[0]
    ref = jcong.route_flows_balanced(
        jnp.asarray(adj), jnp.asarray(dist), jnp.asarray(base), jnp.asarray(src),
        jnp.asarray(dst), jnp.asarray(weight), max_len, chunk=chunk, max_degree=v,
    )
    neigh = neighbor_rows(t_(adj) > 0, int((adj > 0).sum(axis=1).max()))
    got = congestion.route_flows_balanced(
        t_(adj), t_(dist), t_(base), t_(src), t_(dst), t_(weight), max_len,
        chunk=chunk, neigh=neigh,
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert float(got[2]) == float(ref[2])
    # the tied flows were spread: more than one path among them
    rows = {tuple(r) for r in got[0].numpy()[10:20]}
    if np.isfinite(dist[src[10], dst[10]]) and dist[src[10], dst[10]] >= 2:
        assert len(rows) > 1 or name == "digraph"
    # the scanner's load is the load of its own paths
    np.testing.assert_array_equal(
        congestion.link_loads_from_paths(got[0], v, t_(weight)).numpy(),
        got[1].numpy(),
    )


def test_route_flows_balanced_fractional_weights_are_stable():
    """Fractional weights (``count / nsub``, 7/3 and the like): the
    float64 accumulation gives the same routes on every call, and the
    load agrees with the reference's sequential float32 sums and with
    the paths' own load to rtol 1e-6 where the routes agree."""
    adj, dist, base, src, dst, _, max_len = _scanner_problem(
        "fattree4", seed=3, n=90, util=True)
    weight = (np.random.default_rng(5).integers(1, 9, len(src)) / 3.0).astype(np.float32)
    args = (t_(adj), t_(dist), t_(base), t_(src), t_(dst), t_(weight), max_len)
    a = congestion.route_flows_balanced(*args, chunk=32)
    b = congestion.route_flows_balanced(*args, chunk=32)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    np.testing.assert_allclose(
        congestion.link_loads_from_paths(a[0], adj.shape[0], t_(weight)).numpy(),
        a[1].numpy(), rtol=1e-6,
    )
    ref = jcong.route_flows_balanced(
        jnp.asarray(adj), jnp.asarray(dist), jnp.asarray(base), jnp.asarray(src),
        jnp.asarray(dst), jnp.asarray(weight), max_len, chunk=32,
        max_degree=adj.shape[0],
    )
    if np.array_equal(a[0].numpy(), np.asarray(ref[0])):
        np.testing.assert_allclose(a[1].numpy(), np.asarray(ref[1]), rtol=1e-6)


def test_link_loads_from_paths_matches_reference():
    adj, _, dist, nxt = _fabric("torus")
    src, dst = _pairs(adj.shape[0], seed=2, n=80)
    nodes, _ = jpaths.batch_paths(jnp.asarray(nxt), jnp.asarray(src), jnp.asarray(dst), 6)
    w = np.random.default_rng(0).integers(1, 6, len(src)).astype(np.float32)
    ref = jcong.link_loads_from_paths(nodes, adj.shape[0], jnp.asarray(w))
    got = congestion.link_loads_from_paths(t_(nodes), adj.shape[0], t_(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,floor", [(0, 8), (1, 8), (8, 8), (9, 8), (1000, 8), (3, 1), (5, 2)])
def test_bucket_pow2_matches_reference(n, floor):
    assert batch.bucket_pow2(n, floor) == jbatch.bucket_pow2(n, floor)


def test_window_routes_match_reference():
    """from_fdbs, fdbs, set_fdb (growing the hop axis) and the fields."""
    fdbs = [[(1, 2), (3, 4)], [], [(5, 1)], [(2, 3), (4, 1), (6, 2)]]
    got = batch.WindowRoutes.from_fdbs(fdbs, max_congestion=2.5, n_detours=1)
    ref = jbatch.WindowRoutes.from_fdbs(fdbs, max_congestion=2.5, n_detours=1)
    for field in ("hop_dpid", "hop_port", "hop_len"):
        a, b = getattr(got, field), getattr(ref, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.fdbs() == ref.fdbs() == fdbs
    assert (got.max_congestion, got.n_detours, got.touched, got.n_pairs) == (
        2.5, 1, None, 4)
    long = [(9, 1), (8, 2), (7, 3), (6, 4), (5, 5)]
    got.set_fdb(1, long)
    ref.set_fdb(1, long)
    np.testing.assert_array_equal(got.hop_dpid, ref.hop_dpid)
    assert got.fdb(1) == long and got.fdbs() == ref.fdbs()
    empty = batch.WindowRoutes.from_fdbs([])
    assert empty.hop_dpid.shape == (0, 1) and empty.fdbs() == []

"""Kernel K2's compact tables and shared set-up, on the CPU.

The port builds the sorted out-neighbour table ``[V, D]`` once per
topology version without a sort (``kernels.bfs.neighbor_rows``), and
kernel K2's per-call set-up (``kernels.sampler.sampler_tables``: link
log weights, destination rows) once per device per call. These tests
hold the table against a numpy sort and the JAX package's
``dag.neighbor_table``, the set-up against the dense ``[V, V]``
formulations it replaces, and the compact sampler fed those tables
against the dense plain version, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnmpi_tpu.oracle import dag as jdag
from sdnmpi_tpu_torch import native
from sdnmpi_tpu_torch import shardplane as pshard
from sdnmpi_tpu_torch.kernels import bfs, sampler
from sdnmpi_tpu_torch.oracle import dag
from sdnmpi_tpu_torch.oracle.apsp import apsp_distances
from sdnmpi_tpu_torch.oracle.engine import tensorize
from sdnmpi_tpu_torch.topogen import fattree, torus2d

FABRICS = {
    "fattree4": lambda: fattree(4),
    "fattree8": lambda: fattree(8),
    "torus2d": lambda: torus2d(4, 5),
}


def _random_adj() -> np.ndarray:
    """A random digraph with isolated rows and all-zero padding rows."""
    rng = np.random.default_rng(11)
    adj = (rng.random((70, 70)) < 0.08).astype(np.float32)
    np.fill_diagonal(adj, 0.0)
    adj[[3, 17, 40]] = 0.0  # no out-links
    adj[60:] = 0.0  # padding past the occupied switches
    adj[:, 60:] = 0.0
    return adj


def _adj(name: str) -> np.ndarray:
    if name == "random":
        return _random_adj()
    spec = FABRICS[name]()
    db = spec.to_topology_db(backend="torch", device="cpu", pad_multiple=8)
    return tensorize(db, device="cpu").adj.numpy()


@pytest.mark.parametrize("name", ["fattree4", "fattree8", "torus2d", "random"])
def test_neighbor_rows_match_sort_and_jax(name):
    """The sort-free table equals the sorted rows cut to the width, and
    the JAX package's neighbor_table, at the full degree and cut short."""
    adj = _adj(name)
    deg = int((adj > 0).sum(axis=1).max())
    mask = torch.tensor(adj) > 0
    own = bfs.neighbor_rows_of(torch.tensor(adj)).numpy()
    assert own.shape == (adj.shape[0], deg)
    np.testing.assert_array_equal(own, native.neighbor_order(adj)[:, :deg])
    for width in (deg, deg + 5, max(1, deg - 2)):
        got = bfs.neighbor_rows(mask, width).numpy()
        assert got.shape == (adj.shape[0], width) and got.dtype == np.int32
        want = native.neighbor_order(adj)
        want = np.pad(want, ((0, 0), (0, max(0, width - want.shape[1]))),
                      constant_values=adj.shape[0])[:, :width]
        np.testing.assert_array_equal(got, want)
        ref, _, _ = jdag.neighbor_table(jnp.asarray(adj), width)
        np.testing.assert_array_equal(got[:, : np.asarray(ref).shape[1]], np.asarray(ref))


@pytest.mark.parametrize("name", ["fattree4", "torus2d"])
def test_tensorize_carries_the_table(name):
    """TopoTensors.neigh is the table of its adjacency at max_degree,
    and the weights the balancer makes are positive exactly on its
    links, so a slot (a table position) is the dense rank."""
    db = FABRICS[name]().to_topology_db(backend="torch", device="cpu", pad_multiple=8)
    t = tensorize(db, device="cpu")
    assert t.neigh.shape == (t.v, t.max_degree) and t.neigh.dtype == torch.int32
    torch.testing.assert_close(t.neigh, bfs.neighbor_rows(t.adj > 0, t.max_degree))
    dist = apsp_distances(t.adj)
    rng = np.random.default_rng(2)
    traffic = torch.tensor(rng.random((t.v, t.v)).astype(np.float32)) * (dist < 9)
    cost = torch.tensor(rng.random((t.v, t.v)).astype(np.float32))
    w, _, _ = dag.balance_rounds(t.adj, dist, cost, traffic, levels=6, rounds=2)
    assert torch.equal(w > 0, t.adj > 0)


def _problem(name: str = "fattree4", n_flows: int = 500, seed: int = 3):
    db = FABRICS[name]().to_topology_db(backend="torch", device="cpu", pad_multiple=8)
    t = tensorize(db, device="cpu")
    dist = apsp_distances(t.adj)
    rng = np.random.default_rng(seed)
    edges = np.unique([t.index[h.port.dpid] for h in db.hosts.values()])
    traffic = np.zeros((t.v, t.v), np.float32)
    for a in edges:
        for b in edges:
            if a != b:
                traffic[b, a] = rng.integers(1, 9)
    w, _, _ = dag.balance_rounds(
        t.adj, dist, torch.zeros((t.v, t.v)), torch.tensor(traffic),
        levels=6, rounds=2,
    )
    src = rng.integers(-1, t.n_real, n_flows).astype(np.int32)
    dst = rng.choice(edges, n_flows).astype(np.int32)
    dst[::40] = -1
    return t, w, dist, torch.tensor(src), torch.tensor(dst), torch.tensor(
        dag.make_dst_nodes(dst, pad_to=8))


def test_set_up_equals_the_dense_tables():
    """Link log weights equal the dense log-weight matrix at the table's
    entries (NO_LINK on padding); the destination rows and each node's
    row equal the dense transpose's rows and the set's first positions."""
    t, w, dist, _, _, dn = _problem()
    tabs = sampler.sampler_tables(w, dist, dn, neigh=t.neigh)
    v = t.v
    dense = sampler.log_weights(w)
    valid = t.neigh < v
    want = torch.where(valid, dense.gather(1, t.neigh.clamp(max=v - 1).long()),
                       torch.tensor(sampler.NO_LINK, dtype=torch.bfloat16))
    assert torch.equal(tabs.lw, want)
    rows = sampler.dist_rows(dist)
    valid_t = dn >= 0
    want_t = torch.where(valid_t[:, None], rows[dn.long().clamp(min=0)],
                         torch.tensor(sampler.UNREACH, dtype=torch.bfloat16))
    assert torch.equal(tabs.dtab, want_t)
    for node in range(v):
        hit = np.nonzero(dn.numpy() == node)[0]
        assert int(tabs.row_of[node]) == (int(hit[0]) if len(hit) else -1)
    full = sampler.sampler_tables(w, dist, neigh=t.neigh)
    assert torch.equal(full.dtab, rows) and full.row_of is None
    # without a topology table the set-up builds one from weights > 0
    own = sampler.sampler_tables(w, dist, dn)
    assert torch.equal(own.neigh[:, : t.neigh.shape[1]], t.neigh[:, : own.neigh.shape[1]])
    assert torch.equal(own.lw, tabs.lw[:, : own.lw.shape[1]])


@pytest.mark.parametrize("layout", ["full", "dst_nodes"])
@pytest.mark.parametrize("fid_base", [0, 4242, 0xFFFFFF00])
def test_compact_sampler_equals_dense(layout, fid_base):
    """sample_slots fed the topology's table and one shared set-up, and
    fed nothing, gives the dense plain version's slots bit for bit."""
    t, w, dist, src, dst, dn = _problem()
    dn = dn if layout == "dst_nodes" else None
    hops = 4
    _, want = sampler.sample_paths_dense(w, dist, src, dst, hops, salt=7,
                                         fid_base=fid_base, dst_nodes=dn)
    tabs = sampler.sampler_tables(w, dist, dn, neigh=t.neigh)
    shared = sampler.sample_slots(w, dist, src, dst, hops, salt=7, dst_nodes=dn,
                                  fid_base=fid_base, tables=tabs)
    assert torch.equal(shared, want)
    built = sampler.sample_slots(w, dist, src, dst, hops, salt=7, dst_nodes=dn,
                                 fid_base=fid_base)
    assert torch.equal(built, want)
    assert (want >= 0).sum() > 100  # the walk really moved
    # shards of the flows with their global ids reproduce the whole batch
    half = src.shape[0] // 2
    parts = [
        sampler.sample_slots(w, dist, src[a:b], dst[a:b], hops, salt=7, dst_nodes=dn,
                             fid_base=fid_base + a, tables=tabs)
        for a, b in ((0, half), (half, src.shape[0]))
    ]
    assert torch.equal(torch.cat(parts), want)


def test_lane_group_fills_the_card():
    """K2's lanes per flow: 4 for a batch that fills 16 warps per SM on
    132 SMs (config 4's 85,556 flows), 8 for a smaller one (config 13's
    10,695 per shard) however small."""
    assert sampler.lane_group(85_556, 132) == 4
    assert sampler.lane_group(42_925, 132) == 4
    assert sampler.lane_group(10_695, 132) == 8
    assert sampler.lane_group(100, 132) == 8
    assert [sampler.lane_group(f, 132) for f in (0, 3000, 16895, 16896, 20000)] == [
        8, 8, 8, 4, 4]


def test_set_up_refuses_other_devices():
    meta = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError):
        sampler.sampler_tables(meta, meta, neigh=torch.zeros((4, 2), dtype=torch.int32,
                                                              device="meta"))


def test_sample_slots_rejects_mismatched_tables():
    t, w, dist, src, dst, dn = _problem(n_flows=20)
    tabs = sampler.sampler_tables(w, dist, dn, neigh=t.neigh)
    with pytest.raises(ValueError):
        sampler.sample_slots(w[:-8, :-8], dist[:-8, :-8], src, dst, 3, tables=tabs)
    bad = sampler.SamplerTables(tabs.neigh.long(), tabs.lw, tabs.dtab, tabs.row_of)
    with pytest.raises(ValueError):
        sampler.sample_slots(w, dist, src, dst, 3, tables=bad)


def _counting(monkeypatch, module, name: str) -> list:
    """Record every call of ``module.name`` (a kernel wrapper)."""
    real = getattr(module, name)
    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_route_collective_with_topology_table(monkeypatch):
    """route_collective given TopoTensors.neigh equals the call that
    builds its own table, and the sampler's set-up runs once."""
    t, w, dist, src, dst, dn = _problem(n_flows=120)
    li, lj = (x.to(torch.int32) for x in torch.nonzero(t.adj > 0, as_tuple=True))
    util = torch.zeros(li.shape[0])
    traffic = torch.zeros((t.v, t.v))
    traffic[dst.clamp(min=0).long(), src.clamp(min=0).long()] = 1.0
    kw = dict(levels=6, rounds=2, max_len=7, dist=dist, dst_nodes=dn)
    set_ups = _counting(monkeypatch, dag, "sampler_tables")
    got = dag.route_collective(t.adj, li, lj, util, traffic, src, dst,
                               neigh=t.neigh, **kw)
    assert len(set_ups) == 1 and set_ups[0]["neigh"] is t.neigh
    ref = dag.route_collective(t.adj, li, lj, util, traffic, src, dst, **kw)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("ring_exchange", [False, True])
def test_sharded_program_sets_up_once_per_device(monkeypatch, ring_exchange):
    """route_collective_sharded builds K2's set-up once for its one
    device and launches one sampler call per shard, each with its
    flows' fid_base, and its slots equal one device's."""
    from sdnmpi_tpu_torch.shardplane import routes

    t, w, dist, src, dst, dn = _problem(n_flows=160)
    mesh = pshard.make_mesh(4, device="cpu")
    li, lj = (x.to(torch.int32) for x in torch.nonzero(t.adj > 0, as_tuple=True))
    util = torch.zeros(li.shape[0])
    traffic = torch.zeros((t.v, t.v))
    traffic[dst.clamp(min=0).long(), src.clamp(min=0).long()] = 1.0
    kw = dict(levels=6, rounds=2, max_len=7, dist=dist, dst_nodes=dn)
    launches = _counting(monkeypatch, routes, "sample_slots")
    set_ups = _counting(monkeypatch, routes, "sampler_tables")
    slots, maxc = pshard.route_collective_sharded(
        t.adj, li, lj, util, traffic, src, dst, mesh, ring_exchange=ring_exchange,
        neigh=t.neigh, **kw,
    )
    assert len(set_ups) == 1
    assert [c["fid_base"] for c in launches] == [0, 40, 80, 120]
    assert all(c["tables"] is launches[0]["tables"] for c in launches)
    single, single_maxc = dag.route_collective(t.adj, li, lj, util, traffic, src,
                                               dst, **kw)
    assert torch.equal(torch.cat(slots), single)
    torch.testing.assert_close(maxc, single_maxc, rtol=1e-5, atol=0)

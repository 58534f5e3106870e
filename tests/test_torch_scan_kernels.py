"""The phased path's two scans (kernels S1 and S2) against the JAX
package on the CPU.

S1 is the greedy scanner (``oracle/congestion.route_flows_balanced``,
``kernels/csrc/scan.cu``) and S2 the phase packer
(``sched/phases._pack_greedy_device``, ``kernels/csrc/pack.cu``). Neither
kernel runs here: on a CPU tensor each wrapper takes its plain version,
and these tests hold what the kernels rely on. The scanner's kernel stops
at the last live row: the plain version on the live rows alone must give
the reference's padded scan, its pads all -1 and their load nowhere.
Every call site must hand the scanner what its kernel takes. The packer
at config 12's shape must equal the reference's and the numpy twin's bit
for bit, and the balanced phased program of a k=8 fat-tree at 64 ranks
the reference's. Every comparison is exact (integer weights keep every
float sum exact in any order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnmpi_tpu.oracle import congestion as j_cong
from sdnmpi_tpu.sched import phases as j_phases
from sdnmpi_tpu_torch.kernels.bfs import neighbor_rows
from sdnmpi_tpu_torch.oracle import congestion
from sdnmpi_tpu_torch.oracle.batch import pad_flow_batch
from sdnmpi_tpu_torch.sched import phases
from tests.test_torch_paths import _fabric, t_
from tests.test_torch_sched import _programs_equal, alltoall_idx


def _phase_flows(name: str, n: int, seed: int):
    """A phase-grain scanner problem: ``n`` weight-1 sub-flows between
    random real switches, a seeded integer base cost, end-padded to the
    next power of two with dead rows as the phased leg pads them."""
    adj, _, dist, _ = _fabric(name)
    rng = np.random.default_rng(seed)
    real = np.nonzero(adj.sum(axis=1) > 0)[0]
    src = rng.choice(real, n).astype(np.int32)
    dst = rng.choice(real, n).astype(np.int32)
    src_p, dst_p = pad_flow_batch(src, dst, pow2=True)
    w_p = np.zeros(len(src_p), np.float32)
    w_p[:n] = 1.0
    base = np.where(adj > 0, rng.integers(0, 3, adj.shape), 0).astype(np.float32)
    max_len = int(dist[np.isfinite(dist)].max()) + 1
    return adj, dist, base, src_p, dst_p, w_p, max_len


@pytest.mark.parametrize("name,n", [("fattree4", 45), ("dragonfly", 100)])
def test_scanner_stops_at_the_last_live_row(name, n):
    """The plain scanner at chunk 1 on the live rows alone equals the
    reference's scan of the power-of-two padded batch: nodes, load and max
    exactly, the pads' rows all -1. So skipping the trailing pads, as
    kernel S1 does, changes no output."""
    adj, dist, base, src_p, dst_p, w_p, max_len = _phase_flows(name, n, seed=n)
    assert len(src_p) > n and (src_p[n:] == -1).all()
    v = adj.shape[0]
    ref = j_cong.route_flows_balanced(
        jnp.asarray(adj), jnp.asarray(dist), jnp.asarray(base), jnp.asarray(src_p),
        jnp.asarray(dst_p), jnp.asarray(w_p), max_len, chunk=1, max_degree=v)
    neigh = neighbor_rows(t_(adj) > 0, int((adj > 0).sum(axis=1).max()))
    live = congestion.route_flows_balanced_plain(
        t_(adj), t_(dist), t_(base), t_(src_p[:n]), t_(dst_p[:n]), t_(w_p[:n]),
        max_len, chunk=1, neigh=neigh)
    padded = congestion.route_flows_balanced(
        t_(adj), t_(dist), t_(base), t_(src_p), t_(dst_p), t_(w_p), max_len,
        chunk=1, neigh=neigh)
    ref_nodes = np.asarray(ref[0])
    assert (ref_nodes[n:] == -1).all()
    np.testing.assert_array_equal(live[0].numpy(), ref_nodes[:n])
    np.testing.assert_array_equal(padded[0].numpy(), ref_nodes)
    for got in (live, padded):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        assert float(got[2]) == float(ref[2])


def test_wrapper_dispatch_on_the_cpu():
    """A CPU tensor takes the plain version and launches nothing; a CUDA
    request without a card raises, and so does a device that is neither."""
    adj, dist, base, src_p, dst_p, w_p, max_len = _phase_flows("fattree4", 20, seed=1)
    congestion.route_flows_balanced.launches = 0
    phases._pack_greedy_device.launches = 0
    args = [t_(x) for x in (adj, dist, base, src_p, dst_p, w_p)]
    got = congestion.route_flows_balanced(*args, max_len, chunk=1)
    want = congestion.route_flows_balanced_plain(*args, max_len, chunk=1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    s = torch.tensor([0, 1, -1, 2])
    pk = [s, s.flip(0), torch.ones(4), torch.zeros(3), torch.zeros(3)]
    assert torch.equal(phases._pack_greedy_device(*pk, 2),
                       phases._pack_greedy_plain(*pk, 2))
    assert congestion.route_flows_balanced.launches == 0
    assert phases._pack_greedy_device.launches == 0
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError):
        congestion.route_flows_balanced(*meta, max_len)
    with pytest.raises(ValueError):
        phases._pack_greedy_device(*[x.to("meta") for x in pk], 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            phases.pack_phases(np.array([0]), np.array([1]), np.ones(1, np.float32),
                               2, 3, device="cuda")


def test_kernel_argument_checks():
    """What kernel S1 refuses: a wrong dtype, a non-contiguous tensor, an
    empty batch or neighbour table. A table of any width is taken (the
    kernel walks its slots in groups of 32)."""
    adj, dist, base, src_p, dst_p, w_p, max_len = _phase_flows("fattree4", 20, seed=2)
    a, d, b, s, t, w = (t_(x) for x in (adj, dist, base, src_p, dst_p, w_p))
    neigh = neighbor_rows(a > 0, 4)
    congestion.check_kernel_args(a, d, b, s, t, w, max_len, 1, neigh)
    congestion.check_kernel_args(a, d, b, s, t, w, max_len, 1, neighbor_rows(a > 0, 80))
    for bad in (
        (a, d.double(), b, s, t, w, max_len, 1, neigh),
        (a, d, b, s.long(), t, w, max_len, 1, neigh),
        (a, d.t(), b, s, t, w, max_len, 1, neigh),
        (a, d, b, s, t, w, max_len, 1, neigh[:, :0]),
        (a, d, b, s, t, w, 0, 1, neigh),
        (a, d, b, s[:0], t[:0], w[:0], max_len, 1, neigh),
    ):
        with pytest.raises(ValueError):
            congestion.check_kernel_args(*bad)


def test_call_sites_pass_what_the_kernel_takes(monkeypatch):
    """Every call of the scanner on the balanced pair batch, the
    phase-grain leg (with the host's base cost and with the utilization
    plane's) and route_flows_sharded passes arguments kernel S1 takes
    (checked on the CPU tensors the call sites hand the wrapper)."""
    from sdnmpi_tpu_torch.oracle.utilplane import UtilPlane
    from sdnmpi_tpu_torch.shardplane import make_mesh
    from sdnmpi_tpu_torch.shardplane.routes import route_flows_sharded
    from sdnmpi_tpu_torch.topogen import fattree

    seen = []
    plain = congestion.route_flows_balanced_plain

    def checked(adj, dist, base, src, dst, weight, max_len, chunk=4096, neigh=None):
        congestion.check_kernel_args(adj, dist, base, src, dst, weight, max_len,
                                     chunk, neigh)
        seen.append(chunk)
        return plain(adj, dist, base, src, dst, weight, max_len, chunk=chunk,
                     neigh=neigh)

    monkeypatch.setattr(congestion, "route_flows_balanced_plain", checked)
    spec = fattree(4)
    db = spec.to_topology_db(backend="torch", device="cpu")
    macs = sorted(m for m, _, _ in spec.hosts)
    db.find_routes_batch_balanced([(macs[0], macs[-1]), (macs[1], macs[5])])
    src, dst = alltoall_idx(len(macs))
    db.find_routes_collective_phased(macs, src, dst, "balanced")
    plane = UtilPlane()
    for a in sorted(db.links):
        for b in sorted(db.links[a]):
            plane.stage((a, db.links[a][b].src.port_no), 4e9)
    db.find_routes_collective_phased(macs, src, dst, "balanced", link_util=plane)
    oracle = db._oracle_engine()
    t = oracle.refresh(db)
    v = t.v
    rng = np.random.default_rng(0)
    fs = torch.from_numpy(rng.integers(0, v, 64).astype(np.int32))
    fd = torch.from_numpy(rng.integers(0, v, 64).astype(np.int32))
    route_flows_sharded(t.adj, oracle._dist_full(), torch.zeros((v, v)), fs, fd,
                        torch.ones(64), make_mesh(4, device="cpu"), 5, neigh=t.neigh)
    assert seen[0] == 4096 and 1 in seen and seen.count(1024) == 4


def test_packer_at_config12_shape_is_bit_equal():
    """4,096 groups over V = 320 switches into K = 4 phases with a seeded
    fractional background: the port's device packer (its plain version
    here), the reference's jitted scan and the numpy twin agree on every
    group's phase."""
    rng = np.random.default_rng(12)
    v, g, k = 320, 4096, 4
    src = rng.integers(0, 64, g).astype(np.int32)
    dst = rng.integers(0, 64, g).astype(np.int32)
    w = np.where(src == dst, 0.0, rng.integers(1, 65, g)).astype(np.float32)
    util_out = (rng.random(v) * 4).astype(np.float32)
    util_in = (rng.random(v) * 4).astype(np.float32)
    order = np.argsort(-w, kind="stable")
    s_o, d_o, w_o = src[order], dst[order], w[order]
    got = phases._pack_greedy_device(
        t_(s_o), t_(d_o), t_(w_o), t_(util_out), t_(util_in), k).numpy()
    ref = np.asarray(j_phases._pack_greedy_device(
        jnp.asarray(s_o), jnp.asarray(d_o), jnp.asarray(w_o), jnp.asarray(util_out),
        jnp.asarray(util_in), k))
    host = phases.pack_phases_host(s_o, d_o, w_o, util_out, util_in, k)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, host)
    assert set(np.unique(got)) == set(range(k))


def test_balanced_phased_program_k8_64_ranks():
    """The balanced phased program of a k=8 fat-tree at 64 ranks (4,032
    pairs, each phase's groups split into weight-1 sub-flows and scanned
    one at a time) equals the reference's: pair phases, every phase's
    routes and the total discrete congestion."""
    from sdnmpi_tpu.topogen import fattree as j_fattree
    from sdnmpi_tpu_torch.topogen import fattree

    spec = fattree(8)
    got_db = spec.to_topology_db(backend="torch", device="cpu")
    ref_db = j_fattree(8).to_topology_db(backend="jax")
    macs = sorted(m for m, _, _ in spec.hosts)[:64]
    src, dst = alltoall_idx(64)
    got = got_db._oracle_engine().routes_collective_phased(
        got_db, macs, src, dst, "balanced")
    want = ref_db._jax_oracle().routes_collective_phased(
        ref_db, macs, src, dst, "balanced")
    _programs_equal(got, want)
    assert got.total_discrete_congestion() == want.total_discrete_congestion()


# -- kernel S1's two forms: the form rule and the slot-load scatter -------


@pytest.mark.parametrize("what,v,d,chunk,u,form", [
    ("config 5's greedy leg", 256, 40, 4096, 64, "resident"),
    ("config 12's phased leg", 320, 16, 1, 65536, "resident"),
    ("config 12's sentinel sample", 320, 16, 4096, 64, "resident"),
    ("config 12 at a chunk of 128 rows", 320, 16, 128, 65536, "resident"),
    ("config 12 at a chunk of 129 rows", 320, 16, 129, 65536, "spread"),
    ("config 12 at a chunk of 4096 rows", 320, 16, 4096, 65536, "spread"),
    ("config 13's shard", 3968, 56, 1024, 16384, "spread"),
    ("random_regular(256, 80)", 256, 80, 256, 4096, "spread"),
])
def test_scan_form_rule(what, v, d, chunk, u, form):
    """The rule that picks S1's form: the resident form where its tables
    fit one block's shared memory and at most 128 flows pick together,
    the spread form where the tables do not fit (config 13, D = 80) or
    the chunk is wider."""
    assert congestion.scan_form(v, d, chunk, u) == form, what
    fits = congestion.resident_bytes(v, d) <= congestion.RESIDENT_SMEM_BYTES
    assert fits == (what not in ("config 13's shard", "random_regular(256, 80)"))


@pytest.mark.parametrize("v,d,want", [
    # 40,960 B of f64 loads + 20,480 of f32 costs + 10,240 of int16
    # neighbours + 320 hop rows of 81 words + the last live row's word
    (320, 16, 40_960 + 20_480 + 10_240 + 320 * 324 + 4),
    (256, 40, 81_920 + 40_960 + 20_480 + 256 * 260 + 4),
    (256, 80, 163_840 + 81_920 + 40_960 + 256 * 260 + 4),
    (3968, 56, 1_777_664 + 888_832 + 444_416 + 3968 * 3972 + 4),
    (300, 1, 2_400 + 1_200 + 600 + 300 * 300 + 4),
    (7, 3, 168 + 84 + 44 + 7 * 12 + 4),
])
def test_resident_bytes(v, d, want):
    """The resident form's byte count: slot loads, slot costs, int16
    neighbours rounded up to a word, hop rows of an odd number of words
    at least V bytes long, and one word for the last live row."""
    assert congestion.resident_bytes(v, d) == want
    stride = congestion.resident_hop_stride(v)
    assert stride >= v and stride % 4 == 0 and (stride // 4) % 2 == 1
    assert congestion.spread_hop_stride(v) % 16 == 0
    assert 0 <= congestion.spread_hop_stride(v) - v < 16


def test_scan_form_widths_of_the_real_fabrics():
    """The neighbour tables of config 5's dragonfly and config 12's k=16
    fat-tree are as wide as the form rule's cases say (D = 40 and 16),
    and both fit the resident form."""
    from sdnmpi_tpu_torch.topogen import dragonfly, fattree

    for spec, v, d in ((dragonfly(8, 32, hosts_per_router=1, global_links=2), 256, 40),
                       (fattree(16), 320, 16)):
        db = spec.to_topology_db(backend="torch", device="cpu")
        t = db._oracle_engine().refresh(db)
        assert (t.v, t.neigh.shape[1]) == (v, d)
        assert congestion.resident_bytes(v, d) <= congestion.RESIDENT_SMEM_BYTES


def _ring(n: int):
    """A bidirectional ring of ``n`` switches: (adj, dist) numpy."""
    adj = np.zeros((n, n), np.float32)
    for i in range(n):
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = 1
    idx = np.arange(n)
    gap = np.abs(idx[:, None] - idx[None, :])
    return adj, np.minimum(gap, n - gap).astype(np.float32)


def _slot_loads_from_paths(nodes, weight, neigh, v):
    """Per-slot loads of chosen paths: hop (a, b) adds to the first slot
    of a's row whose clamped neighbour is b."""
    cols = np.minimum(neigh, v - 1)
    out = np.zeros(neigh.shape, np.float64)
    for row, w in zip(nodes, weight):
        for a, b in zip(row[:-1], row[1:]):
            if a >= 0 and b >= 0:
                out[a, int(np.argmax(cols[a] == b))] += w
    return out


@pytest.mark.parametrize("name", ["fattree4", "dragonfly", "ring_empty_row"])
def test_slot_loads_scatter_to_the_plain_load(name):
    """The epilogue's scatter (``slot_loads_to_dense``): per-slot loads
    made from the plain version's own paths land on its ``[V, V]``
    float32 load bit for bit. Each case holds no-candidate picks: on the
    fabrics a flow whose hop count at one node is raised finds no
    neighbour one closer and takes slot 0; on the ring one switch's
    neighbour row is empty, so its pick is slot 0 clamped to V-1, a real
    switch there."""
    rng = np.random.default_rng(7)
    if name == "ring_empty_row":
        adj, dist = _ring(9)
        v = adj.shape[0]
        neigh = neighbor_rows(t_(adj) > 0, 2)
        neigh[2] = v  # switch 2 lists no neighbour
        src = np.array([2, 2, 1, 0, 3, 2], np.int32)
        dst = np.array([4, 5, 4, 4, 0, 2], np.int32)
    else:
        adj, _, dist, _ = _fabric(name)
        v = adj.shape[0]
        neigh = neighbor_rows(t_(adj) > 0, int((adj > 0).sum(axis=1).max()))
        real = np.nonzero(adj.sum(axis=1) > 0)[0]
        src = rng.choice(real, 60).astype(np.int32)
        dst = rng.choice(real, 60).astype(np.int32)
        # no neighbour of src[0] is one hop closer to dst[0] than this
        dist = dist.copy()
        dist[src[0], dst[0]] += 2
        dist[src[1], dst[1]] += 2
    weight = rng.integers(1, 5, len(src)).astype(np.float32)
    base = np.zeros(adj.shape, np.float32)
    max_len = v + 4
    nodes, load, maxc = congestion.route_flows_balanced_plain(
        t_(adj), t_(dist), t_(base), t_(src), t_(dst), t_(weight), max_len, chunk=1,
        neigh=neigh)
    nodes = nodes.numpy()
    # every flow ended at its destination, so every add is a hop of its path
    last = nodes[np.arange(len(src)), (nodes >= 0).sum(axis=1) - 1]
    np.testing.assert_array_equal(last, dst)
    cols = np.minimum(neigh.numpy(), v - 1)
    no_cand = [(a, b) for row in nodes for a, b in zip(row[:-1], row[1:])
               if a >= 0 and b >= 0 and dist[b, row[(row >= 0).sum() - 1]]
               != dist[a, row[(row >= 0).sum() - 1]] - 1]
    assert no_cand and all(b == cols[a, 0] for a, b in no_cand)
    if name == "ring_empty_row":
        assert (2, v - 1) in no_cand
    slots = _slot_loads_from_paths(nodes, weight, neigh.numpy(), v)
    dense = congestion.slot_loads_to_dense(torch.from_numpy(slots), neigh, v)
    assert dense.dtype == torch.float32 and dense.shape == (v, v)
    assert torch.equal(dense, load)
    assert torch.equal(dense, congestion.link_loads_from_paths(t_(nodes), v, t_(weight)))
    assert float(torch.where(t_(adj) > 0, dense, 0.0).max()) == float(maxc)

"""Kernels K1 (BFS) and K2 (path sampler) of sdnmpi_tpu_torch against
the JAX package, on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version;
these tests hold that plain version against the Pallas kernel (interpret
mode) and the XLA formulation on the same numpy inputs. The CUDA
kernels themselves are held against the plain versions on the card by
``chip_smoke.py``.

Distances must agree exactly. Sampled slots follow the near-tie rule:
``torch.log`` and XLA's ``log`` differ by up to 9.5e-7 on the Gumbel
term, so a flow's slots must match exactly up to its first decision whose
top-two score margin, recomputed in float64 from the reference's inputs
and the same hash chain, is below ``NEAR_TIE``; after such a decision the
port's path only has to be a valid shortest path. Near-ties must stay
rare (at most 0.1% of scored decisions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnmpi_tpu.kernels.bfs import bfs_distances_pallas
from sdnmpi_tpu.kernels.sampler import sample_slots_pallas
from sdnmpi_tpu.oracle import dag as jdag
from sdnmpi_tpu.oracle.apsp import apsp_distances as j_apsp
from sdnmpi_tpu.oracle.engine import tensorize as j_tensorize
from sdnmpi_tpu.topogen import fattree as j_fattree
from sdnmpi_tpu_torch import native
from sdnmpi_tpu_torch.kernels import bfs, sampler

#: top-two score margin below which a sampled decision may flip between
#: torch.log and XLA's log (2 x 9.5e-7 on the noise, plus f32 rounding)
NEAR_TIE = 4e-6
#: the share of scored decisions that may be near-ties
MAX_NEAR_TIE_SHARE = 1e-3


def t_(x, dtype=None):
    """numpy/JAX array -> CPU torch tensor (a copy)."""
    out = torch.tensor(np.asarray(x))
    return out if dtype is None else out.to(dtype)


# -- reference noise and near-tie analysis (numpy, float64) ----------------


def np_hash_u32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def np_uniform(f: int, v: int, hop: int, salt: int, fid_base: int = 0) -> np.ndarray:
    """The sampler's f32 uniforms of hop ``hop`` for flows fid_base ..
    fid_base+f-1 over nodes 0..v-1, from numpy uint32 arithmetic
    (independent of torch)."""
    with np.errstate(over="ignore"):
        ids = (np.arange(f, dtype=np.uint64) + np.uint64(fid_base)) & np.uint64(0xFFFFFFFF)
        fid = ids.astype(np.uint32) * np.uint32(2654435761)
        node = np.arange(v, dtype=np.uint32) * np.uint32(0x85EBCA77)
        hh = np.uint32(((hop + 1) * 0x9E3779B1 + (salt & 0xFFFFFFFF)) & 0xFFFFFFFF)
        u = np_hash_u32(fid[:, None] ^ node[None, :] ^ hh)
    bits = np.uint32(0x3F800000) | (u >> np.uint32(9)) | np.uint32(1)
    return bits.view(np.float32) - np.float32(1.0)


def near_ties(lw_bf, dist, src, dst, ref_nodes, hops, salt, dst_nodes=None,
              fid_base=0):
    """Walk the reference's paths and return ``(first near-tie hop per
    flow (hops = none), number of scored multi-candidate decisions)``.

    ``lw_bf`` is the reference's bf16 log-weight matrix as f32 numpy,
    ``ref_nodes`` its ``[F, hops]`` node sequence."""
    lw = np.asarray(lw_bf, np.float64)
    d = np.where(np.isfinite(dist), dist, 16384.0).astype(np.float64)
    src = np.asarray(src)
    dst = np.asarray(dst)
    f, v = len(src), lw.shape[0]
    d2t = d[:, np.maximum(dst, 0)].T  # [F, V]
    first = np.full(f, hops, np.int64)
    scored = 0
    for h in range(hops):
        node = ref_nodes[:, h]
        live = (node >= 0) & (node != dst)
        safe = np.maximum(node, 0)
        lwrow = lw[safe]
        cand = (lwrow > -1e3) & (d2t == d2t[np.arange(f), safe][:, None] - 1.0)
        cand &= live[:, None]
        un = np_uniform(f, v, h, salt, fid_base).astype(np.float64)
        score = np.where(cand, lwrow - np.log(-np.log(un)), -np.inf)
        top2 = -np.sort(-score, axis=1)[:, :2]
        multi = cand.sum(axis=1) >= 2
        scored += int(multi.sum())
        margin = np.where(multi, top2[:, 0] - np.where(multi, top2[:, 1], 0.0), np.inf)
        tie = multi & (margin < NEAR_TIE) & (first == hops)
        first[tie] = h
    return first, scored


def assert_slots_match(got, ref, first_tie, adj, src, dst, dist, scored):
    """The near-tie rule: exact slots before each flow's first near-tie,
    a valid shortest path after it; few near-ties. Returns the number of
    flows that had a near-tie."""
    got = np.asarray(got)
    ref = np.asarray(ref)
    hops = got.shape[1]
    before = np.arange(hops)[None, :] < first_tie[:, None]
    np.testing.assert_array_equal(np.where(before, got, 0), np.where(before, ref, 0))
    n_ties = int((first_tie < hops).sum())
    assert n_ties <= MAX_NEAR_TIE_SHARE * scored, (n_ties, scored)
    tied = first_tie < hops
    if tied.any():
        assert_valid_paths(adj, src[tied], dst[tied], got[tied], dist)
    print(f"near-ties: {n_ties} of {scored} scored decisions")
    return n_ties


def assert_valid_paths(adj, src, dst, slots, dist):
    """Decoded paths run over real links with dist+1 nodes (the sampled
    stream covers every hop but the forced last one)."""
    adj = np.asarray(adj)
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    nodes = native.decode_slots(
        np.asarray(slots, np.int8), native.neighbor_order(adj), src, dst,
        complete=True,
    )
    dist = np.asarray(dist)
    live = (src >= 0) & (dst >= 0)
    reach = live & np.isfinite(dist[np.maximum(src, 0), np.maximum(dst, 0)])
    length = (nodes >= 0).sum(axis=1)
    want = np.where(reach, dist[np.maximum(src, 0), np.maximum(dst, 0)] + 1, 0)
    covered = reach & (want <= slots.shape[1] + 2)
    np.testing.assert_array_equal(length[covered], want[covered])
    a, b = nodes[:, :-1], nodes[:, 1:]
    hop = (a >= 0) & (b >= 0)
    assert (adj[a[hop], b[hop]] > 0).all()


# -- K1 ---------------------------------------------------------------------


def _random_digraph(seed: int, v: int, p: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    adj = (rng.random((v, v)) < p).astype(np.float32)
    np.fill_diagonal(adj, 0.0)
    return adj


def _fattree_adj(k: int, pad: int = 128) -> np.ndarray:
    t = j_tensorize(j_fattree(k).to_topology_db(backend="jax"), pad_multiple=pad)
    return np.asarray(t.adj)


@pytest.mark.parametrize(
    "name,levels",
    [("fattree4", 4), ("fattree4", 2), ("random128", 12), ("random128", 3),
     ("path", 2)],
)
def test_bfs_plain_matches_pallas_and_apsp(name, levels):
    """Exact equality with the Pallas kernel in interpret mode (which runs
    exactly ``levels`` steps) and, at a full budget, with XLA's APSP."""
    if name == "fattree4":
        adj = _fattree_adj(4)
    elif name == "random128":
        adj = _random_digraph(1, 128, 0.03)
    else:
        adj = np.zeros((128, 128), np.float32)
        for i in range(6):
            adj[i, i + 1] = 1.0
    got = bfs.bfs_distances_plain(t_(adj), levels).numpy()
    ref = np.asarray(bfs_distances_pallas(jnp.asarray(adj), levels=levels, interpret=True))
    np.testing.assert_array_equal(got, ref)
    full = np.asarray(j_apsp(jnp.asarray(adj)))
    span = int(full[np.isfinite(full)].max())
    if levels >= span:
        np.testing.assert_array_equal(got, full)
    else:
        # truncation: pairs farther than the budget read unreachable
        assert np.isinf(got[full > levels]).all()


@pytest.mark.parametrize("seed,v", [(3, 40), (4, 57)])
def test_bfs_plain_matches_apsp_off_lane_sizes(seed, v):
    """V that is no multiple of 128 (the Pallas grid cannot tile it): the
    plain version against XLA's APSP, full budget and truncated."""
    adj = _random_digraph(seed, v, 0.06)
    full = np.asarray(j_apsp(jnp.asarray(adj)))
    span = int(full[np.isfinite(full)].max())
    np.testing.assert_array_equal(bfs.bfs_distances_plain(t_(adj), span).numpy(), full)
    cut = bfs.bfs_distances_plain(t_(adj), 2).numpy()
    np.testing.assert_array_equal(cut, np.where(full <= 2, full, np.inf))


def test_bfs_wrapper_takes_plain_version_on_cpu():
    adj = t_(_random_digraph(5, 64, 0.05))
    before = bfs.bfs_distances.launches
    torch.testing.assert_close(
        bfs.bfs_distances(adj, 7), bfs.bfs_distances_plain(adj, 7), rtol=0, atol=0
    )
    assert bfs.bfs_distances.launches == before  # CPU calls launch nothing
    with pytest.raises(ValueError):
        bfs.bfs_distances(adj[:, :10], 3)


# -- K2 ---------------------------------------------------------------------


def test_hash_and_uniform_match_uint32_reference():
    """The int64-held hash (torch has no uint32 >> on the CPU) and the
    mantissa-bitcast uniform equal numpy's uint32 arithmetic bit for bit."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 50_000, dtype=np.uint64)
    got = sampler._hash_u32(torch.tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), np_hash_u32(x))
    f, v = 37, 29
    mix = sampler._mul32(torch.arange(f, dtype=torch.int64), 2654435761)[:, None] ^ (
        sampler._mul32(torch.arange(v, dtype=torch.int64), 0x85EBCA77)[None, :]
    )
    for hop, salt in ((0, 0), (3, 9), (5, 2**32 + 7)):
        un_ref = np_uniform(f, v, hop, salt)
        g = sampler.gumbel_noise(mix, hop, salt).numpy()
        # the uniform is exact; only the two logs may round differently
        np.testing.assert_allclose(g, -np.log(-np.log(un_ref.astype(np.float64))),
                                   rtol=0, atol=2e-6)


@pytest.fixture(scope="module")
def sampler_problem():
    """Balanced k=4 fat-tree weights (JAX), random flows with padding."""
    db = j_fattree(4).to_topology_db(backend="jax")
    t = j_tensorize(db, pad_multiple=128)
    dist = j_apsp(t.adj)
    v = t.adj.shape[0]
    rng = np.random.default_rng(7)
    traffic = np.zeros((v, v), np.float32)
    edges = np.array(sorted({t.index[h.port.dpid] for h in db.hosts.values()}))
    for a in edges:
        for b in edges:
            if a != b:
                traffic[b, a] = rng.integers(1, 9)
    weights, _, _ = jdag.balance_rounds(
        t.adj, dist, jnp.zeros((v, v)), jnp.asarray(traffic), levels=4, rounds=2
    )
    f = 600
    src = rng.integers(-1, t.n_real, f).astype(np.int32)
    dst = rng.choice(edges, f).astype(np.int32)
    dst[::50] = -1
    dst_nodes = jdag.make_dst_nodes(dst)
    return {
        "adj": np.asarray(t.adj), "dist": np.asarray(dist),
        "weights": np.asarray(weights), "src": src, "dst": dst,
        "dst_nodes": dst_nodes,
    }


def _jax_lw(weights) -> np.ndarray:
    """The reference's bf16 log-weight expression (sampler.py:270-272)."""
    w = jnp.asarray(weights)
    return np.asarray(
        jnp.where(w > 0.0, jnp.log(jnp.maximum(w, 1e-30)), -1e4)
        .astype(jnp.bfloat16).astype(jnp.float32)
    )


@pytest.mark.parametrize("hops,salt,layout", [
    (3, 0, "full"), (3, 5, "dst_nodes"), (5, 11, "full"), (2, 3, "dst_nodes"),
])
def test_sampler_plain_matches_pallas_and_xla(sampler_problem, hops, salt, layout):
    """The plain version, fed the reference's own bf16 log weights,
    against the Pallas kernel (interpret mode) and XLA's dense sampler,
    under the near-tie rule."""
    p = sampler_problem
    lw = _jax_lw(p["weights"])
    dn = p["dst_nodes"] if layout == "dst_nodes" else None
    ref_nodes, ref_slots = jdag.sample_paths_dense(
        jnp.asarray(p["weights"]), jnp.asarray(p["dist"]), jnp.asarray(p["src"]),
        jnp.asarray(p["dst"]), hops, salt=salt,
        dst_nodes=None if dn is None else jnp.asarray(dn),
    )
    pallas = sample_slots_pallas(
        jnp.asarray(p["weights"]), jnp.asarray(p["dist"]), jnp.asarray(p["src"]),
        jnp.asarray(p["dst"]), hops, salt=salt, interpret=True,
        dst_nodes=None if dn is None else jnp.asarray(dn),
    )
    np.testing.assert_array_equal(np.asarray(pallas), np.asarray(ref_slots))
    _, got = sampler.sample_paths_lw(
        t_(lw, torch.bfloat16), t_(p["dist"]), t_(p["src"]), t_(p["dst"]), hops,
        salt=salt, dst_nodes=None if dn is None else t_(dn),
    )
    first, scored = near_ties(
        lw, p["dist"], p["src"], p["dst"], np.asarray(ref_nodes), hops, salt
    )
    assert scored > 0
    assert_slots_match(
        got.numpy(), np.asarray(ref_slots), first, p["adj"], p["src"], p["dst"],
        p["dist"], scored,
    )


def test_sampler_layouts_and_wrapper_agree(sampler_problem):
    """Full and destination-set layouts give identical slots, and the
    wrapper takes the plain version on the CPU without a launch."""
    p = sampler_problem
    args = (t_(p["weights"]), t_(p["dist"]), t_(p["src"]), t_(p["dst"]), 3)
    _, full = sampler.sample_paths_dense(*args, salt=4)
    _, restricted = sampler.sample_paths_dense(*args, salt=4, dst_nodes=t_(p["dst_nodes"]))
    torch.testing.assert_close(full, restricted, rtol=0, atol=0)
    before = sampler.sample_slots.launches
    wrapped = sampler.sample_slots(*args, salt=4, dst_nodes=t_(p["dst_nodes"]))
    torch.testing.assert_close(wrapped, full, rtol=0, atol=0)
    assert sampler.sample_slots.launches == before
    # a destination missing from the set reads unroutable
    missing = t_(p["dst_nodes"]).clone()
    missing[0] = -1
    gone = int(p["dst_nodes"][0])
    _, cut = sampler.sample_paths_dense(*args, salt=4, dst_nodes=missing)
    rows = (p["dst"] == gone) & (p["src"] >= 0) & (p["src"] != gone)
    assert rows.any() and (cut.numpy()[rows] == -1).all()

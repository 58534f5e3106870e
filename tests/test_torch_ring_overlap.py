"""K3's step form and the overlapped exchange against the JAX package, on
the CPU.

- The plain step form, run over every step, equals the port's
  ``ring_all_gather_plain`` and the reference's ``ring_all_gather`` (its
  ppermute twin, on virtual CPU devices) at s in {2, 3, 8} on the bf16,
  int16 and int32 wires, with an uneven final block; so does a whole
  ``RingExchange``.
- Step t lands at shard ``me`` exactly the blocks whose
  ``arrival_steps(me, s)`` is t, and nothing else: every other row of the
  view still holds the poison sentinel.
- A poisoned exchange (``ring.POISON``: every view starts as a sentinel,
  NaN on the distance wire, a value outside ``[-1, V)`` on the next-hop
  wire, and on the CPU a step lands only when a consumer waits for it):
  ``ring_stream``, ``batch_fdb_ringed``, ``apsp_next_hops_ringed`` and
  ``route_collective_sharded(ring_exchange=True)`` still equal the
  reference's ``ring_stream``, ``_batch_fdb_ringed_fn``,
  ``apsp_next_hops_ringed`` and ``_dag_step_ringed``. So no consumer
  reads a block before its wait. The collective's slots follow
  ``test_torch_shardplane``'s near-tie rule against the reference and
  are bit-equal to the port's gather mode; its fractional congestion
  agrees to rtol 1e-5 (f32 sums in another order).

The CUDA step kernel, the exchange stream and the overlap are held on
the card by ``chip_smoke.py`` phase 26.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnmpi_tpu import shardplane as jshard
from sdnmpi_tpu.kernels import ring as jring
from sdnmpi_tpu.oracle import dag as jdag
from sdnmpi_tpu.shardplane import make_mesh as j_make_mesh
from sdnmpi_tpu_torch import shardplane as pshard
from sdnmpi_tpu_torch.convert import gather_rows, shard_rows
from sdnmpi_tpu_torch.kernels import ring
from sdnmpi_tpu_torch.shardplane import mesh as pmesh
from tests.conftest import N_VIRTUAL_DEVICES
from tests.test_torch_kernels import _jax_lw, assert_slots_match, near_ties
from tests.test_torch_ring import _DTYPES, _rows, to_numpy, to_torch
from tests.test_torch_shard_legs import _chase_problem
from tests.test_torch_shardplane import TOPOS, _tensors
from tests.test_torch_shardplane import collective  # noqa: F401  (fixture)


def t_(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture
def poisoned(monkeypatch):
    monkeypatch.setattr(ring, "POISON", True)


@pytest.fixture(scope="module")
def p_mesh():
    return pmesh.make_mesh(N_VIRTUAL_DEVICES, device="cpu")


def _blocks(s, r, dtype, seed):
    """``[r, 24]`` rows of ``dtype`` cut into s blocks as ``shard_rows``
    cuts them (the final blocks short when s does not divide r)."""
    x = _rows(np.random.default_rng(seed), r, 24, dtype)
    b = -(-r // s)
    return x, [to_torch(x[q * b:(q + 1) * b]) for q in range(s)]


# -- the step form ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bf16", "int16", "int32"])
@pytest.mark.parametrize("s,r", [(2, 15), (3, 20), (8, 61)])
def test_steps_equal_the_gather(s, r, dtype, virtual_mesh):
    """Steps 0..max(ring_legs) of the plain step form (and the wrapper on
    CPU tensors, and a whole RingExchange) leave every shard's view equal
    to ring_all_gather_plain's output and to the reference's
    ring_all_gather; no launch is counted."""
    x, blocks = _blocks(s, r, dtype, seed=s * 31 + r)
    jm = virtual_mesh if s == N_VIRTUAL_DEVICES else j_make_mesh(s)
    want = np.asarray(jring.ring_all_gather(jnp.asarray(x), jm))
    np.testing.assert_array_equal(want.view(np.uint8), x.view(np.uint8))
    padded, b, _ = ring._padded_blocks(blocks)
    gathered = ring.ring_all_gather_plain(padded)
    launches = ring.ring_step.launches
    for step_fn in (ring.ring_step_plain, ring.ring_step):
        views = torch.zeros((s, s * b, 24), dtype=_DTYPES[dtype][1])
        for t in range(max(ring.ring_legs(s)) + 1):
            step_fn(padded, views, t)
        for me in range(s):
            assert torch.equal(views[me], gathered[me])
            np.testing.assert_array_equal(to_numpy(views[me][:r]).view(np.uint8),
                                          x.view(np.uint8))
    ex = ring.RingExchange(blocks)
    ex.join()
    for me in range(s):
        np.testing.assert_array_equal(to_numpy(ex.view(me)).view(np.uint8),
                                      x.view(np.uint8))
    assert ring.ring_step.launches == launches


@pytest.mark.parametrize("dtype", ["bf16", "int16", "int32"])
@pytest.mark.parametrize("s,r", [(2, 15), (3, 20), (8, 61)])
def test_step_lands_its_arrivals_only(s, r, dtype, poisoned):
    """After the consumer waits for step t, shard me's view holds exactly
    the blocks whose arrival step at me is at most t; the rest still hold
    the sentinel. ``origins`` names step t's arrivals, cw first."""
    x, blocks = _blocks(s, r, dtype, seed=7 * s + r)
    ex = ring.RingExchange(blocks)
    b = ex.b
    dt = _DTYPES[dtype][1]
    sentinel = to_numpy(torch.full((1,), ring._sentinel(dt), dtype=dt)).view(np.uint8)
    steps = [ring.arrival_steps(me, s) for me in range(s)]
    for t in range(ex.last + 1):
        ex.wait(t)
        for me in range(s):
            assert sorted(ex.origins(me, t)) == [q for q in range(s) if steps[me][q] == t]
            view = to_numpy(ex.views[me]).view(np.uint8)
            for q in range(s):
                rows = slice(q * b, min((q + 1) * b, r))
                got = view[rows]
                if steps[me][q] <= t:
                    np.testing.assert_array_equal(got, x[rows].view(np.uint8))
                else:
                    assert (got.reshape(got.shape[0], -1, sentinel.size)
                            == sentinel.ravel()).all()


def test_step_refuses_what_it_does_not_take():
    blocks = [torch.zeros((4, 3), dtype=torch.int16) for _ in range(3)]
    views = torch.zeros((3, 12, 3), dtype=torch.int16)
    with pytest.raises(ValueError, match="step 2"):
        ring.ring_step(blocks, views, 2)
    with pytest.raises(ValueError, match="views"):
        ring.ring_step(blocks, views[:, :8], 1)
    with pytest.raises(ValueError, match="views"):
        ring.ring_step(blocks, views.to(torch.int32), 1)
    with pytest.raises(ValueError, match="equal"):
        ring.ring_step(blocks[:2] + [torch.zeros((3, 3), dtype=torch.int16)], views, 1)


@pytest.mark.parametrize("s", [2, 3, 8])
def test_poisoned_ring_stream_keeps_the_reference_order(s, poisoned):
    """ring_stream hands every shard each block once, in the reference's
    (origin, step) order, and every block it hands over has landed."""
    from tests.test_torch_ring import _reference_order

    _, order = _reference_order(s)
    mesh = pmesh.make_mesh(s, device="cpu")
    blocks = [torch.full((2, 3), q, dtype=torch.int32) for q in range(s)]

    def consume(seen, blk, src, step):
        assert (blk == src).all(), "a block was read before its step landed"
        return seen + [(src, step)]

    got = ring.ring_stream(mesh, blocks, consume, [[] for _ in range(s)])
    for me in range(s):
        assert got[me] == [tuple(x) for x in order[me].tolist()]


# -- the consumers under a poisoned exchange --------------------------------


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_poisoned_chase_matches_the_reference(topo, virtual_mesh, p_mesh, poisoned):
    """batch_fdb_ringed from row-sharded next hops under the poisoned
    exchange equals the reference's ringed chase."""
    t, nxt, src, dst, fport, max_len = _chase_problem(topo, seed=11)
    j_args = (jnp.asarray(nxt), t.port, jnp.asarray(src), jnp.asarray(dst),
              jnp.asarray(fport), max_len)
    want = [np.asarray(x) for x in jshard.batch_fdb_ringed(*j_args, virtual_mesh)]
    got = pshard.batch_fdb_ringed(shard_rows(nxt, p_mesh), t_(t.port), t_(src),
                                  t_(dst), t_(fport), max_len, p_mesh)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.concatenate([x.numpy() for x in g]), w)


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_poisoned_next_hops_match_the_reference(topo, virtual_mesh, p_mesh, poisoned):
    """apsp_next_hops_ringed (the column pipeline) under the poisoned
    exchange equals the reference's apsp_next_hops_ringed."""
    t = _tensors(TOPOS[topo]())
    j_dist = jshard.apsp_distances_rowsharded(t.adj, virtual_mesh)
    want = np.asarray(jshard.apsp_next_hops_ringed(t.adj, j_dist, virtual_mesh,
                                                   t.max_degree))
    adj = t_(t.adj)
    dist = pshard.apsp_distances_rowsharded(adj, p_mesh)
    got = pshard.apsp_next_hops_ringed(adj, dist, p_mesh, t.max_degree)
    np.testing.assert_array_equal(gather_rows(got), want)


def test_poisoned_collective_matches_the_reference(collective, virtual_mesh,  # noqa: F811
                                                   p_mesh, monkeypatch):
    """route_collective_sharded(ring_exchange=True) under the poisoned
    exchange: slots under the near-tie rule against the reference's
    ``_dag_step_ringed``, bit-equal to the port's unpoisoned ring and
    gather modes; fractional congestion to rtol 1e-5."""
    p = collective
    kw = dict(levels=p["levels"], rounds=2, max_len=p["levels"] + 1, salt=5)
    j_slots, j_maxc = jshard.route_collective_sharded(
        *(jnp.asarray(p[k]) for k in ("adj", "li", "lj", "util", "traffic", "src",
                                      "dst")),
        virtual_mesh, dist=jnp.asarray(p["dist"]), ring_exchange=True, **kw,
    )
    args = [t_(p[k]) for k in ("adj", "li", "lj", "util", "traffic", "src", "dst")]
    runs = {}
    for name, ring_mode, poison in (("gather", False, False), ("ring", True, False),
                                    ("poisoned", True, True)):
        monkeypatch.setattr(ring, "POISON", poison)
        slots, maxc = pshard.route_collective_sharded(
            *args, p_mesh, dist=shard_rows(p["dist"], p_mesh),
            ring_exchange=ring_mode, **kw,
        )
        runs[name] = (gather_rows(slots), float(maxc))
    got, maxc = runs["poisoned"]
    for name in ("gather", "ring"):
        np.testing.assert_array_equal(got, runs[name][0], name)
        assert maxc == runs[name][1], name
    np.testing.assert_allclose(maxc, float(j_maxc), rtol=1e-5)
    v = p["adj"].shape[0]
    w, _, _ = jdag.balance_rounds(
        jnp.asarray(p["adj"]), jnp.asarray(p["dist"]), jnp.zeros((v, v)),
        jnp.asarray(p["traffic"]), levels=p["levels"], rounds=2,
    )
    hops = jdag.sampled_hops(kw["max_len"])
    ref_nodes, _ = jdag.sample_paths_dense(
        w, jnp.asarray(p["dist"]), jnp.asarray(p["src"]), jnp.asarray(p["dst"]),
        hops, salt=5,
    )
    first, scored = near_ties(
        _jax_lw(w), p["dist"], p["src"], p["dst"], np.asarray(ref_nodes), hops, 5
    )
    assert scored > 0
    assert_slots_match(got, np.asarray(j_slots), first, p["adj"], p["src"],
                       p["dst"], p["dist"], scored)


def test_poisoned_distance_exchange_is_exact(p_mesh, poisoned):
    """The blocking distance exchange on both wires (bf16 at V = 256,
    int16 at V = 320) under the poison returns the input, inf kept."""
    rng = np.random.default_rng(9)
    for v in (256, 320):
        d = rng.integers(0, 200, (64, v)).astype(np.float32)
        d[rng.random(d.shape) < 0.1] = np.inf
        for g in ring.exchange_distances(shard_rows(d, p_mesh), p_mesh):
            np.testing.assert_array_equal(g.numpy(), d)

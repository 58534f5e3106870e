"""Kernel K3 (the ring all-gather) and the port's shard mesh against the
JAX package, on the CPU.

On CPU tensors the port's ``ring_all_gather`` runs its plain version,
the reference's schedule as torch copies. It is held bit for bit against
the reference's ``ring_all_gather(x, mesh)`` (its ppermute twin of the
same schedule: the Pallas interpreter path is red in the reference's own
suite), ``lax.all_gather`` and numpy on the 8-device virtual mesh, and
against 2- and 3-device meshes. Wire packing, the schedule functions and
``ring_stream``'s delivery order must equal the reference's exactly. The
CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from sdnmpi_tpu.kernels import ring as jring
from sdnmpi_tpu.shardplane import make_mesh as j_make_mesh
from sdnmpi_tpu.shardplane import mesh as jmesh
from sdnmpi_tpu.shardplane.mesh import P
from sdnmpi_tpu_torch.convert import gather_rows, shard_rows
from sdnmpi_tpu_torch.kernels import ring
from sdnmpi_tpu_torch.shardplane import mesh as pmesh

_DTYPES = {
    "bf16": (jnp.bfloat16, torch.bfloat16),
    "int16": (np.int16, torch.int16),
    "int32": (np.int32, torch.int32),
    "f32": (np.float32, torch.float32),
}


def to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy (including ml_dtypes bf16) -> CPU torch tensor, bit for bit."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(jnp.bfloat16)
    return t.numpy()


def _hop_rows(rng, r, c, vmax=200):
    vals = rng.integers(0, vmax, (r, c)).astype(np.float32)
    return np.where(rng.random((r, c)) < 0.1, np.inf, vals).astype(np.float32)


def _rows(rng, r, c, dtype):
    jdt, _ = _DTYPES[dtype]
    if dtype == "bf16":
        return rng.integers(-256, 256, (r, c)).astype(np.float32).astype(jdt)
    return rng.integers(-30000, 30000, (r, c)).astype(jdt)


@pytest.fixture(scope="module")
def p_mesh8():
    return pmesh.make_mesh(8, device="cpu")


# -- wire packing -------------------------------------------------------


@pytest.mark.parametrize("v", [257, 258, 4096, ring.NEXT_WIRE_MAX_V,
                               ring.NEXT_WIRE_MAX_V + 1])
def test_wire_packing_bit_equal(v):
    """The dtype rule (bf16 up to V = 257, int16 from 258 to 2**15, f32
    past it) and the packed bits, inf included, equal the reference's."""
    hi = min(v - 1, 4095)
    vals = np.concatenate([
        np.arange(0, min(hi, 300) + 1, dtype=np.float32),
        np.array([hi, np.inf], np.float32),
    ]).reshape(1, -1)
    want = jring.pack_dist_wire(jnp.asarray(vals), v)
    got = ring.pack_dist_wire(torch.from_numpy(vals), v)
    assert np.dtype(want.dtype) == np.dtype(to_numpy(got).dtype)
    np.testing.assert_array_equal(to_numpy(got).view(np.uint8),
                                  np.asarray(want).view(np.uint8))
    np.testing.assert_array_equal(
        ring.unpack_dist_wire(got).numpy(), np.asarray(jring.unpack_dist_wire(want))
    )
    np.testing.assert_array_equal(ring.unpack_dist_wire(got).numpy(), vals)


def test_next_wire_and_constants_match():
    assert ring.WIRE_EXACT_MAX_HOPS == jring.WIRE_EXACT_MAX_HOPS
    assert ring.NEXT_WIRE_MAX_V == jring.NEXT_WIRE_MAX_V
    vals = np.array([-1, 0, 1, 127, 128, 255, 4095, ring.NEXT_WIRE_MAX_V - 1],
                    np.int32)
    got = ring.pack_next_wire(torch.from_numpy(vals))
    want = np.asarray(jring.pack_next_wire(jnp.asarray(vals)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ring.unpack_next_wire(got).numpy(), vals)
    assert ring.unpack_next_wire(got).dtype == torch.int32


# -- the schedule -------------------------------------------------------


def _reference_order(s: int):
    """The reference's arrival_steps and ring_stream delivery order
    ((origin, step) per consume) on an s-device virtual mesh."""
    mesh = j_make_mesh(s)
    axes = jmesh.mesh_axes(mesh)

    @jax.jit
    @functools.partial(
        jmesh.shard_map, mesh=mesh, in_specs=P(axes),
        out_specs=(P(axes, None), P(axes, None, None)), check_vma=False,
    )
    def run(x):
        def consume(carry, _blk, src, step):
            order, k = carry
            return order.at[k].set(jnp.stack([src, jnp.int32(step)])), k + 1

        order, _ = jring.ring_stream(
            mesh, x, consume, (jnp.zeros((s, 2), jnp.int32), jnp.int32(0))
        )
        return jring.arrival_steps(mesh)[None, :], order[None]

    steps, order = run(jnp.arange(s, dtype=jnp.int32))
    return np.asarray(steps), np.asarray(order)


@pytest.mark.parametrize("s", range(1, 9))
def test_schedule_matches_reference(s):
    """ring_legs, ring_perms, exchange_bytes, arrival_steps per shard and
    ring_stream's (origin, step) order equal the reference's."""
    assert ring.ring_legs(s) == jring.ring_legs(s)
    assert ring.ring_perms(s) == jring.ring_perms(s)
    for r, c, item in ((4096, 4096, 2), (52, 128, 4), (3968, 1984, 2)):
        assert ring.exchange_bytes(r, c, s, item) == jring.exchange_bytes(r, c, s, item)
    steps, order = _reference_order(s)
    mesh = pmesh.make_mesh(s, device="cpu")
    blocks = [torch.full((1, 1), q, dtype=torch.int32) for q in range(s)]

    def consume(seen, blk, src, step):
        assert int(blk[0, 0]) == src
        return seen + [(src, step)]

    got = ring.ring_stream(mesh, blocks, consume, [[] for _ in range(s)])
    for me in range(s):
        assert ring.arrival_steps(me, s) == steps[me].tolist()
        assert got[me] == [tuple(x) for x in order[me].tolist()]


# -- the gather ---------------------------------------------------------


@pytest.mark.parametrize("s,r,c,dtype", [
    (8, 64, 256, "int32"), (8, 52, 128, "int16"), (8, 60, 96, "bf16"),
    (8, 64, 64, "f32"), (3, 20, 64, "int32"), (3, 18, 32, "bf16"),
    (2, 16, 128, "int16"), (2, 15, 8, "int32"),
])
def test_gather_matches_reference(s, r, c, dtype, virtual_mesh):
    """The plain version == the reference's ring_all_gather (the ppermute
    twin) == numpy, every shard's copy; == lax.all_gather where R
    divides by s. Uneven R pads onto the wire and trims back."""
    rng = np.random.default_rng(s * 100 + r)
    x = _rows(rng, r, c, dtype)
    jm = virtual_mesh if s == 8 else j_make_mesh(s)
    want = np.asarray(jring.ring_all_gather(jnp.asarray(x), jm))
    np.testing.assert_array_equal(want.view(np.uint8), x.view(np.uint8))
    if r % s == 0:
        axes = jmesh.mesh_axes(jm)
        allg = jax.jit(functools.partial(
            jmesh.shard_map, mesh=jm, in_specs=P(axes, None),
            out_specs=P(None, None), check_vma=False,
        )(lambda b: lax.all_gather(b, axes, axis=0, tiled=True)))
        np.testing.assert_array_equal(np.asarray(allg(jnp.asarray(x))).view(np.uint8),
                                      x.view(np.uint8))
    mesh = pmesh.make_mesh(s, device="cpu")
    b = -(-r // s)
    blocks = [to_torch(x[q * b:(q + 1) * b]) for q in range(s)]
    out = ring.ring_all_gather(blocks, mesh)
    assert len(out) == s
    for o in out:
        assert o.shape == (r, c) and o.dtype == _DTYPES[dtype][1]
        np.testing.assert_array_equal(to_numpy(o).view(np.uint8), x.view(np.uint8))
    assert ring.ring_all_gather.launches == 0  # CPU calls launch nothing


def test_exchange_distances_match_reference(p_mesh8, virtual_mesh):
    """The packed distance exchange on both wires (bf16 at V = 256,
    int16 at V = 320) equals the reference's and the input, inf kept."""
    rng = np.random.default_rng(3)
    for v in (256, 320):
        d = _hop_rows(rng, 64, v, vmax=min(v, ring.WIRE_EXACT_MAX_HOPS))
        want = np.asarray(jring.exchange_distances(jnp.asarray(d), virtual_mesh))
        got = ring.exchange_distances(shard_rows(d, p_mesh8), p_mesh8)
        for g in got:
            np.testing.assert_array_equal(g.numpy(), want)
        np.testing.assert_array_equal(gather_rows(shard_rows(d, p_mesh8)), d)


def test_single_shard_returns_input():
    mesh = pmesh.make_mesh(1, device="cpu")
    x = torch.arange(6, dtype=torch.int32).reshape(3, 2)
    assert ring.ring_all_gather([x], mesh)[0] is x


# -- the mesh -----------------------------------------------------------


class _FakeDev:
    def __init__(self, pid, did):
        self.process_index = pid
        self.id = did


def test_mesh_facts_match_reference(virtual_mesh):
    for n in (1, 2, 3, 4, 6, 8):
        jm = virtual_mesh if n == 8 else j_make_mesh(n)
        pm = pmesh.make_mesh(n, device="cpu")
        assert pmesh.mesh_axes(pm) == jmesh.mesh_axes(jm)
        assert pmesh.mesh_shards(pm) == jmesh.mesh_shards(jm)
        assert pm.shape == dict(jm.shape)
        assert pm.ring == tuple(range(n))
        assert all(d == torch.device("cpu") for d in pm.devices)
    devs = [_FakeDev(p, d) for p in (1, 0) for d in (3, 0, 2, 1)]
    assert ([(d.process_index, d.id) for d in pmesh.device_ring_order(devs)]
            == [(d.process_index, d.id) for d in jmesh.device_ring_order(devs)])
    shards = pmesh.make_mesh(4, device="cpu").shards
    assert pmesh.device_ring_order(reversed(shards)) == list(shards)
    assert pmesh.host_shard_devices(3) == 3
    assert pmesh.host_shard_devices(0) == ring.MAX_SHARDS


def test_unbuildable_meshes_raise():
    """Shards on several devices of one process are later work (ROADMAP
    A4 item 1); too many shards and a missing card raise; nothing falls
    back to fewer shards. Without a process group the multi-process
    calls are the single-process mesh: ``init_multihost`` of one process
    is a no-op, ``make_multihost_mesh`` is ``make_mesh``'s mesh and it
    spans one process."""
    with pytest.raises(NotImplementedError, match="A4 item 1"):
        pmesh.ShardMesh(["cpu", "meta"])
    assert pmesh.init_multihost("h:1", 1, 0) is False
    one = pmesh.make_multihost_mesh(8, device="cpu")
    assert (one.shape, one.local, one.devices) == (
        pmesh.make_mesh(8, device="cpu").shape, tuple(range(8)), (torch.device("cpu"),) * 8)
    assert (pmesh.mesh_processes(one), one.multiprocess) == (1, False)
    with pytest.raises(ValueError):
        pmesh.make_mesh(ring.MAX_SHARDS + 1, device="cpu")
    with pytest.raises(ValueError):
        pmesh.make_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pmesh.make_mesh(8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pmesh.make_multihost_mesh(8)


def test_gather_refuses_bad_blocks(p_mesh8):
    blocks = [torch.zeros((2, 4), dtype=torch.int32) for _ in range(8)]
    with pytest.raises(ValueError):
        ring.ring_all_gather(blocks[:7], p_mesh8)
    with pytest.raises(ValueError):
        ring.ring_all_gather(blocks[:7] + [torch.zeros((2, 4))], p_mesh8)
    meta = [torch.zeros((2, 4), device="meta") for _ in range(8)]
    with pytest.raises(ValueError):
        ring.ring_all_gather(meta, p_mesh8)


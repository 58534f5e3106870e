"""K3's step form as one plan an exchange (``ring.StepPlan``), on the CPU.

- ``ring.step_args`` turns integers (block and view addresses, a block's
  bytes, s, t, the CTA count) into the step kernel's launch arguments.
  With synthetic addresses: the pointer table sends source q to the
  shards that ``step_offsets`` and ``arrival_steps`` name, at rows
  ``q*B..`` of their views; the vector path's word is the widest that
  every address and the size allow; the bulk path takes a step exactly
  when every address shares one residue mod 16 (aligned blocks, blocks
  and views both one element off), the vector path when they do not (a
  source one element off, sizes that are not a multiple of 16), in words
  of at most 8 bytes; the bulk
  split covers every byte of every copy once, its middle 16-byte aligned
  at both ends; the grids stay inside what the kernel takes.
- ``ring_step`` and ``StepPlan`` on CPU tensors raise what the step form
  refused before, and a plan launched step by step equals
  ``ring_all_gather_plain`` and the reference's ``ring_all_gather``.
- A CPU ``RingExchange`` still lands only the arrivals of the steps it
  was asked for.

The CUDA kernels (both paths) are held on the card by ``chip_smoke.py``
phase 26 (a).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnmpi_tpu.kernels import ring as jring
from sdnmpi_tpu.shardplane import make_mesh as j_make_mesh
from sdnmpi_tpu_torch.kernels import ring
from tests.conftest import N_VIRTUAL_DEVICES
from tests.test_torch_ring import _DTYPES, _rows, to_numpy, to_torch

#: a synthetic 256-byte aligned address
BASE = 0x7F00_0000_0000


def _addresses(s: int, nbytes: int, src_off: int = 0, view_off: int = 0,
               apart: bool = False):
    """Synthetic addresses as allocations lay them out: s blocks back to
    back from one base (or, ``apart``, each at an aligned base of its own,
    as ``_padded_blocks`` pads or ``pack_next_wire`` makes them), s views
    of ``s * nbytes`` back to back from another, each shifted by its offset
    in bytes."""
    step = (1 << 24) if apart else nbytes
    src = [BASE + src_off + q * step for q in range(s)]
    views = [BASE + (1 << 32) + view_off + me * s * nbytes for me in range(s)]
    return src, views


def _steps(s: int) -> range:
    return range(max(ring.ring_legs(s)) + 1)


def _copies(a: ring.StepArgs) -> list:
    """(source, destination) address pairs of a step's table."""
    out = []
    for q in range(len(a.table) // 3):
        src, *dst = a.table[3 * q:3 * q + 3]
        assert dst[0] != 0, "every source has a destination"
        out += [(src, d) for d in dst if d]
    return out


# -- the pointer table ------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2, 3, 5, 8])
def test_table_follows_the_schedule(s):
    """Source q's destinations at step t are the shards ``me`` that
    ``step_offsets(t, s)`` sends it to, cw first, at ``views[me] +
    q * nbytes``; together they are exactly the (me, q) with
    ``arrival_steps(me, s)[q] == t``."""
    nbytes = 96
    src, views = _addresses(s, nbytes)
    arrivals = [ring.arrival_steps(me, s) for me in range(s)]
    for t in _steps(s):
        a = ring.step_args(src, views, nbytes, t, ctas=64)
        assert len(a.table) == 3 * s
        landed = set()
        for q in range(s):
            assert a.table[3 * q] == src[q]
            dst = [d for d in a.table[3 * q + 1:3 * q + 3] if d]
            want = [(q - d) % s for d in ring.step_offsets(t, s)]
            assert dst == [views[me] + q * nbytes for me in want]
            landed |= {(me, q) for me in want}
        assert landed == {(me, q) for me in range(s) for q in range(s)
                          if arrivals[me][q] == t}


def test_every_block_lands_once_over_the_exchange():
    s, nbytes = 8, 160
    src, views = _addresses(s, nbytes)
    dst = [d for t in _steps(s) for _, d in _copies(ring.step_args(src, views, nbytes, t, 8))]
    assert sorted(dst) == sorted(views[me] + q * nbytes for me in range(s) for q in range(s))


# -- the path and the unit --------------------------------------------------


@pytest.mark.parametrize("s", [2, 3, 8])
def test_aligned_blocks_take_the_bulk_path(s):
    nbytes = 496 * 3968 * 2  # config 13's next-hop block, int16
    src, views = _addresses(s, nbytes)
    for t in _steps(s):
        a = ring.step_args(src, views, nbytes, t, ctas=128)
        assert a.bulk and (a.head, a.mid, a.tail) == (0, nbytes, 0)


@pytest.mark.parametrize("nbytes", [24, 16 * 100 + 8, 496 * 3968 * 2])
@pytest.mark.parametrize("src_off", [0, 2, 4, 8])
@pytest.mark.parametrize("view_off", [0, 8])
def test_the_vector_path_never_takes_sixteen_byte_words(nbytes, src_off, view_off):
    """Addresses and a size that allow 16-byte words share residue 0 and
    go bulk, so the vector path copies in 8-, 4- or 2-byte words (the
    kernel keeps no 16-byte vector copy); a source 8 bytes off fresh views
    goes vector in 8-byte words."""
    s = 8
    src, views = _addresses(s, nbytes, src_off=src_off, view_off=view_off)
    for t in _steps(s):
        a = ring.step_args(src, views, nbytes, t, ctas=128)
        assert (a.unit == 0) if a.bulk else (a.unit in (2, 4, 8))
        if (src_off, view_off, nbytes % 16) == (8, 0, 0):
            assert not a.bulk and a.unit == 8


@pytest.mark.parametrize("elem", [2, 4])
def test_a_source_off_its_alignment_takes_the_vector_path(elem):
    """Blocks one element into an allocation (``_padded_blocks`` keeps such
    slices) share no residue with fresh views: vector path, in words no
    wider than the offset allows."""
    s, nbytes = 8, 496 * 3968 * 2
    src, views = _addresses(s, nbytes, src_off=elem)
    for t in _steps(s):
        a = ring.step_args(src, views, nbytes, t, ctas=128)
        assert not a.bulk and a.unit == elem


@pytest.mark.parametrize("off", [2, 4, 6, 8, 14])
def test_blocks_and_views_off_alike_take_the_bulk_path(off):
    """Blocks and views shifted by the same bytes share their residue:
    bulk, with a head up to the first 16-byte boundary and the rest of the
    last word as the tail."""
    s, nbytes = 8, 496 * 3968 * 2
    src, views = _addresses(s, nbytes, src_off=off, view_off=off)
    for t in _steps(s):
        a = ring.step_args(src, views, nbytes, t, ctas=128)
        assert a.bulk
        assert (a.head, a.tail) == (16 - off, off)
        assert a.mid == nbytes - 16


@pytest.mark.parametrize("rem", [4, 8])
def test_sizes_off_sixteen_take_the_path_their_addresses_allow(rem):
    """A block size that is not a multiple of 16 shifts the residues from
    block to block. s = 3 with blocks allocated apart: step 0's
    destinations (``views[q] + q * n``, 4n apart) stay aligned, so it goes
    bulk with the size's last ``rem`` bytes as its tail; step 1's
    (``(4q + 3) n`` from the views' base) do not, so it goes vector in
    ``rem``-byte words. Blocks back to back in one allocation are off one
    another: vector on every step."""
    s = 3
    n = 16 * 100 + rem
    src, views = _addresses(s, n, apart=True)
    a0 = ring.step_args(src, views, n, 0, ctas=64)
    assert a0.bulk and (a0.head, a0.mid, a0.tail) == (0, n - rem, rem)
    a1 = ring.step_args(src, views, n, 1, ctas=64)
    assert not a1.bulk and a1.unit == rem
    src, views = _addresses(s, n)
    for t in _steps(s):
        a = ring.step_args(src, views, n, t, ctas=64)
        assert not a.bulk and a.unit == rem


def test_tiny_blocks_take_the_vector_path():
    """No aligned 16-byte word inside a block: nothing for the bulk path."""
    s = 2
    for nbytes, off, unit in ((8, 0, 8), (16, 2, 2), (20, 6, 2)):
        src, views = _addresses(s, nbytes, src_off=off, view_off=off)
        a = ring.step_args(src, views, nbytes, 0, ctas=8)
        assert not a.bulk and a.unit == unit


@pytest.mark.parametrize("nbytes", [16, 18, 30, 94, 4096, 65_538, 3_936_256])
@pytest.mark.parametrize("off", [0, 2, 8, 14])
def test_bulk_split_covers_every_byte_once(nbytes, off):
    """Where a step goes bulk, head + mid + tail is the whole copy, the
    middle starts and ends on a 16-byte boundary of the source and of every
    destination, and head and tail stay under one word."""
    s = 3
    src, views = _addresses(s, nbytes, src_off=off, view_off=off)
    for t in _steps(s):
        a = ring.step_args(src, views, nbytes, t, ctas=128)
        if not a.bulk:
            continue
        assert a.head + a.mid + a.tail == nbytes
        assert 0 <= a.head < 16 and 0 <= a.tail < 16 and a.mid % 16 == 0 and a.mid > 0
        for x, d in _copies(a):
            assert (x + a.head) % 16 == 0 and (d + a.head) % 16 == 0
            assert (x + a.head + a.mid) % 16 == 0
            covered = np.zeros(nbytes, dtype=np.int64)
            covered[:a.head] += 1
            covered[a.head:a.head + a.mid] += 1
            covered[a.head + a.mid:] += 1
            assert (covered == 1).all()


@pytest.mark.parametrize("ctas", [1, 8, 66, 128, 8448])
def test_grids_stay_inside_the_kernels(ctas):
    """The bulk grid is at most one CTA a chunk of ``BULK_CHUNK``; the
    vector grid is ``ctas // s`` CTAs a source, at least 1, at most the
    grid's y-limit."""
    s, nbytes = 8, 496 * 3968 * 2
    chunks = s * -(-nbytes // ring.BULK_CHUNK)
    src, views = _addresses(s, nbytes)
    a = ring.step_args(src, views, nbytes, 1, ctas)
    assert a.bulk and a.grid == min(ctas, chunks)
    src, views = _addresses(s, nbytes, src_off=8)
    a = ring.step_args(src, views, nbytes, 1, ctas)
    assert not a.bulk and a.grid == min(max(ctas // s, 1), 65535)


# -- the wrapper and the plan on CPU tensors --------------------------------


def test_plan_refuses_what_the_step_form_does_not_take():
    """``ring_step`` (a plan for one step) and ``StepPlan`` raise the step
    form's errors on CPU tensors."""
    blocks = [torch.zeros((4, 3), dtype=torch.int16) for _ in range(3)]
    views = torch.zeros((3, 12, 3), dtype=torch.int16)
    for build in (lambda b, v: ring.StepPlan(b, v),
                  lambda b, v: ring.StepPlan(b, v, ctas=8)):
        with pytest.raises(ValueError, match="step 2"):
            build(blocks, views).launch(2)
        with pytest.raises(ValueError, match="step -1"):
            build(blocks, views).launch(-1)
        with pytest.raises(ValueError, match="views"):
            build(blocks, views[:, :8])
        with pytest.raises(ValueError, match="views"):
            build(blocks, views.to(torch.int32))
        with pytest.raises(ValueError, match="views"):
            build(blocks, views.transpose(1, 2).contiguous().transpose(1, 2))
        with pytest.raises(ValueError, match="equal"):
            build(blocks[:2] + [torch.zeros((3, 3), dtype=torch.int16)], views)
        with pytest.raises(ValueError, match="contiguous"):
            build(blocks[:2] + [torch.zeros((3, 4), dtype=torch.int16).t()], views)
    with pytest.raises(ValueError, match="step 2"):
        ring.ring_step(blocks, views, 2)
    with pytest.raises(ValueError, match="views"):
        ring.ring_step(blocks, views[:, :8], 1)
    with pytest.raises(ValueError, match="views"):
        ring.ring_step(blocks, views.to(torch.int32), 1)
    with pytest.raises(ValueError, match="equal"):
        ring.ring_step(blocks[:2] + [torch.zeros((3, 3), dtype=torch.int16)], views, 1)


@pytest.mark.parametrize("dtype", ["bf16", "int16", "int32"])
@pytest.mark.parametrize("s,r", [(3, 20), (8, 61)])
def test_plan_steps_equal_the_gather(s, r, dtype, virtual_mesh):
    """A CPU plan launched over every step leaves every view equal to
    ``ring_all_gather_plain`` and to the reference's ``ring_all_gather``,
    counts no launch and plans no C call."""
    x = _rows(np.random.default_rng(s * 17 + r), r, 24, dtype)
    b = -(-r // s)
    blocks = [to_torch(x[q * b:(q + 1) * b]) for q in range(s)]
    jm = virtual_mesh if s == N_VIRTUAL_DEVICES else j_make_mesh(s)
    want = np.asarray(jring.ring_all_gather(jnp.asarray(x), jm))
    padded, b, _ = ring._padded_blocks(blocks)
    views = torch.zeros((s, s * b, 24), dtype=_DTYPES[dtype][1])
    launches = ring.ring_step.launches
    plan = ring.StepPlan(padded, views)
    assert plan.paths == () and plan.stream is None
    for t in range(plan.last + 1):
        plan.launch(t)
    gathered = ring.ring_all_gather_plain(padded)
    for me in range(s):
        assert torch.equal(views[me], gathered[me])
        np.testing.assert_array_equal(to_numpy(views[me][:r]).view(np.uint8),
                                      want.view(np.uint8))
    assert ring.ring_step.launches == launches


@pytest.mark.parametrize("s", [2, 3, 8])
def test_cpu_exchange_lands_only_what_was_waited_for(s, monkeypatch):
    """A poisoned CPU ``RingExchange`` lands nothing before a wait; after
    ``wait(t)`` shard me's view holds exactly the blocks whose arrival
    step is at most t, and waiting again for an earlier step lands
    nothing more."""
    monkeypatch.setattr(ring, "POISON", True)
    r = 6 * s - 2  # a short final block
    x = torch.arange(r * 4, dtype=torch.int32).reshape(r, 4)
    b = -(-r // s)
    ex = ring.RingExchange([x[q * b:(q + 1) * b] for q in range(s)])
    sentinel = ring._sentinel(torch.int32)
    assert (ex.views == sentinel).all()
    steps = [ring.arrival_steps(me, s) for me in range(s)]
    for t in range(ex.last + 1):
        ex.wait(t)
        ex.wait(max(t - 1, 0))
        for me in range(s):
            for q in range(s):
                got = ex.block(me, q)[: min(b, r - q * b)]
                if steps[me][q] <= t:
                    assert torch.equal(got, x[q * b:(q + 1) * b])
                else:
                    assert (got == sentinel).all()
    for me in range(s):
        assert torch.equal(ex.view(me), x)

"""Kernel K1 (multi-source BFS) of sdnmpi_tpu_torch, on the CPU.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
exactly against the plain version at every sources-per-block width. Here
the wrapper takes its plain version (a CPU tensor), which these tests
hold against the JAX package's APSP and its Pallas kernel in interpret
mode on the same numpy inputs, on the cases the kernel's level record
has to get right: distances past 255 and isolated (padding) rows. They
also pin the host-side choice of the kernel's sources per block and its
shared-memory limit. Distances must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnmpi_tpu.kernels.bfs import bfs_distances_pallas
from sdnmpi_tpu.oracle.apsp import apsp_distances as j_apsp
from sdnmpi_tpu.oracle.engine import tensorize as j_tensorize
from sdnmpi_tpu.topogen import fattree as j_fattree
from sdnmpi_tpu_torch.kernels import bfs


def _chain(v: int) -> np.ndarray:
    """Directed chain 0 -> 1 -> ... -> v-1: node 0 reaches v-1 in v-1 hops,
    and nothing reaches back."""
    adj = np.zeros((v, v), np.float32)
    adj[np.arange(v - 1), np.arange(1, v)] = 1.0
    return adj


@pytest.mark.parametrize("levels", [299, 2])
def test_chain_past_255_matches_apsp(levels):
    """V = 300: distances up to 299 (past a uint8 level record) at the full
    budget, and every pair beyond 2 hops unreachable when cut at 2."""
    adj = _chain(300)
    full = np.asarray(j_apsp(jnp.asarray(adj)))
    assert full[0, 299] == 299 and np.isinf(full[299, 0])
    before = bfs.bfs_distances.launches
    got = bfs.bfs_distances(torch.tensor(adj), levels).numpy()
    assert bfs.bfs_distances.launches == before  # CPU calls launch nothing
    np.testing.assert_array_equal(got, np.where(full <= levels, full, np.inf))
    np.testing.assert_array_equal(
        bfs.bfs_distances_plain(torch.tensor(adj), levels).numpy(), got)


@pytest.mark.parametrize("levels", [0, 127])
def test_padding_rows_match_pallas(levels):
    """A fat-tree k=4 padded to V = 128, with two real switches cut off:
    isolated rows read 0 on the diagonal and inf elsewhere, at no level
    and at the full budget, as the Pallas kernel gives them."""
    adj = np.asarray(j_tensorize(j_fattree(4).to_topology_db(backend="jax"),
                                 pad_multiple=128).adj).copy()
    adj[[2, 9]] = 0.0
    adj[:, [2, 9]] = 0.0
    ref = np.asarray(bfs_distances_pallas(jnp.asarray(adj), levels=levels,
                                          interpret=True))
    got = bfs.bfs_distances(torch.tensor(adj), levels).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (np.diag(got) == 0).all()
    for row in (2, 9, 100, 127):
        assert np.isinf(np.delete(got[row], row)).all()


#: (V, SMs) -> sources per block the wrapper picks for 4 and for V - 1
#: levels: the narrowest width whose blocks fit one wave of one block per
#: SM, else the widest; only widths that fit shared memory (64 at
#: V = 3,968 does not, nor 32 with the uint16 record past 254 levels)
PICKS = {
    (40, 1): (64, 64), (40, 132): (8, 8),
    (1000, 1): (64, 64), (1000, 132): (8, 8),
    (1024, 1): (64, 64), (1024, 132): (8, 8),
    (3968, 1): (32, 16), (3968, 132): (32, 16),
}


@pytest.mark.parametrize("v,n_sms", sorted(PICKS))
def test_sources_per_block(v, n_sms):
    for levels, want in zip((min(4, v - 1), v - 1), PICKS[(v, n_sms)]):
        got = bfs.sources_per_block(v, levels, n_sms)
        assert got == want, (v, n_sms, levels, got)
        assert got in bfs.SOURCE_WIDTHS
        assert bfs.smem_bytes(v, got, levels) <= bfs.SMEM_LIMIT


def test_shared_memory_limit():
    """MAX_V is the largest V whose 8-source block fits at any budget; the
    choice raises past it, and the record doubles past 254 levels."""
    lim, v = bfs.SMEM_LIMIT, bfs.MAX_V
    assert bfs.smem_bytes(v, 8, v - 1) <= lim < bfs.smem_bytes(v + 1, 8, v)
    assert bfs.sources_per_block(v, v - 1, 132) == 8
    with pytest.raises(ValueError, match="V <="):
        bfs.sources_per_block(v + 1, 4, 132)
    # per node: the level record in an odd number of 32-bit words (32
    # uint8 levels and one spare word; 32 uint16 and one), a 32-bit next
    # word, the seen and front words of 32 bits and a uint16 list entry
    assert bfs.smem_bytes(1024, 32, 254) == 1024 * (9 * 4 + 3 * 4 + 2) + 16
    assert bfs.smem_bytes(1024, 32, 255) == 1024 * (17 * 4 + 3 * 4 + 2) + 16
    # 8 sources: one spare record word, a 32-bit next word, bytes of bits
    assert bfs.smem_bytes(1024, 8, 4) == 1024 * (3 * 4 + 4 + 2 + 2) + 16

"""MPI collective communication patterns as rank-pair batches.

The reference understands collectives only as a type code logged from the
virtual MAC (reference: sdnmpi/router.py:176,182) — routing stays
one-pair-at-a-time. Here each collective expands into the full batch of
(src_rank, dst_rank) pairs its algorithm sends, so the oracle can score
and install every route of the collective at once (the north star:
"score all rank-pair paths of an MPI collective at once").

Patterns follow the textbook algorithms (binomial trees for rooted
collectives, rings and recursive doubling for all-to-all-style ones);
each function returns an ``[F, 2]`` int32 array of rank pairs, optionally
with a round index for phase-aware scheduling.
"""

from __future__ import annotations

import numpy as np

from sdnmpi_tpu_torch.protocol.vmac import CollectiveType


def alltoall_pairs(n: int) -> np.ndarray:
    """Every ordered pair (i, j), i != j: the complete traffic matrix."""
    src, dst = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    mask = src != dst
    return np.stack([src[mask], dst[mask]], axis=1).astype(np.int32)


def bcast_binomial_pairs(n: int, root: int = 0, with_rounds: bool = False):
    """Binomial-tree broadcast: log2(n) rounds; in round k every rank that
    already holds the data forwards it 2^k ranks ahead (relative to root).
    """
    pairs, rounds = [], []
    k = 0
    while (1 << k) < n:
        step = 1 << k
        for rel in range(step):
            if rel + step < n:
                src = (root + rel) % n
                dst = (root + rel + step) % n
                pairs.append((src, dst))
                rounds.append(k)
        k += 1
    return _with_rounds(pairs, rounds, with_rounds)


def reduce_binomial_pairs(n: int, root: int = 0, with_rounds: bool = False):
    """Binomial-tree reduce: the broadcast tree with edges reversed."""
    pairs, rounds = bcast_binomial_pairs(n, root, with_rounds=True)
    pairs = pairs[:, ::-1].copy()
    max_round = rounds.max(initial=0)
    rounds = max_round - rounds
    order = np.argsort(rounds, kind="stable")
    pairs, rounds = pairs[order], rounds[order]
    return (pairs, rounds) if with_rounds else pairs


def allreduce_ring_pairs(n: int, with_rounds: bool = False):
    """Ring allreduce: 2(n-1) rounds of neighbor sends (reduce-scatter then
    allgather), each round the full ring (i -> i+1)."""
    pairs, rounds = [], []
    for r in range(2 * (n - 1)):
        for i in range(n):
            pairs.append((i, (i + 1) % n))
            rounds.append(r)
    return _with_rounds(pairs, rounds, with_rounds)


def allreduce_recursive_doubling_pairs(n: int, with_rounds: bool = False):
    """Recursive doubling: log2(n) rounds of pairwise exchange with the
    rank whose index differs in bit k. Requires power-of-two n."""
    if n & (n - 1):
        raise ValueError(f"recursive doubling needs power-of-two ranks, got {n}")
    pairs, rounds = [], []
    k = 0
    while (1 << k) < n:
        for i in range(n):
            pairs.append((i, i ^ (1 << k)))
            rounds.append(k)
        k += 1
    return _with_rounds(pairs, rounds, with_rounds)


def allgather_ring_pairs(n: int, with_rounds: bool = False):
    """Ring allgather: n-1 rounds of (i -> i+1)."""
    pairs, rounds = [], []
    for r in range(n - 1):
        for i in range(n):
            pairs.append((i, (i + 1) % n))
            rounds.append(r)
    return _with_rounds(pairs, rounds, with_rounds)


def gather_pairs(n: int, root: int = 0) -> np.ndarray:
    """Flat gather: every non-root rank sends to root."""
    return np.array(
        [(i, root) for i in range(n) if i != root], dtype=np.int32
    ).reshape(-1, 2)


def scatter_pairs(n: int, root: int = 0) -> np.ndarray:
    return np.array(
        [(root, i) for i in range(n) if i != root], dtype=np.int32
    ).reshape(-1, 2)


def barrier_dissemination_pairs(n: int, with_rounds: bool = False):
    """Dissemination barrier: ceil(log2(n)) rounds; round k sends to
    (i + 2^k) mod n."""
    pairs, rounds = [], []
    k = 0
    while (1 << k) < n:
        step = 1 << k
        for i in range(n):
            pairs.append((i, (i + step) % n))
            rounds.append(k)
        k += 1
    return _with_rounds(pairs, rounds, with_rounds)


def _with_rounds(pairs, rounds, with_rounds: bool):
    arr = np.array(pairs, dtype=np.int32).reshape(-1, 2)
    if with_rounds:
        return arr, np.array(rounds, dtype=np.int32)
    return arr


#: CollectiveType -> generator for the pairs the collective transmits
_GENERATORS = {
    CollectiveType.BCAST: bcast_binomial_pairs,
    CollectiveType.REDUCE: reduce_binomial_pairs,
    CollectiveType.ALLREDUCE: allreduce_ring_pairs,
    CollectiveType.GATHER: gather_pairs,
    CollectiveType.SCATTER: scatter_pairs,
    CollectiveType.ALLGATHER: allgather_ring_pairs,
    CollectiveType.REDUCE_SCATTER: allgather_ring_pairs,  # same ring pattern
    CollectiveType.ALLTOALL: lambda n: alltoall_pairs(n),
    CollectiveType.BARRIER: barrier_dissemination_pairs,
}


def collective_pairs(coll_type: int, n: int, **kwargs) -> np.ndarray:
    """Rank pairs for a collective identified by its vMAC type code."""
    gen = _GENERATORS.get(coll_type)
    if gen is None:
        raise ValueError(f"no pattern for collective type {coll_type}")
    return gen(n, **kwargs)

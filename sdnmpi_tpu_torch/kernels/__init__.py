"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version: K1 BFS distances (:mod:`.bfs`), K2 path sampling
(:mod:`.sampler`) and K3 the ring all-gather (:mod:`.ring`). Sources live
in ``csrc/`` and build at first use (:mod:`._build`)."""

from sdnmpi_tpu_torch.kernels.bfs import bfs_distances, bfs_distances_plain
from sdnmpi_tpu_torch.kernels.ring import ring_all_gather, ring_all_gather_plain
from sdnmpi_tpu_torch.kernels.sampler import sample_paths_dense, sample_slots

__all__ = [
    "bfs_distances",
    "bfs_distances_plain",
    "ring_all_gather",
    "ring_all_gather_plain",
    "sample_paths_dense",
    "sample_slots",
]

"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version: K1 BFS distances (:mod:`.bfs`) and K2 path sampling
(:mod:`.sampler`). Sources live in ``csrc/`` and build at first use
(:mod:`._build`)."""

from sdnmpi_tpu_torch.kernels.bfs import bfs_distances, bfs_distances_plain
from sdnmpi_tpu_torch.kernels.sampler import sample_paths_dense, sample_slots

__all__ = [
    "bfs_distances",
    "bfs_distances_plain",
    "sample_paths_dense",
    "sample_slots",
]

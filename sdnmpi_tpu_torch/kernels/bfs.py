"""Multi-source BFS distances: kernel K1 and its plain version.

Counterpart of ``sdnmpi_tpu/kernels/bfs.py``. :func:`bfs_distances`
computes the hop-count matrix ``[V, V]`` (f32, inf = unreachable) in
exactly ``levels`` frontier steps: pairs farther apart than ``levels``
read inf, and the diagonal is 0 even for padding rows. On a CPU tensor it
runs :func:`bfs_distances_plain`, the reference's level loop as torch
ops; on a CUDA tensor it launches the hand-written kernel in
``csrc/bfs.cu`` (one block per source row over a padded CSR of the
adjacency) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from sdnmpi_tpu_torch.kernels import _build

#: the kernel keeps each distance row in shared memory as uint16
MAX_V = 65535


def neighbor_rows(mask: torch.Tensor) -> torch.Tensor:
    """Padded CSR of a ``[V, V]`` bool matrix: ``[V, V]`` int32 whose
    row i lists i's out-neighbours in ascending order, padded with V
    past i's degree (the sorted-neighbour order every slot refers to)."""
    v = mask.shape[0]
    idx = torch.arange(v, dtype=torch.int32, device=mask.device)
    fill = torch.full_like(idx, v)
    return torch.sort(torch.where(mask, idx[None, :], fill[None, :]), dim=1).values


def bfs_distances_plain(adj: torch.Tensor, levels: int) -> torch.Tensor:
    """The level loop of the Pallas kernel as torch ops: the reached set
    grows by one 0/1 matrix product per level (exact in f32), for
    exactly ``levels`` steps."""
    v = adj.shape[0]
    a = (adj > 0).to(torch.float32)
    reached = torch.eye(v, dtype=torch.float32, device=adj.device)
    dist = torch.where(reached > 0, 0.0, float("inf"))
    for level in range(1, levels + 1):
        grown = torch.clamp(reached @ a + reached, max=1.0)
        newly = (grown > 0) & torch.isinf(dist)
        dist = torch.where(newly, float(level), dist)
        reached = grown
    return dist


def bfs_distances(adj: torch.Tensor, levels: int) -> torch.Tensor:
    """Hop-count distance matrix ``[V, V]`` f32 of the directed adjacency
    ``adj`` (rows are sources, nonzero = link), ``levels`` BFS steps.

    CPU tensors take the plain version; CUDA tensors launch kernel K1
    (V up to :data:`MAX_V`, else it raises)."""
    if adj.dim() != 2 or adj.shape[0] != adj.shape[1]:
        raise ValueError(f"adj must be square [V, V], got {tuple(adj.shape)}")
    if levels < 0:
        raise ValueError(f"levels must be >= 0, got {levels}")
    if adj.device.type == "cpu":
        return bfs_distances_plain(adj, levels)
    if adj.device.type != "cuda":
        raise ValueError(f"bfs_distances runs on cpu or cuda, not {adj.device}")
    v = adj.shape[0]
    if v > MAX_V:
        raise ValueError(f"bfs kernel takes V <= {MAX_V}, got {v}")
    out = torch.empty((v, v), dtype=torch.float32, device=adj.device)
    if v == 0:
        return out
    neigh = neighbor_rows(adj > 0).contiguous()
    lib = _build.load("bfs")
    fn = lib.bfs_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    # more than V - 1 levels reach nothing new
    steps = min(int(levels), v - 1)
    err = fn(
        neigh.data_ptr(), v, v, steps, out.data_ptr(),
        _build.stream_ptr(adj.device),
    )
    _build.check(err, "bfs")
    bfs_distances.launches += 1
    return out


#: kernel launches of :func:`bfs_distances` (CPU calls do not count)
bfs_distances.launches = 0

"""Multi-source BFS distances: kernel K1 and its plain version.

Counterpart of ``sdnmpi_tpu/kernels/bfs.py``. :func:`bfs_distances`
computes the hop-count matrix ``[V, V]`` (f32, inf = unreachable) in
exactly ``levels`` frontier steps: pairs farther apart than ``levels``
read inf, and the diagonal is 0 even for padding rows. On a CPU tensor it
runs :func:`bfs_distances_plain`, the reference's level loop as torch
ops; on a CUDA tensor it launches the hand-written kernel in
``csrc/bfs.cu`` or raises: a bit-parallel BFS in which each block
expands :func:`sources_per_block` sources together over the compact
sorted neighbour table of :func:`neighbor_rows`, keeping each (source,
node) level in shared memory until it writes its rows of the output.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sdnmpi_tpu_torch.kernels import _build

#: sources one block of the kernel expands together: one bit each of a
#: node's uint8, uint16, uint32 or uint64 word
SOURCE_WIDTHS = (8, 16, 32, 64)
#: shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232448
#: the largest V whose 8-source block fits :data:`SMEM_LIMIT` at any level
#: budget (a uint16 level record); the wrapper raises above it
MAX_V = 8300


def _align16(n: int) -> int:
    return (n + 15) & ~15


def smem_bytes(v: int, sources: int, levels: int) -> int:
    """Shared memory of one kernel block (``csrc/bfs.cu`` smem_bytes): each
    node's level record (``sources`` uint8 levels, uint16 past 254 levels,
    in an odd number of 32-bit words), its next word (at least 32 bits),
    its seen and front words of ``sources`` bits, the uint16 frontier list
    and two counts."""
    record_words = sources * (1 if levels <= 254 else 2) // 4 + 1
    return (_align16(v * record_words * 4) + _align16(v * max(4, sources // 8))
            + 2 * _align16(v * sources // 8) + _align16(2 * v) + 16)


@functools.lru_cache(maxsize=None)
def sources_per_block(v: int, levels: int, n_sms: int) -> int:
    """Sources per block of kernel K1 for ``levels`` (<= V - 1) steps on a
    card of ``n_sms`` SMs, among the widths of :data:`SOURCE_WIDTHS` whose
    block fits :data:`SMEM_LIMIT`: the narrowest whose blocks all run in
    one wave of one block per SM, else the widest. A narrower block
    finishes sooner (fewer sources, fewer frontier rows per level); a
    second wave, or two blocks sharing an SM, costs more than it saves
    (on an H100, PERF.md: 8 was fastest at V = 1024 and 32 at V = 3,968).
    Raises past :data:`MAX_V`."""
    if v > MAX_V:
        raise ValueError(f"bfs kernel takes V <= {MAX_V}, got {v}")
    fits = [s for s in SOURCE_WIDTHS if smem_bytes(v, s, levels) <= SMEM_LIMIT]
    one_wave = [s for s in fits if -(-v // s) <= n_sms]
    return min(one_wave) if one_wave else max(fits)


def neighbor_rows(mask: torch.Tensor, width: int) -> torch.Tensor:
    """Compact sorted out-neighbour table of a ``[V, V]`` bool matrix:
    ``[V, width]`` int32 whose row i lists i's first ``width``
    out-neighbours in ascending order, padded with V past i's degree
    (the order every sampler slot refers to). A prefix count over each
    row gives every neighbour its rank and one scatter puts it there: no
    sort and no host sync. ``width`` must be >= the largest out-degree
    or rows are cut."""
    v = mask.shape[0]
    idx = torch.arange(v, dtype=torch.int32, device=mask.device)
    rank = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
    # entries that are not neighbours, or past the width, land in a
    # spare column that is dropped
    col = torch.where(mask & (rank < width), rank, width)
    out = torch.full((v, width + 1), v, dtype=torch.int32, device=mask.device)
    out.scatter_(1, col.long(), idx[None, :].expand(v, v))
    return out[:, :width].contiguous()


def neighbor_rows_of(mat: torch.Tensor) -> torch.Tensor:
    """:func:`neighbor_rows` of ``mat > 0`` at its largest out-degree
    (one host sync): the table of a caller that holds no topology
    table."""
    mask = mat > 0
    return neighbor_rows(mask, int(mask.sum(dim=1).max()) if mask.shape[0] else 0)


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


def bfs_distances(
    adj: torch.Tensor, levels: int, neigh: torch.Tensor | None = None
) -> torch.Tensor:
    """Hop-count distance matrix ``[V, V]`` f32 of the directed adjacency
    ``adj`` (rows are sources, nonzero = link), ``levels`` BFS steps.

    ``neigh`` is the topology's compact neighbour table
    (:func:`neighbor_rows` of ``adj > 0``, any width >= the largest
    out-degree; entries >= V are padding), built once per topology
    version by the caller; without it the wrapper builds one. CPU tensors
    take the plain version; CUDA tensors launch kernel K1 (V up to
    :data:`MAX_V`, else it raises) with :func:`sources_per_block`
    sources per block."""
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
    if neigh is None:
        neigh = neighbor_rows_of(adj)
    if (neigh.dim() != 2 or neigh.shape[0] != v or neigh.dtype != torch.int32
            or neigh.device != adj.device or not neigh.is_contiguous()):
        raise ValueError("neigh must be a contiguous [V, D] int32 table on adj's device")
    # more than V - 1 levels reach nothing new
    steps = min(int(levels), v - 1)
    launch_kernel(neigh, steps, sources_per_block(v, steps, _build.sm_count(adj.device)),
                  out)
    bfs_distances.launches += 1
    return out


def launch_kernel(neigh: torch.Tensor, levels: int, sources: int,
                  out: torch.Tensor) -> None:
    """One launch of kernel K1 at ``sources`` per block (one of
    :data:`SOURCE_WIDTHS`) over the ``[V, D]`` table ``neigh`` into the
    ``[V, V]`` f32 ``out``, for ``levels`` <= V - 1 steps; not counted in
    :attr:`bfs_distances.launches`. Raises on a launch error."""
    v = neigh.shape[0]
    if smem_bytes(v, sources, levels) > SMEM_LIMIT:
        raise ValueError(f"{sources} sources per block do not fit shared memory at V={v}")
    fn = _build.function("bfs", "bfs_launch", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ])
    err = fn(
        neigh.data_ptr(), v, neigh.shape[1], levels, sources, out.data_ptr(),
        _build.stream_ptr(out.device),
    )
    _build.check(err, "bfs")


#: kernel launches of :func:`bfs_distances` (CPU calls do not count)
bfs_distances.launches = 0

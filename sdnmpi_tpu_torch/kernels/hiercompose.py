"""The hierarchical oracle's fused composition, as torch ops.

Counterpart of ``sdnmpi_tpu/kernels/hiercompose.py`` (a jitted XLA
program there, not a Pallas kernel). For a chunk of m queries it computes

    total(q) = min over (b1, b2) of  dA(s, b1) + D(b1, b2) + dB(b2, d)

over the concatenated border-row plane and breaks ties among the
equal-length (b1, b2) choices by the steering loads, in one pass on the
plane's device:

- ``plane`` ``[R, B]`` f32: every materialized destination pod's
  border-distance rows, pod-major (``HierState.plane_device()``);
- ``rowidx`` ``[m, bB]`` int32: per query, the plane row of each
  destination-pod border (pads clamped; ``dbd`` is inf there);
- ``gidA`` ``[m, bA]`` int32: source-pod border ids (pads clamped; ``dsb``
  is inf there).

The pick is the FIRST flat index (row-major over the padded
``[bA, bB]``) that is both shortest and least loaded, as
``jnp.argmax`` over a bool array gives it: the bool mask is cast to an
integer dtype before ``argmax`` (which returns the first maximal index),
so ``best`` and ``pick`` are bit-equal to the reference's, steered and
unsteered (zero loads collapse the steered pick to ``argmax(is_best)``).
"""

from __future__ import annotations

import numpy as np
import torch


def _compose_core(plane, rowidx, gidA, dsb, dbd, loadA, loadB):
    """(best [m] f32, pick [m] int32) on the operands' device."""
    # cross[q, i, j] = D(border gidA[q, i] -> dest border j of q's pod)
    cross = plane[rowidx[:, None, :], gidA[:, :, None]]
    m = cross.shape[0]
    flat = (cross + dsb[:, :, None] + dbd[:, None, :]).reshape(m, -1)
    best = flat.amin(dim=1)
    is_best = flat == best[:, None]
    score = torch.where(
        is_best,
        (loadA[:, :, None] + loadB[:, None, :]).reshape(m, -1),
        float("inf"),
    )
    sel = is_best & (score == score.amin(dim=1, keepdim=True))
    pick = sel.to(torch.int8).argmax(dim=1).to(torch.int32)
    return best, pick


def compose_fused(plane, rowidx, gidA, dsb, dbd, loadA, loadB):
    """One fused composition on ``plane``'s device -> host ``(best [m]
    f32, pick [m] int32)``. ``plane`` is the state's resident tensor (no
    per-call upload); the other operands are small per-chunk numpy
    arrays. ``pick`` decodes against the PADDED bB (``pick // bB_pad,
    pick % bB_pad``)."""
    dev = plane.device

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

    best, pick = _compose_core(
        plane, put(rowidx, torch.int64), put(gidA, torch.int64),
        put(dsb, torch.float32), put(dbd, torch.float32),
        put(loadA, torch.float32), put(loadB, torch.float32),
    )
    return best.cpu().numpy(), pick.cpu().numpy()


def warm_compose(plane, m: int, bA: int, bB: int) -> None:
    """Run the composition once at one (m, bA, bB) bucket against
    ``plane`` with inf operands: the warm ladder's rung (the caching
    allocator holds the bucket's buffers afterwards)."""
    inf = np.full((m, bA), np.inf, np.float32)
    infB = np.full((m, bB), np.inf, np.float32)
    zi = np.zeros((m, bB), np.int32)
    za = np.zeros((m, bA), np.int32)
    compose_fused(plane, zi, za, inf, infB, inf, infB)

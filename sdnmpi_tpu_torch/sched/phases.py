"""Greedy link-load-aware phase packing (the scheduler's device half).

Counterpart of ``sdnmpi_tpu/sched/phases.py``. The input is a
collective's aggregated traffic: one row per unique (source edge switch,
destination edge switch) group with its member weight. The packer puts
the groups into K phases so that every phase's per-switch injection
(out) and delivery (in) loads stay balanced, a weighted near-matching
each. The objective is a bottleneck:

    cost(k) = max(util_out[s] + out[k, s],  util_in[d] + in[k, d])
    phase   = argmin_k cost(k)              (ties -> lowest k)

Groups go heaviest first (a stable order). The measured per-switch load
enters as the background terms ``util_out``/``util_in``.

The device packer (:func:`_pack_greedy_device`) is the reference's
``lax.scan`` as a host loop of torch ops on the oracle's device: one
step per group over a ``[K, 2V]`` load state (out loads, then in loads),
about six small kernels a step and no host read inside the loop (the
chosen phase stays a device tensor). :func:`pack_phases_host` is the
numpy twin with the same f32 operations in the same order; the two
assignments are equal bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from sdnmpi_tpu_torch.oracle.batch import bucket_pow2

#: widest phase count :func:`choose_n_phases` returns; requested counts
#: clamp here
MAX_AUTO_PHASES = 32

#: per-phase sub-flow budget of the phase-grain scanner leg
#: (``RouteOracle.routes_collective_dispatch(_phase_scan=)``): each
#: phase's groups split toward weight-1 sub-flows, at most this many
PHASE_SUBFLOW_BUDGET = 1 << 17


def choose_n_phases(n_groups: int, requested: int = 0) -> int:
    """The program's phase count K, always a power of two.

    ``requested`` > 0 (``Config.schedule_phases``, ``--schedule-phases``)
    is rounded up to a power of two and clamped at
    :data:`MAX_AUTO_PHASES`, 1 included (the flat batch through the
    scheduler, the control to compare with). Auto: 4, or 2 when the
    collective has fewer than 8 groups."""
    if requested > 0:
        return min(bucket_pow2(requested, floor=1), MAX_AUTO_PHASES)
    return 4 if n_groups >= 8 else 2


def aggregate_groups(src_sw: np.ndarray, dst_sw: np.ndarray, v: int):
    """(edge, edge) traffic groups of a collective's resolved pairs, the
    one group-build of the device path (``oracle/engine.py``) and the
    pure-Python backend (``core/topology_db.py``).

    ``src_sw``/``dst_sw`` are the pairs' compact switch indices (all
    >= 0). Returns ``(key, uniq, inv, counts, g_src, g_dst, w_pack)``:
    each pair's dense key (``src * v + dst``), the sorted unique keys,
    each pair's group row, member counts, the groups' switches, and the
    pack weight: the member count, zero for same-switch groups (they
    ride no link, so they never take a phase's per-switch budget; they
    still get a phase)."""
    key = src_sw.astype(np.int64) * np.int64(v) + dst_sw
    vv = v * v
    if vv <= (16 << 20):
        counts_all = np.bincount(key, minlength=vv)
        uniq = np.nonzero(counts_all)[0]
        counts = counts_all[uniq]
        lookup = np.zeros(vv, np.int64)
        lookup[uniq] = np.arange(len(uniq))
        inv = lookup[key]
    else:
        uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    g_src = (uniq // v).astype(np.int32)
    g_dst = (uniq % v).astype(np.int32)
    w_pack = np.where(g_src == g_dst, 0.0, counts.astype(np.float32)).astype(
        np.float32
    )
    return key, uniq, inv, counts, g_src, g_dst, w_pack


def _pack_greedy_device(
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    util_out: torch.Tensor,
    util_in: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """``[G]`` int32 phase per group row (-1 where ``src < 0``): the greedy
    scan of the module docstring, one step per row, on the rows' device.

    ``src``/``dst`` are int tensors, ``w``, ``util_out``, ``util_in`` f32.
    The state is one ``[K * 2V]`` vector (phase k's out loads at
    ``k * 2V + s``, its in loads at ``k * 2V + V + d``); a step gathers
    the two columns, adds the background, takes the row max and the
    first minimum over phases, and adds the weight at the two flat
    indices of the chosen phase (``index_add_``; the two indices differ,
    so each is one f32 add, as in the host twin). The phase never leaves
    the device inside the loop."""
    v = util_out.shape[0]
    g = src.shape[0]
    dev = src.device
    if g == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    src = src.long()
    cols = torch.stack([src.clamp(min=0), dst.long().clamp(min=0) + v], dim=1)
    bg = torch.cat([util_out, util_in]).to(torch.float32)[cols]  # [G, 2]
    add = torch.where(src >= 0, w.to(torch.float32), 0.0)[:, None].expand(g, 2)
    load = torch.zeros(k * 2 * v, dtype=torch.float32, device=dev)
    state = load.view(k, 2 * v)
    phases = []
    for i in range(g):
        c = cols[i]
        cost = (bg[i] + state[:, c]).amax(dim=1)  # [K]
        ph = torch.argmin(cost).view(1)  # first minimum: lowest phase
        load.index_add_(0, ph * (2 * v) + c, add[i])
        phases.append(ph)
    out = torch.cat(phases).to(torch.int32)
    return torch.where(src >= 0, out, -1)


def pack_phases_host(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    util_out: np.ndarray,
    util_in: np.ndarray,
    k: int,
) -> np.ndarray:
    """Numpy twin of :func:`_pack_greedy_device`, the same f32 arithmetic
    in the same order (the pure-Python backend's packer and the
    differential reference). Inputs are the unpadded group rows in
    processing order."""
    v = len(util_out)
    out_l = np.zeros((k, v), np.float32)
    in_l = np.zeros((k, v), np.float32)
    util_out = np.asarray(util_out, np.float32)
    util_in = np.asarray(util_in, np.float32)
    w = np.asarray(w, np.float32)
    phases = np.full(len(src), -1, np.int32)
    for g in range(len(src)):
        s, d = int(src[g]), int(dst[g])
        if s < 0:
            continue
        cost = np.maximum(util_out[s] + out_l[:, s], util_in[d] + in_l[:, d])
        ph = int(np.argmin(cost))  # first minimum: lowest phase wins ties
        out_l[ph, s] += w[g]
        in_l[ph, d] += w[g]
        phases[g] = ph
    return phases


def pack_phases(
    src_sw: np.ndarray,
    dst_sw: np.ndarray,
    weight: np.ndarray,
    k: int,
    v: int,
    util_out=None,
    util_in=None,
    device="cuda",
) -> np.ndarray:
    """Assign each traffic group to a phase; returns ``[G]`` int32 phase
    ids in the input order.

    Groups go heaviest first (stable: ties keep the input order).
    ``util_out``/``util_in`` are the ``[V]`` per-switch background loads
    (numpy or tensors; zeros when absent). ``device`` runs the torch
    packer on that device; ``None`` runs the host twin (the pure-Python
    backend's packer)."""
    src_sw = np.asarray(src_sw, np.int32)
    dst_sw = np.asarray(dst_sw, np.int32)
    weight = np.asarray(weight, np.float32)
    g = len(src_sw)
    if g == 0:
        return np.empty(0, np.int32)
    order = np.argsort(-weight, kind="stable")
    s_o, d_o, w_o = src_sw[order], dst_sw[order], weight[order]
    if util_out is None:
        util_out = np.zeros(v, np.float32)
    if util_in is None:
        util_in = np.zeros(v, np.float32)

    if device is not None:
        from sdnmpi_tpu_torch.oracle.engine import resolve_device

        dev = resolve_device(device)

        def put(a, dtype):
            if isinstance(a, torch.Tensor):
                return a.to(device=dev, dtype=dtype)
            return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

        packed = _pack_greedy_device(
            put(s_o, torch.int64), put(d_o, torch.int64), put(w_o, torch.float32),
            put(util_out, torch.float32), put(util_in, torch.float32), int(k),
        ).cpu().numpy()
    else:
        def host(a):
            if isinstance(a, torch.Tensor):
                a = a.cpu().numpy()
            return np.asarray(a, np.float32)

        packed = pack_phases_host(
            s_o, d_o, w_o, host(util_out), host(util_in), int(k)
        )
    out = np.empty(g, np.int32)
    out[order] = packed
    return out

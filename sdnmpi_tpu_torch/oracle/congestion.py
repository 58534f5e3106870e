"""Load-aware ECMP routing over the shortest-path DAG.

Counterpart of ``sdnmpi_tpu/oracle/congestion.py``:

- :func:`aggregate_pairs` collapses rank flows to weighted switch pairs.
- :func:`route_flows_balanced` is the greedy scanner: flows are
  processed in fixed-size chunks, and each hop of each flow picks the
  lowest-loaded equal-cost next hop given the load every earlier chunk
  and hop placed (an online assignment that spreads a batch over the
  fabric), seeded with the measured utilization of
  :func:`utilization_matrix`. On a CPU tensor it runs
  :func:`route_flows_balanced_plain`, the reference's two nested
  ``lax.scan``s (chunks, then hops) as host loops of torch ops; on a
  CUDA tensor it launches the hand-written kernel S1 in
  ``kernels/csrc/scan.cu`` or raises. S1 has two forms, and
  :func:`scan_form` picks one from the call's shapes: the resident form
  (one block, every table in shared memory, for small fabrics and
  narrow chunks such as the phased leg's chunk 1) and the spread form
  (one warp per flow of a chunk over many SMs, for fabrics whose tables
  do not fit or wide chunks). Both keep the load per link slot
  (``[V, D]``), which :func:`slot_loads_to_dense` scatters to ``[V, V]``.
- :func:`route_flows_balanced_phases` scans a phased program's phases,
  each on its own base, in one launch of the resident form: a block a
  phase.
- :func:`link_loads_from_paths` recomputes the load of chosen paths.

Loads accumulate in float64 and are cast to float32 where they are read.
Scatter-adds with repeated links then give one exact sum in any order
(on the card the adds are atomics), so the card routes the same inputs
the same way every time. With integer weights the float32 values are
the reference's exactly; with fractional ones the reference's sequential
float32 sums may differ from them in the last place.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sdnmpi_tpu_torch.kernels import _build
from sdnmpi_tpu_torch.kernels.bfs import neighbor_rows_of


def aggregate_pairs(
    src_sw: np.ndarray, dst_sw: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collapse per-rank flows to unique (src_switch, dst_switch) pairs
    with multiplicity weights. A 4096-rank alltoall has 16.7M rank pairs
    but only #edge-switches^2 distinct switch pairs — the load they add is
    identical per pair, so the device routes each distinct pair once."""
    v = int(max(src_sw.max(), dst_sw.max())) + 1
    key = src_sw.astype(np.int64) * v + dst_sw.astype(np.int64)
    uniq, counts = np.unique(key, return_counts=True)
    return (
        (uniq // v).astype(np.int32),
        (uniq % v).astype(np.int32),
        counts.astype(np.float32),
    )


def route_flows_balanced_plain(
    adj: torch.Tensor,  # [V, V] 0/1
    dist: torch.Tensor,  # [V, V] f32 hop counts (inf unreachable)
    base_cost: torch.Tensor,  # [V, V] f32 measured link utilization (scaled)
    src: torch.Tensor,  # [U] int32 (padded with -1)
    dst: torch.Tensor,  # [U] int32
    weight: torch.Tensor,  # [U] f32 (0 for padding)
    max_len: int,
    chunk: int = 4096,
    neigh: torch.Tensor | None = None,  # [V, D] int32 topology neighbour table
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy load-balanced routing of weighted flows: the plain version
    of kernel S1, the reference's two ``lax.scan``s as host loops of
    torch ops with no host sync inside them.

    Returns ``(nodes [U, max_len] int32 chosen switch sequence padded
    with -1, load [V, V] f32 directed-link load, max_congestion scalar)``.

    Flows go in ``chunk``-sized groups, one after the other; within a
    group each hop step picks, per flow, the equal-cost next hop
    minimizing ``base_cost + load``. Flows deciding in the same step
    cannot see each other's choice, so flows whose minimal-score
    candidate set ties exactly are dealt round-robin by flow id across
    the tied candidates (flow k takes the ``k mod m``-th). The candidates
    of a hop are the node's out-neighbours in ``neigh``, the compact
    sorted table of ``adj`` (``TopoTensors.neigh``; built here when
    absent), which takes the place of the reference's ``max_degree``.
    """
    v = adj.shape[0]
    nodes, load = _scan_plain(adj, dist, base_cost, src, dst, weight, max_len, chunk,
                              neigh)
    load32 = load.to(torch.float32).reshape(v, v)
    max_congestion = torch.where(adj > 0, load32, 0.0).max()
    return nodes, load32, max_congestion


def _scan_plain(adj, dist, base_cost, src, dst, weight, max_len: int, chunk: int,
                neigh) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan of :func:`route_flows_balanced_plain`: ``(nodes [U,
    max_len] int32, load [V * V] float64)``."""
    v = adj.shape[0]
    dev = adj.device
    u = src.shape[0]
    n_chunks = -(-u // chunk)
    pad = n_chunks * chunk - u
    src = torch.cat([src.long(), torch.full((pad,), -1, dtype=torch.int64, device=dev)])
    dst = torch.cat([dst.long(), torch.full((pad,), -1, dtype=torch.int64, device=dev)])
    weight = torch.cat([
        weight.to(torch.float64), torch.zeros(pad, dtype=torch.float64, device=dev)
    ])
    flow_id = torch.arange(n_chunks * chunk, dtype=torch.int64, device=dev)
    if neigh is None:
        neigh = neighbor_rows_of(adj)
    neigh_valid = neigh < v
    neigh_safe = neigh.long().clamp(max=v - 1)
    dist_flat = dist.reshape(-1)
    base_flat = base_cost.to(torch.float32).reshape(-1)
    load = torch.zeros(v * v, dtype=torch.float64, device=dev)

    chunks = []
    for c in range(n_chunks):
        part = slice(c * chunk, (c + 1) * chunk)
        c_src, c_dst, c_w, c_id = src[part], dst[part], weight[part], flow_id[part]
        safe_dst = c_dst.clamp(min=0)
        # flows whose pair is unreachable never place load
        alive = (c_src >= 0) & (c_dst >= 0) & torch.isfinite(
            dist_flat[c_src.clamp(min=0) * v + safe_dst])
        node = torch.where(alive, c_src, -1)
        rows = []
        for _ in range(max_len):
            rows.append(node)
            safe_node = node.clamp(min=0)
            moving = alive & (node != c_dst) & (node >= 0)
            nbrs = neigh_safe[safe_node]  # [C, D]
            dcur = dist_flat[safe_node * v + safe_dst]
            dn = dist_flat[nbrs * v + safe_dst[:, None]]
            cand = neigh_valid[safe_node] & (dn == dcur[:, None] - 1.0)
            lidx = safe_node[:, None] * v + nbrs  # link flat index [C, D]
            score = torch.where(
                cand, base_flat[lidx] + load[lidx].to(torch.float32), float("inf"))
            # round-robin deal of same-step flows across the tied minima
            is_min = cand & (score == score.min(dim=1, keepdim=True).values)
            m = is_min.sum(dim=1).clamp(min=1)
            pos = torch.cumsum(is_min, dim=1) - 1
            pick = is_min & (pos == (c_id % m)[:, None])
            j = torch.argmax(pick.to(torch.int32), dim=1)  # first index
            nxt = torch.where(moving, nbrs.gather(1, j[:, None])[:, 0], -1)
            load.index_add_(
                0, safe_node * v + nxt.clamp(min=0), torch.where(moving, c_w, 0.0))
            # a flow that has emitted its destination parks at -1
            node = nxt
        chunks.append(torch.stack(rows, dim=1))
    return torch.cat(chunks)[:u].to(torch.int32), load


#: dynamic shared memory one block may use on an H100 (sm_90)
RESIDENT_SMEM_BYTES = 232_448
#: threads of the resident form's block: its chunks take at most one
#: flow a thread (a lane of each warp holds one flow's state)
RESIDENT_THREADS = 512
#: the widest chunk (flows that pick together, ``min(chunk, U)``) the
#: rule gives the resident form; wider ones spread over the SMs. From
#: chip_smoke.py's form sweep on an H100 (4,096 flows on config 12's and
#: config 5's tables): the resident form was the faster up to 128 flows
#: a chunk in every run, the spread form mostly from 256
RESIDENT_MAX_WIDTH = 128


def resident_hop_stride(v: int) -> int:
    """Bytes of one row of the resident form's uint8 hop table: an odd
    number of 32-bit words (32 consecutive rows start in 32 banks)."""
    words = -(-v // 4)
    return 4 * (words + 1 - words % 2)


def resident_bytes(v: int, d: int) -> int:
    """Shared memory of S1's resident form (``scan.cu``'s
    ``resident_bytes``): ``[V, D]`` float64 slot loads, ``[V, D]`` float32
    slot base costs, ``[V, D]`` int16 neighbours rounded up to a word,
    ``V`` hop rows of :func:`resident_hop_stride` bytes and one word for
    the last live row."""
    vd = v * d
    return 12 * vd + 4 * (-(-2 * vd // 4)) + v * resident_hop_stride(v) + 4


def spread_hop_stride(v: int) -> int:
    """Bytes of one row of the spread form's uint8 hop table: ``V``
    rounded up to 16 (one 16-byte store a quarter tile)."""
    return -(-v // 16) * 16


def scan_form(v: int, d: int, chunk: int, u: int) -> str:
    """The form of kernel S1 for a call at ``V`` switches, a neighbour
    table ``D`` wide, ``chunk`` and ``U`` rows: ``"resident"`` where its
    tables fit one block's shared memory and at most
    :data:`RESIDENT_MAX_WIDTH` flows pick together, else ``"spread"``."""
    fits = resident_bytes(v, d) <= RESIDENT_SMEM_BYTES
    return "resident" if fits and min(chunk, u) <= RESIDENT_MAX_WIDTH else "spread"


def slot_loads_to_dense(
    slot_load: torch.Tensor, neigh: torch.Tensor, v: int
) -> torch.Tensor:
    """The ``[V, V]`` float32 load of S1's ``[V, D]`` float64 per-slot
    loads: slot i of node n lands at ``(n, min(neigh[n, i], V-1))``,
    where the plain version's clamped neighbour puts the add (a
    no-candidate pick's at column V-1). Each slot's float32 cast is
    scattered, which is the plain version's float32 load exactly: a
    row's neighbours are distinct and its pads take load only when the
    row is empty (a no-candidate pick takes slot 0, a real one
    otherwise), so every entry gets at most one nonzero slot, and no
    ``[V, V]`` float64 buffer is needed (126 MB at V = 3,968)."""
    cols = neigh.clamp(max=v - 1).to(torch.int64)
    rows = torch.arange(0, v * v, v, dtype=torch.int64, device=neigh.device)
    flat = rows[:, None] + cols
    dense = torch.zeros(v * v, dtype=torch.float32, device=slot_load.device)
    dense.index_add_(0, flat.reshape(-1), slot_load.reshape(-1).to(torch.float32))
    return dense.reshape(v, v)


def route_flows_balanced(
    adj: torch.Tensor,  # [V, V] 0/1
    dist: torch.Tensor,  # [V, V] f32 hop counts (inf unreachable)
    base_cost: torch.Tensor,  # [V, V] f32 measured link utilization (scaled)
    src: torch.Tensor,  # [U] int32 (padded with -1)
    dst: torch.Tensor,  # [U] int32
    weight: torch.Tensor,  # [U] f32 (0 for padding)
    max_len: int,
    chunk: int = 4096,
    neigh: torch.Tensor | None = None,  # [V, D] int32 topology neighbour table
    *,
    _form: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The greedy scanner of :func:`route_flows_balanced_plain`, same
    arguments and results. CPU tensors take the plain version; CUDA
    tensors launch kernel S1 (``kernels/csrc/scan.cu``), which takes
    contiguous tensors on one card: ``dist`` and ``base_cost`` ``[V, V]``
    f32, ``src``/``dst`` int32 and ``weight`` f32 of one length U >= 1,
    ``neigh`` ``[V, D]`` int32 of any width D >= 1 (the rows of
    ``kernels.bfs.neighbor_rows``), and ``max_len`` >= 1; it raises on
    anything else. Rows past the last live one (``src >= 0``) are not
    run: they place no load and read -1. The form is
    :func:`scan_form`'s; ``_form`` forces one (``"resident"`` raises
    where its tables do not fit or more than :data:`RESIDENT_THREADS`
    flows pick together). Nothing here waits for the card."""
    dev = adj.device
    if dev.type == "cpu":
        return route_flows_balanced_plain(
            adj, dist, base_cost, src, dst, weight, max_len, chunk=chunk, neigh=neigh)
    if dev.type != "cuda":
        raise ValueError(f"route_flows_balanced runs on cpu or cuda, not {dev}")
    v = adj.shape[0]
    if neigh is None:
        neigh = neighbor_rows_of(adj)
    u = src.shape[0]
    d = neigh.shape[1]
    check_kernel_args(adj, dist, base_cost, src, dst, weight, max_len, chunk, neigh)
    form = _form or scan_form(v, d, chunk, u)
    if form == "resident" and (resident_bytes(v, d) > RESIDENT_SMEM_BYTES
                               or min(chunk, u) > RESIDENT_THREADS):
        raise ValueError(
            f"S1's resident form takes at most {RESIDENT_SMEM_BYTES} bytes of "
            f"tables and {RESIDENT_THREADS} flows a chunk; V={v}, D={d} need "
            f"{resident_bytes(v, d)} bytes at min(chunk, U) = {min(chunk, u)}")
    if form not in ("resident", "spread"):
        raise ValueError(f"S1 has the forms resident and spread, not {form!r}")
    nodes = torch.full((u, max_len), -1, dtype=torch.int32, device=dev)
    hs8 = 0
    if form == "resident":
        slot_load = torch.empty(v * d, dtype=torch.float64, device=dev)
        hop8 = base_slot = flags = None
    else:
        slot_load = torch.zeros(v * d, dtype=torch.float64, device=dev)
        hs8 = spread_hop_stride(v)
        hop8 = torch.empty(v * hs8, dtype=torch.uint8, device=dev)
        base_slot = torch.empty(v * d, dtype=torch.float32, device=dev)
        flags = torch.zeros(5, dtype=torch.int32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = _scan_launch()(
        0 if form == "resident" else 1, neigh.data_ptr(), v, d, dist.data_ptr(),
        base_cost.data_ptr(), src.data_ptr(), dst.data_ptr(), weight.data_ptr(), u,
        max_len, chunk, nodes.data_ptr(), slot_load.data_ptr(), ptr(hop8), hs8,
        ptr(base_slot), ptr(flags), 1, None, _build.stream_ptr(dev),
    )
    _build.check(err, "scan")
    route_flows_balanced.launches += 1
    route_flows_balanced.phases += 1
    load32 = slot_loads_to_dense(slot_load.view(v, d), neigh, v)
    max_congestion = torch.where(adj > 0, load32, 0.0).max()
    return nodes, load32, max_congestion


#: kernel launches of :func:`route_flows_balanced` and
#: :func:`route_flows_balanced_phases` (CPU calls do not count), and the
#: batches they scanned: ``phases / launches`` is the batches a launch
route_flows_balanced.launches = 0
route_flows_balanced.phases = 0


def _scan_launch():
    """``scan.cu``'s ``scan_launch``, built at first use."""
    return _build.function("scan", "scan_launch", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ])


def route_flows_balanced_phases(
    adj: torch.Tensor,  # [V, V] 0/1
    dist: torch.Tensor,  # [V, V] f32 hop counts (inf unreachable)
    bases: torch.Tensor,  # [K, V, V] f32: each phase's base cost
    src: torch.Tensor,  # [U] int32: the K phases' rows, concatenated
    dst: torch.Tensor,  # [U] int32
    weight: torch.Tensor,  # [U] f32
    offsets,  # K + 1 ints: phase p's rows are offsets[p]:offsets[p + 1]
    max_lens,  # K ints: each phase's hop budget
    chunk: int = 1,
    neigh: torch.Tensor | None = None,  # [V, D] int32 topology neighbour table
    *,
    out: torch.Tensor | None = None,
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """K independent scans of :func:`route_flows_balanced` on one fabric,
    each from its own base and a zeroed load: a phased program's phases.
    Returns ``(nodes, slot_load)``: each phase's ``[U_p, max_len_p]``
    int32 nodes, views in phase order of one buffer (``out``, of ``sum
    U_p * max_len_p`` int32, where the caller gives one), and the
    ``[K, V, D]`` float64 loads of each phase's link slots (slot i of
    node n is the link to ``neigh[n, i]``; :func:`slot_loads_to_dense`
    makes one phase's ``[V, V]`` load). Ties are dealt by the row id
    within the phase, so phase p equals ``route_flows_balanced`` on its
    own rows and base.

    CPU tensors run :func:`route_flows_balanced_plain`'s scan once a
    phase. CUDA tensors launch S1's resident form once, a block a phase,
    each on its own SM; it takes what :func:`route_flows_balanced` takes
    (``bases`` contiguous ``[K, V, V]`` f32), every phase at least one
    row, and raises where the resident form does not take a phase
    (:func:`scan_form`'s tables, more than :data:`RESIDENT_THREADS`
    flows a chunk). Nothing here waits for the card."""
    dev = adj.device
    v = adj.shape[0]
    if neigh is None:
        neigh = neighbor_rows_of(adj)
    d = neigh.shape[1]
    offsets = [int(x) for x in offsets]
    max_lens = [int(x) for x in max_lens]
    k = len(max_lens)
    rows = [b - a for a, b in zip(offsets[:-1], offsets[1:])]
    if (k < 1 or len(offsets) != k + 1 or offsets[0] != 0 or offsets[-1] != src.shape[0]
            or min(rows) < 1 or min(max_lens) < 1
            or tuple(bases.shape) != (k, v, v)):
        raise ValueError(
            f"route_flows_balanced_phases takes K >= 1 phases of at least one row "
            f"and hop: K + 1 offsets from 0 to U = {src.shape[0]}, K max_lens and "
            f"[K, V, V] bases; got offsets {offsets[:8]}..., max_lens "
            f"{max_lens[:8]}..., bases {tuple(bases.shape)}")
    sizes = [r * n for r, n in zip(rows, max_lens)]
    starts = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    if out is None:
        out = torch.empty(starts[-1], dtype=torch.int32, device=dev)
    elif (out.dtype != torch.int32 or tuple(out.shape) != (starts[-1],)
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(
            f"route_flows_balanced_phases writes nodes into a contiguous int32 "
            f"[{starts[-1]}] tensor on {dev}; got {out.dtype} {tuple(out.shape)} "
            f"on {out.device}")
    nodes = [out[a:a + n].view(r, m)
             for a, n, r, m in zip(starts, sizes, rows, max_lens)]
    if dev.type == "cpu":
        col = neigh.clamp(max=v - 1).long() + torch.arange(0, v * v, v)[:, None]
        # a pad slot takes load only as slot 0 of an empty row
        real = (neigh < v) | (torch.arange(d) == 0)
        slot_load = torch.zeros((k, v, d), dtype=torch.float64)
        for p in range(k):
            part = slice(offsets[p], offsets[p + 1])
            got, load = _scan_plain(adj, dist, bases[p], src[part], dst[part],
                                    weight[part], max_lens[p], chunk, neigh)
            nodes[p].copy_(got)
            slot_load[p] = torch.where(real, load[col], 0.0)
        return nodes, slot_load
    if dev.type != "cuda":
        raise ValueError(f"route_flows_balanced_phases runs on cpu or cuda, not {dev}")
    check_phases_kernel_args(adj, dist, bases, src, dst, weight, offsets, max_lens,
                             chunk, neigh)
    batch = None
    if k > 1:
        batch = torch.tensor([[a, r, m, n0] for a, r, m, n0 in
                              zip(offsets, rows, max_lens, starts)],
                             dtype=torch.int64).to(dev)
    out.fill_(-1)
    slot_load = torch.empty((k, v, d), dtype=torch.float64, device=dev)
    err = _scan_launch()(
        0, neigh.data_ptr(), v, d, dist.data_ptr(), bases.data_ptr(), src.data_ptr(),
        dst.data_ptr(), weight.data_ptr(), max(rows), max(max_lens), chunk,
        out.data_ptr(), slot_load.data_ptr(), None, 0, None, None, k,
        None if batch is None else batch.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(err, "scan")
    route_flows_balanced.launches += 1
    route_flows_balanced.phases += k
    return nodes, slot_load


def check_kernel_args(adj, dist, base_cost, src, dst, weight, max_len: int,
                      chunk: int, neigh: torch.Tensor) -> None:
    """Raise unless kernel S1 takes these arguments of
    :func:`route_flows_balanced` (its docstring lists what it takes)."""
    dev = adj.device
    v = adj.shape[0]
    u = src.shape[0]
    for name, x, dtype, shape in (
        ("dist", dist, torch.float32, (v, v)),
        ("base_cost", base_cost, torch.float32, (v, v)),
        ("src", src, torch.int32, (u,)),
        ("dst", dst, torch.int32, (u,)),
        ("weight", weight, torch.float32, (u,)),
        ("neigh", neigh, torch.int32, (v, neigh.shape[-1])),
    ):
        if (x.dtype != dtype or tuple(x.shape) != shape or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(
                f"route_flows_balanced kernel takes {name} as a contiguous "
                f"{dtype} tensor of shape {shape} on {dev}; got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    if u < 1 or max_len < 1 or chunk < 1 or neigh.shape[1] < 1:
        raise ValueError(
            f"route_flows_balanced kernel takes U, max_len, chunk and D >= 1, got "
            f"{u}, {max_len}, {chunk}, {neigh.shape[1]}")


def check_phases_kernel_args(adj, dist, bases, src, dst, weight, offsets, max_lens,
                             chunk: int, neigh: torch.Tensor) -> None:
    """Raise unless one launch of S1's resident form takes these
    arguments of :func:`route_flows_balanced_phases`: what
    :func:`check_kernel_args` asks of one call, ``bases`` a contiguous
    ``[K, V, V]`` f32 tensor, and tables and phases the resident form
    takes."""
    v, d = adj.shape[0], neigh.shape[-1]
    if (bases.dtype != torch.float32 or bases.dim() != 3 or not bases.is_contiguous()
            or bases.device != adj.device):
        raise ValueError(
            f"route_flows_balanced_phases kernel takes bases as a contiguous "
            f"float32 [K, V, V] tensor on {adj.device}; got {bases.dtype} "
            f"{tuple(bases.shape)} on {bases.device}")
    check_kernel_args(adj, dist, bases[0], src, dst, weight, max(max_lens), chunk,
                      neigh)
    width = max(min(chunk, b - a) for a, b in zip(offsets[:-1], offsets[1:]))
    if resident_bytes(v, d) > RESIDENT_SMEM_BYTES or width > RESIDENT_THREADS:
        raise ValueError(
            f"route_flows_balanced_phases runs S1's resident form, which takes at "
            f"most {RESIDENT_SMEM_BYTES} bytes of tables and {RESIDENT_THREADS} "
            f"flows a chunk; V={v}, D={d} need {resident_bytes(v, d)} bytes at "
            f"a widest min(chunk, U_p) of {width}")


def link_loads_from_paths(
    nodes: torch.Tensor, v: int, weight: torch.Tensor
) -> torch.Tensor:
    """The ``[V, V]`` f32 load matrix of chosen paths (for validation):
    each flow adds its weight to every link of its path."""
    a = nodes[:, :-1].long()
    b = nodes[:, 1:].long()
    valid = (a >= 0) & (b >= 0)
    wts = torch.where(valid, weight.to(torch.float64)[:, None], 0.0)
    load = torch.zeros(v * v, dtype=torch.float64, device=nodes.device)
    load.index_add_(
        0, (a.clamp(min=0) * v + b.clamp(min=0)).reshape(-1), wts.reshape(-1))
    return load.to(torch.float32).reshape(v, v)


def utilization_matrix(
    tensors, link_util: dict[tuple[int, int], float]
) -> np.ndarray:
    """Map the Monitor's (dpid, port_no) -> bps samples onto the [V, V]
    directed-link cost matrix using the topology's port map.

    Samples and link endpoints meet in a sorted ``searchsorted`` join
    over ``row * K + port_no`` keys. Zero/absent samples leave 0
    entries; unmapped samples (unknown dpid, or a port no link rides)
    are ignored.
    """
    port = tensors.host_port()
    util = np.zeros(port.shape, np.float32)
    if not link_util:
        return util
    index = tensors.index
    samples = [
        (i, int(port_no), float(bps))
        for (dpid, port_no), bps in link_util.items()
        if bps and (i := index.get(dpid)) is not None
    ]
    if not samples:
        return util
    rows, cols = np.nonzero(port >= 0)
    if not len(rows):
        return util
    s_rows, s_ports, s_bps = (np.asarray(x) for x in zip(*samples))
    link_ports = port[rows, cols].astype(np.int64)
    k = int(max(int(s_ports.max()), int(link_ports.max()))) + 1
    link_key = rows.astype(np.int64) * k + link_ports
    s_key = s_rows.astype(np.int64) * k + s_ports.astype(np.int64)
    order = np.argsort(s_key)  # dict keys are unique: no stable need
    s_key = s_key[order]
    s_val = s_bps.astype(np.float32)[order]
    pos = np.searchsorted(s_key, link_key)
    pos_c = np.minimum(pos, len(s_key) - 1)
    hit = s_key[pos_c] == link_key
    util[rows[hit], cols[hit]] = s_val[pos_c[hit]]
    return util

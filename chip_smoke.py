"""Drive sdnmpi_tpu_torch's collective paths on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and builds the
package's kernels from ``sdnmpi_tpu_torch/kernels/csrc``. Phases, in
order; the first failure ends the run with a non-zero exit:

1. device   — a CUDA card is present; print its name and power limit.
2. build    — build kernels K1 (BFS), K2 (path sampler) and K3 (ring
               all-gather), one nvcc per source, in parallel.
3. kernels  — hold K1 and K2 against their plain PyTorch versions on the
               card at the main path's shapes (K1 exactly, K2 bit for
               bit, in both sampler layouts); time both with CUDA events.
4. slice    — a 4096-rank alltoall over a k=28 fat-tree (980 switches,
               padded to V=1024) through TopologyDB.find_routes_collective;
               every routed pair is checked against the fabric.
5. program  — one route_collective call with no cached distances at the
               bench-config-4 shape (~86k aggregated edge-pair flows,
               rounds=2): K1 and K2 in one call.
6. report   — one JSON line of per-kernel numbers, then the result line;
               printed last, after phases 7 to 9.
7. ring     — K3 against its plain version (s in {2, 3, 8}, uneven rows,
               bf16/int16/int32/f32 words, exactly), timed at the distance
               exchange's shape beside torch.cat.
8. sharded  — config 13's primary shape: an 8192-rank alltoall over a
               k=56 fat-tree (3,920 switches, V=3,968) through
               TopologyDB(mesh_devices=8, shard_oracle=True,
               ring_exchange=True), all 8 shards on this card; every pair
               checked, routes bit-equal to a single-device TopologyDB.
9. sharded program — route_collective_sharded on config 13's edge flows
               in ring and gather modes, slots bit-equal to the
               single-device route_collective; K2 timed at one shard's
               share of the flows.

Launch counts are zeroed just before one call of each path and read just
after it: find_routes_collective (phase 4), route_collective(dist=None)
(phase 5), one steady sharded find_routes_collective and one sharded
refresh (phase 8), one route_collective_sharded call per mode (phase 9).
A kernel of a path that did not launch in its call fails the run. The
sampler call of phase 4 is recorded and held bit for bit against the
plain version on its own arguments, and so is every shard's sampler call
(with its ``fid_base``) of the steady sharded call and of each
route_collective_sharded call. Nothing here imports JAX or the JAX
package.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

FATTREE_K = 28
V_PAD = 1024
N_RANKS = 4096
ROUNDS = 2
#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and
#: non-tensor f32 FLOP/s, for the per-kernel lower bounds
PEAK_BYTES_S = 3.35e12
#: config 13's primary shape: fat-tree k=56 (3,920 switches, V = 3,968),
#: an 8192-rank alltoall, 8 shards on one card
SHARD_K = 56
SHARD_PAD = 128
SHARD_RANKS = 8192
SHARD_V = 3968
N_SHARDS = 8
PEAK_F32_S = 67e12


def bound_ms(r: dict) -> tuple[float, str]:
    """The least time for ``r``'s bytes and operations on the card, and
    which of the two sets it."""
    bytes_ms = r["bytes"] / PEAK_BYTES_S * 1e3
    ops_ms = r["ops"] / PEAK_F32_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median device time of ``fn()`` in ms (CUDA events per call)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_device(fn) -> tuple[float, float, list]:
    """Run ``fn()`` once under torch.profiler: (wall ms, summed device
    time ms of the kernels and copies it ran, top (ms, name, count))."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((ms, name, n) for name, (ms, n) in by_name.items()), reverse=True)
    return wall, sum(r[0] for r in rows), rows[:6]


def log_profile(what: str, wall: float, busy: float, top: list) -> None:
    if not top:
        log(f"{what} profile: wall {wall:.3f} ms; the profiler recorded no "
            "device time")
        return
    log(f"{what} profile: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f}% of wall)")
    for ms, name, n in top:
        log(f"  {ms:9.3f} ms  x{n:<4d} {name[:90]}")


def build_problem(k: int, n_ranks: int, v_pad: int, device):
    """The bench-config-4 problem: alltoall of ``n_ranks`` ranks on a
    k-ary fat-tree, aggregated to edge-switch pairs (rank i on host i)."""
    import torch

    from sdnmpi_tpu_torch.oracle.apsp import apsp_distances
    from sdnmpi_tpu_torch.oracle.congestion import aggregate_pairs
    from sdnmpi_tpu_torch.oracle.dag import make_dst_nodes
    from sdnmpi_tpu_torch.oracle.engine import tensorize
    from sdnmpi_tpu_torch.topogen import fattree

    spec = fattree(k)
    db = spec.to_topology_db(backend="torch", device=device, pad_multiple=v_pad)
    t = tensorize(db, pad_multiple=v_pad, device=device)
    host_edge = np.array(
        [t.index[dpid] for _, dpid, _ in spec.hosts[:n_ranks]], dtype=np.int32
    )
    src_sw = np.repeat(host_edge, n_ranks)
    dst_sw = np.tile(host_edge, n_ranks)
    keep = src_sw != dst_sw
    usrc, udst, weight = aggregate_pairs(src_sw[keep], dst_sw[keep])
    v = t.v
    li, lj = np.nonzero(t.host_adj() > 0)
    traffic = np.zeros((v, v), np.float32)
    traffic[udst, usrc] = weight
    dist = apsp_distances(t.adj)
    dist_h = dist.cpu().numpy()
    levels = int(dist_h[np.isfinite(dist_h)].max())
    put = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    return {
        "spec": spec, "t": t, "dist": dist, "levels": levels,
        "li": put(li.astype(np.int32)), "lj": put(lj.astype(np.int32)),
        "traffic": put(traffic), "src": put(usrc), "dst": put(udst),
        "dst_nodes": put(make_dst_nodes(udst)), "n_pairs": int(keep.sum()),
    }


def check_paths(nodes: np.ndarray, src, dst, dist_h, adj_h, what: str) -> int:
    """Every reachable flow's decoded path runs over real links from src
    to dst with dist+1 nodes; returns the number of checked flows."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    reach = np.isfinite(dist_h[src, dst])
    length = (nodes >= 0).sum(axis=1)
    want = np.where(reach, dist_h[src, dst] + 1, 0).astype(np.int64)
    bad = np.nonzero(length != want)[0]
    if len(bad):
        fail(f"{what}: {len(bad)} flows with a path length other than dist+1 "
             f"(first: flow {bad[0]}, {nodes[bad[0]].tolist()})")
    ok = reach
    if (nodes[ok, 0] != src[ok]).any():
        fail(f"{what}: a path does not start at its source")
    last = nodes[ok, np.maximum(length[ok] - 1, 0)]
    if (last != dst[ok]).any():
        fail(f"{what}: a path does not end at its destination")
    a, b = nodes[:, :-1], nodes[:, 1:]
    hop = (a >= 0) & (b >= 0)
    if not (adj_h[a[hop], b[hop]] > 0).all():
        fail(f"{what}: a path uses a link the fabric lacks")
    return int(ok.sum())


def phase_kernels(p, device, report: dict) -> None:
    """K1 and K2 against their plain versions, at the main path's shapes."""
    import torch

    from sdnmpi_tpu_torch.kernels import bfs, sampler
    from sdnmpi_tpu_torch.oracle.dag import balance_rounds, sampled_hops

    t = p["t"]
    # K1: the fat-tree at its diameter, a random digraph whose V is not a
    # multiple of 128, and a truncating level budget
    rng = np.random.default_rng(0)
    v_r = 1000
    rand = (rng.random((v_r, v_r)) < 0.004).astype(np.float32)
    np.fill_diagonal(rand, 0.0)
    rand_t = torch.as_tensor(rand).to(device)
    cases = [
        ("fattree-k28 levels=diameter", t.adj, p["levels"]),
        ("random V=1000 levels=V-1", rand_t, v_r - 1),
        ("fattree-k28 levels=2", t.adj, 2),
    ]
    k1_err = 0.0
    for name, adj, levels in cases:
        got = bfs.bfs_distances(adj, levels)
        ref = bfs.bfs_distances_plain(adj, levels)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            n_bad = int((got != ref).sum())
            fail(f"K1 {name}: {n_bad} entries differ from the plain version")
        diff = torch.where(got == ref, 0.0, (got - ref).abs())
        k1_err = max(k1_err, float(diff.max()))
        log(f"K1 {name}: exact ({adj.shape[0]}x{adj.shape[0]})")
    v = t.v
    adj, lv = t.adj, p["levels"]
    k1_ms = time_ms(lambda: bfs.bfs_distances(adj, lv))
    k1_plain = time_ms(lambda: bfs.bfs_distances_plain(adj, lv))
    k1_bytes = 2 * v * v * 4  # adjacency in, distances out (f32)
    e = int((adj > 0).sum())
    k1_ops = v * e  # every source relaxes every link once
    log(f"K1 time: kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms")
    log_profile("K1 wrapper", *profile_device(lambda: bfs.bfs_distances(adj, lv)))
    report["bfs_distances"] = {
        "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
        "bytes": k1_bytes, "ops": k1_ops,
    }

    # K2 at the phase-5 shape: the balanced split weights of the
    # collective, both sampler layouts
    base = torch.zeros((v, v), dtype=torch.float32, device=device)
    weights, _, _ = balance_rounds(
        t.adj, p["dist"], base, p["traffic"], levels=lv, rounds=ROUNDS,
        dst_nodes=p["dst_nodes"],
    )
    hops = sampled_hops(lv + 1)
    args = (weights, p["dist"], p["src"], p["dst"], hops)
    k2_err = 0.0
    for name, dn in (("full", None), ("dst_nodes", p["dst_nodes"])):
        kw = {"salt": 0, "dst_nodes": dn}
        got = sampler.sample_slots(*args, **kw)
        k2_err = max(k2_err, check_k2(args, kw, got, f"program {name}"))
        measure_k2(args, kw, f"program {name}")
    report["sample_slots"] = {"max_abs_err": k2_err}
    kw = {"salt": 0, "dst_nodes": p["dst_nodes"]}
    log_profile("K2 wrapper", *profile_device(
        lambda: sampler.sample_slots(*args, **kw)))


def check_k2(args: tuple, kw: dict, got, what: str) -> float:
    """``got`` (K2's slots) must be bit-equal to the plain version on
    the same arguments; returns the largest slot difference."""
    import torch

    from sdnmpi_tpu_torch.kernels import sampler

    _, ref = sampler.sample_paths_dense(*args, **kw)
    torch.cuda.synchronize()
    n_bad = int((got != ref).sum())
    if n_bad:
        fail(f"K2 {what}: {n_bad} of {got.numel()} slots differ from the "
             "plain version")
    src = args[2]
    log(f"K2 {what}: {got.numel()} slots bit-equal (F={src.shape[0]}, "
        f"V={args[0].shape[0]}, hops={args[4]})")
    return float((got.int() - ref.int()).abs().max()) if got.numel() else 0.0


def measure_k2(args: tuple, kw: dict, what: str) -> dict:
    """Time K2 and its plain version on one call's arguments and work
    out the bytes and operations the function needs for them."""
    from sdnmpi_tpu_torch.kernels import sampler

    weights, dist, src, dst, hops = args
    dn = kw.get("dst_nodes")
    ms = time_ms(lambda: sampler.sample_slots(*args, **kw))
    plain = time_ms(lambda: sampler.sample_paths_dense(*args, **kw),
                    reps=5, warm=1)
    # candidates this run's data makes the sampler score: two logs, a
    # subtract and an add each
    nodes, _ = sampler.sample_paths_dense(*args, **kw)
    d2t = sampler.dist_rows(dist).float()[dst.long()]  # [F, V]
    n_cand = 0
    for h in range(hops):
        node = nodes[:, h].long()
        live = (node >= 0) & (node != dst.long())
        nd = d2t.gather(1, node.clamp(min=0)[:, None])
        cand = (weights[node.clamp(min=0)] > 0) & (d2t == nd - 1.0)
        n_cand += int((cand & live[:, None]).sum())
    del d2t
    v = weights.shape[0]
    f = src.shape[0]
    # weights read once; of the distances only the rows the flows'
    # destinations select ([T, V] with dst_nodes); flows in, slots out
    rows = v if dn is None else dn.shape[0]
    n_bytes = v * v * 4 + rows * v * 4 + 2 * f * 4 + f * hops
    if dn is not None:
        n_bytes += dn.shape[0] * 4
    log(f"K2 time ({what}, F={f}, distance rows {rows}): kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms; {n_cand} candidates scored; {n_bytes} bytes")
    return {"ms": ms, "plain_ms": plain, "bytes": n_bytes, "ops": 4 * n_cand}


@contextlib.contextmanager
def recording_sampler(calls: list):
    """Record ``(args, kwargs, slots)`` of every K2 call that
    ``oracle.dag`` (one device) or ``shardplane.routes`` (one call per
    shard) makes while the context is open."""
    from sdnmpi_tpu_torch.kernels import sampler
    from sdnmpi_tpu_torch.oracle import dag
    from sdnmpi_tpu_torch.shardplane import routes

    def record(*args, **kw):
        out = sampler.sample_slots(*args, **kw)
        calls.append((args, kw, out))
        return out

    dag.sample_slots = routes.sample_slots = record
    try:
        yield
    finally:
        dag.sample_slots = routes.sample_slots = sampler.sample_slots


def check_k2_calls(calls: list, launches: int, what: str) -> float:
    """Every recorded K2 call of one path's run, its ``fid_base``
    included, bit-equal to the plain version on its own arguments;
    returns the largest slot difference."""
    if len(calls) != launches:
        fail(f"{what}: {len(calls)} sampler calls recorded for {launches} "
             "launches")
    err = 0.0
    for args, kw, got in calls:
        err = max(err, check_k2(
            args, kw, got, f"{what}, fid_base {kw.get('fid_base', 0)}"))
    return err


def path_launches(fn) -> dict:
    """Run ``fn()`` with every launch count zeroed just before it and
    return the counts just after."""
    import torch

    from sdnmpi_tpu_torch.kernels import bfs, ring, sampler

    bfs.bfs_distances.launches = 0
    sampler.sample_slots.launches = 0
    ring.ring_all_gather.launches = 0
    fn()
    torch.cuda.synchronize()
    return {
        "bfs_distances": bfs.bfs_distances.launches,
        "sample_slots": sampler.sample_slots.launches,
        "ring_all_gather": ring.ring_all_gather.launches,
    }


def require_launched(counts: dict, names: tuple, what: str) -> None:
    log(f"launches, one {what} call: {counts}")
    for name in names:
        if counts[name] <= 0:
            fail(f"kernel {name} did not launch in the {what} call")


def phase_slice(k: int, n_ranks: int, v_pad: int, device, report: dict) -> dict:
    """The port's entry point: a whole alltoall through the TopologyDB.
    Returns the launch counts of its first call."""
    import torch

    from sdnmpi_tpu_torch.collectives import alltoall_pairs
    from sdnmpi_tpu_torch.topogen import fattree

    spec = fattree(k)
    db = spec.to_topology_db(backend="torch", device=device, pad_multiple=v_pad)
    macs = [m for m, _, _ in spec.hosts[:n_ranks]]
    pairs = alltoall_pairs(len(macs))
    src_idx, dst_idx = pairs[:, 0], pairs[:, 1]
    calls = []
    out = {}
    k2_calls: list = []

    def route():
        t0 = time.perf_counter()
        out["routes"] = db.find_routes_collective(
            macs, src_idx, dst_idx, policy="balanced"
        )
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0) * 1e3)

    with recording_sampler(k2_calls):
        counts = path_launches(route)
    require_launched(counts, ("sample_slots",), "find_routes_collective")
    # the sampler call of the entry point, on the arguments it was given
    err = check_k2_calls(k2_calls, counts["sample_slots"],
                         "slice (find_routes_collective)")
    args, kw, _ = k2_calls[0]
    report["sample_slots"] = {
        **measure_k2(args, kw, "slice"),
        "max_abs_err": max(err, report["sample_slots"]["max_abs_err"]),
    }
    del k2_calls, args, kw
    for _ in range(3):
        route()
    routes = out["routes"]
    log(f"slice: {len(pairs):,} pairs -> {routes.n_subflows:,} sub-flows; "
        f"first call {calls[0]:.1f} ms (includes refresh), steady "
        f"{', '.join(f'{c:.1f}' for c in calls[1:])} ms (median "
        f"{statistics.median(calls[1:]):.1f})")
    if not np.isfinite(routes.max_congestion) or routes.max_congestion <= 0:
        fail(f"slice: max_congestion {routes.max_congestion}")
    oracle = db._oracle_engine()
    # where a steady call goes: the dispatch (pair grouping and deal, hop
    # budget, device enqueue) and the reap (device wait, slot decode,
    # fdb materialization, discrete congestion)
    log_split("slice", oracle, db, macs, src_idx, dst_idx)
    log_profile("slice", *profile_device(
        lambda: db.find_routes_collective(macs, src_idx, dst_idx)
    ))
    check_routes("slice", spec, db, macs, src_idx, dst_idx, routes)
    return counts


def log_split(what: str, oracle, db, macs, src_idx, dst_idx, n: int = 3) -> None:
    """Median dispatch and reap wall times of ``n`` steady calls."""
    split = []
    for _ in range(n):
        t0 = time.perf_counter()
        window = oracle.routes_collective_dispatch(db, macs, src_idx, dst_idx)
        t1 = time.perf_counter()
        window.reap()
        split.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
    log(f"{what} split (median of {n}): dispatch "
        f"{statistics.median(d for d, _ in split):.1f} ms, reap "
        f"{statistics.median(r for _, r in split):.1f} ms")


def check_routes(what: str, spec, db, macs, src_idx, dst_idx, routes) -> None:
    """Every pair routed, from its source's edge switch to its
    destination's, over real links, on a shortest path."""
    oracle = db._oracle_engine()
    t = oracle.refresh(db)
    dist_h = oracle._dist
    host_dpid = {m: d for m, d, _ in spec.hosts}
    edge_row = np.array([t.index[host_dpid[m]] for m in macs], np.int64)
    sub = routes.pair_sub
    if (sub < 0).any() or (routes.hop_len[sub] == 0).any():
        fail(f"{what}: a pair is unrouted")
    row_of = np.full(int(t.dpids.max()) + 2, -1, np.int64)
    row_of[t.dpids] = np.arange(len(t.dpids))
    hop_rows = np.where(routes.hop_dpid >= 0, row_of[routes.hop_dpid], -1)
    length = routes.hop_len.astype(np.int64)
    first = hop_rows[:, 0]
    last = hop_rows[np.arange(len(length)), length - 1]
    s_edge = edge_row[src_idx]
    d_edge = edge_row[dst_idx]
    if (first[sub] != s_edge).any() or (last[sub] != d_edge).any():
        fail(f"{what}: a route does not join its pair's edge switches")
    if (length[sub] != dist_h[s_edge, d_edge] + 1).any():
        fail(f"{what}: a route is not a shortest path")
    a, b = hop_rows[:, :-1], hop_rows[:, 1:]
    hop = (a >= 0) & (b >= 0)
    port_h = t.host_port()
    if not (port_h[a[hop], b[hop]] >= 0).all():
        fail(f"{what}: a route uses a link the fabric lacks")
    if not (routes.hop_port[:, :-1][hop] == port_h[a[hop], b[hop]]).all():
        fail(f"{what}: a route's out-port is not its link's port")
    log(f"{what}: all {len(src_idx):,} pairs routed over shortest real paths; "
        f"max_congestion {routes.max_congestion}")


def phase_program(p, device) -> dict:
    """One route_collective with dist=None: K1, balancing and K2.
    Returns the launch counts of its first call."""
    import torch

    from sdnmpi_tpu_torch.oracle.dag import route_collective, slots_to_nodes

    t = p["t"]
    util = torch.as_tensor(
        (np.random.default_rng(1).random(p["li"].shape[0]) * 0.1).astype(np.float32)
    ).to(device)
    kw = dict(
        levels=p["levels"], rounds=ROUNDS, max_len=p["levels"] + 1,
        dst_nodes=p["dst_nodes"],
    )

    def run(dist=None):
        return route_collective(
            t.adj, p["li"], p["lj"], util, p["traffic"], p["src"], p["dst"],
            dist=dist, **kw,
        )

    out = {}
    counts = path_launches(lambda: out.update(first=run()))
    require_launched(counts, ("bfs_distances", "sample_slots"),
                     "route_collective(dist=None)")
    slots, maxc = out["first"]
    cached, maxc_c = run(p["dist"])
    if not torch.equal(slots, cached) or float(maxc) != float(maxc_c):
        fail("program: dist=None and the cached distances route differently")
    if not np.isfinite(float(maxc)):
        fail(f"program: max congestion {float(maxc)}")
    nodes = slots_to_nodes(
        t.host_adj(), p["src"].cpu().numpy(), slots.cpu().numpy(),
        dst=p["dst"].cpu().numpy(), complete=True,
    )
    n = check_paths(
        nodes, p["src"].cpu().numpy(), p["dst"].cpu().numpy(),
        p["dist"].cpu().numpy(), t.host_adj(), "program",
    )
    ms = time_ms(lambda: run(), reps=10, warm=1)
    log(f"program: {n:,} flows on valid shortest paths, fractional max "
        f"congestion {float(maxc):.3f}; {ms:.3f} ms per collective (dist=None, "
        "median of 10)")
    log_profile("program", *profile_device(run))
    return counts


def check_k3(blocks: list, mesh, what: str) -> list:
    """K3 on ``blocks`` must equal its plain version on the same blocks
    (and the gathered matrix) exactly on every shard; returns K3's output."""
    import torch

    from sdnmpi_tpu_torch.kernels import ring

    got = ring.ring_all_gather(blocks, mesh)
    padded, _, r = ring._padded_blocks(blocks)
    want = [o[:r] for o in ring.ring_all_gather_plain(padded)]
    whole = torch.cat(blocks)
    torch.cuda.synchronize()
    for q, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not torch.equal(g, w) or not torch.equal(g, whole):
            fail(f"K3 {what}: shard {q} differs from the plain version")
    return got


def phase_ring(device, report: dict) -> None:
    """K3 against its plain version: s in {2, 3, 8}, uneven R, bf16,
    int16 and int32 words, the sharded path's shapes; then timed at the
    distance exchange's shape (V = 3968 int16 wire, 8 shards)."""
    import torch

    from sdnmpi_tpu_torch.kernels import ring
    from sdnmpi_tpu_torch.shardplane import make_mesh

    rng = np.random.default_rng(5)
    v = SHARD_V
    cases = [
        (2, 1000, 256, torch.int16), (3, 1001, 130, torch.bfloat16),
        (3, 64, 3, torch.int16), (8, 1001, 384, torch.int32),
        (8, 77, 5, torch.bfloat16), (8, v, v // 2, torch.int16),
        (8, v, v, torch.float32),
    ]
    for s, r, c, dt in cases:
        mesh = make_mesh(s, device)
        x = torch.as_tensor(rng.integers(-30000, 30000, (r, c))).to(device, dt)
        b = -(-r // s)
        blocks = [x[q * b:(q + 1) * b] for q in range(s)]
        for _ in range(3):  # repeated calls ride the flags' epochs
            check_k3(blocks, mesh, f"s={s} R={r} C={c} {dt}")
        log(f"K3 s={s} R={r} C={c} {dt}: equal to the plain version, 3 calls")
    mesh = make_mesh(N_SHARDS, device)
    x = torch.as_tensor(rng.integers(-1, 5, (v, v))).to(device, torch.int16)
    rp = v // N_SHARDS
    blocks = [x[q * rp:(q + 1) * rp] for q in range(N_SHARDS)]
    check_k3(blocks, mesh, "exchange shape")
    padded = ring._padded_blocks(blocks)[0]
    ms = time_ms(lambda: ring.ring_all_gather(blocks, mesh), reps=20)
    plain = time_ms(lambda: ring.ring_all_gather_plain(padded), reps=10)
    lib = time_ms(lambda: torch.cat(blocks), reps=20)
    # each block read once, each shard's [V, V] copy written once
    n_bytes = v * v * 2 + N_SHARDS * v * v * 2
    log(f"K3 time (V={v} int16 wire, {N_SHARDS} shards, all on one card): "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.cat {lib:.4f} ms; "
        f"{n_bytes} bytes, exchange_bytes per shard "
        f"{ring.exchange_bytes(v, v, N_SHARDS)}")
    log_profile("K3 wrapper", *profile_device(
        lambda: ring.ring_all_gather(blocks, mesh)))
    report["ring_all_gather"] = {
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain, "bytes": n_bytes,
        "ops": 0, "library_ms": lib,
    }


def phase_sharded_entry(device) -> dict:
    """The sharded entry point: an 8192-rank alltoall over fat-tree k=56
    through TopologyDB(mesh_devices=8, shard_oracle, ring_exchange), held
    against a single-device TopologyDB. Returns the launch counts of one
    steady call."""
    import torch

    from sdnmpi_tpu_torch.collectives import alltoall_pairs
    from sdnmpi_tpu_torch.topogen import fattree

    spec = fattree(SHARD_K)
    flags = dict(mesh_devices=N_SHARDS, shard_oracle=True, ring_exchange=True)
    db = spec.to_topology_db(backend="torch", device=device,
                             pad_multiple=SHARD_PAD, **flags)
    macs = [m for m, _, _ in spec.hosts[:SHARD_RANKS]]
    pairs = alltoall_pairs(len(macs))
    src_idx, dst_idx = pairs[:, 0], pairs[:, 1]
    del pairs
    calls = []
    out = {}

    def route():
        t0 = time.perf_counter()
        out["routes"] = db.find_routes_collective(
            macs, src_idx, dst_idx, policy="balanced"
        )
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0) * 1e3)

    first = path_launches(route)
    log(f"launches, first sharded call (refresh included): {first}")
    k2_calls: list = []
    with recording_sampler(k2_calls):
        counts = path_launches(route)
    require_launched(counts, ("sample_slots", "ring_all_gather"),
                     "steady sharded find_routes_collective")
    # each shard's sampler call of the steady call, fid_base included
    err = check_k2_calls(k2_calls, counts["sample_slots"],
                         "steady sharded find_routes_collective")
    del k2_calls
    route()
    routes = out["routes"]
    oracle = db._oracle_engine()
    t = oracle.refresh(db)
    log(f"sharded slice: fattree-k{SHARD_K} V={t.v}, {oracle.mesh_devices} "
        f"shards on {device}; {len(src_idx):,} pairs -> {routes.n_subflows:,} "
        f"sub-flows; first call {calls[0]:.1f} ms (includes refresh), steady "
        f"{', '.join(f'{c:.1f}' for c in calls[1:])} ms (median "
        f"{statistics.median(calls[1:]):.1f})")
    if not np.isfinite(routes.max_congestion) or routes.max_congestion <= 0:
        fail(f"sharded slice: max_congestion {routes.max_congestion}")
    log_split("sharded slice", oracle, db, macs, src_idx, dst_idx, n=2)
    log_profile("sharded slice", *profile_device(
        lambda: db.find_routes_collective(macs, src_idx, dst_idx)))
    db._version += 1  # one more full refresh, counted alone
    t0 = time.perf_counter()
    refresh = path_launches(lambda: oracle.refresh(db))
    log(f"sharded refresh: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    require_launched(refresh, ("ring_all_gather",), "sharded refresh")
    check_routes("sharded slice", spec, db, macs, src_idx, dst_idx, routes)
    # the same fabric and collective on one device: the same routes
    single = spec.to_topology_db(backend="torch", device=device,
                                 pad_multiple=SHARD_PAD)
    ref = single.find_routes_collective(macs, src_idx, dst_idx, policy="balanced")
    for field in ("pair_sub", "final_port", "hop_dpid", "hop_port", "hop_len"):
        a, b = getattr(routes, field), getattr(ref, field)
        if a.shape != b.shape or not np.array_equal(a, b):
            n_bad = int((a != b).any(axis=-1).sum()) if a.shape == b.shape else -1
            fail(f"sharded slice: {field} differs from the single-device "
                 f"TopologyDB ({n_bad} rows)")
    np.testing.assert_array_equal(oracle._next, single._oracle_engine()._next)
    log(f"sharded slice: routes bit-equal to the single-device TopologyDB; "
        f"max_congestion {routes.max_congestion} / {ref.max_congestion}; "
        f"fractional {oracle.last_fractional_congestion} / "
        f"{single._oracle_engine().last_fractional_congestion}")
    return counts, err


def shard_problem(device) -> dict:
    """Config 13's primary problem: alltoall of 8192 ranks on fat-tree
    k=56 aggregated to edge-switch flows (as benchmarks/common's
    alltoall_problem builds it), end-padded to the shard count; an idle
    fabric."""
    import torch

    from sdnmpi_tpu_torch.oracle.apsp import apsp_distances
    from sdnmpi_tpu_torch.oracle.dag import make_dst_nodes
    from sdnmpi_tpu_torch.oracle.engine import tensorize
    from sdnmpi_tpu_torch.topogen import fattree

    spec = fattree(SHARD_K)
    db = spec.to_topology_db(backend="torch", device=device, pad_multiple=SHARD_PAD)
    t = tensorize(db, pad_multiple=SHARD_PAD, device=device)
    host_edge = np.array(
        [t.index[d] for _, d, _ in spec.hosts[:SHARD_RANKS]], np.int32
    )
    edges, counts = np.unique(host_edge, return_counts=True)
    ga, gb = np.meshgrid(edges, edges, indexing="ij")
    wa, wb = np.meshgrid(counts, counts, indexing="ij")
    off = ga != gb
    usrc, udst = ga[off].astype(np.int32), gb[off].astype(np.int32)
    weight = (wa[off] * wb[off]).astype(np.float32)
    pad = (-len(usrc)) % N_SHARDS
    usrc = np.concatenate([usrc, np.full(pad, -1, np.int32)])
    udst = np.concatenate([udst, np.full(pad, -1, np.int32)])
    live = usrc >= 0
    v = t.v
    traffic = np.zeros((v, v), np.float32)
    np.add.at(traffic, (udst[live], usrc[live]), weight)
    li, lj = (a.astype(np.int32) for a in np.nonzero(t.host_adj() > 0))
    dist = apsp_distances(t.adj)
    dist_h = dist.cpu().numpy()
    levels = int(dist_h[np.isfinite(dist_h)].max())
    put = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    return {
        "t": t, "dist": dist, "dist_h": dist_h, "levels": levels,
        "args": [t.adj, put(li), put(lj), put(np.zeros(len(li), np.float32)),
                 put(traffic), put(usrc), put(udst)],
        "dst_nodes": put(make_dst_nodes(udst[live])), "src": usrc, "dst": udst,
    }


def phase_sharded_program(device) -> dict:
    """route_collective_sharded on config 13's edge flows with cached
    distances and a destination set, in ring and gather modes, against
    the single-device route_collective; every shard's K2 call held
    against the plain version, and the last shard's timed. Returns the
    launch counts of one ring-mode call and the K2 check's largest
    slot difference."""
    import torch

    from sdnmpi_tpu_torch.oracle.dag import route_collective, slots_to_nodes
    from sdnmpi_tpu_torch.shardplane import make_mesh, route_collective_sharded

    p = shard_problem(device)
    mesh = make_mesh(N_SHARDS, device)
    v = p["t"].v
    rp = v // N_SHARDS
    dist_sh = [p["dist"][q * rp:(q + 1) * rp] for q in range(N_SHARDS)]
    kw = dict(levels=p["levels"], rounds=ROUNDS, max_len=p["levels"] + 1,
              dst_nodes=p["dst_nodes"])
    single, single_maxc = route_collective(*p["args"], dist=p["dist"], **kw)
    ms = time_ms(lambda: route_collective(*p["args"], dist=p["dist"], **kw),
                 reps=5, warm=1)
    log(f"single-device program at this shape: {ms:.3f} ms per collective "
        "(CUDA events, median of 5)")
    counts = {}
    err = 0.0
    for ring_mode in (True, False):
        what = "ring" if ring_mode else "gather"

        def run():
            return route_collective_sharded(
                *p["args"], mesh, dist=dist_sh, ring_exchange=ring_mode, **kw
            )

        out = {}
        k2_calls: list = []
        with recording_sampler(k2_calls):
            got = path_launches(lambda: out.update(r=run()))
        require_launched(got, ("sample_slots", "ring_all_gather"),
                         f"route_collective_sharded ({what})")
        err = max(err, check_k2_calls(
            k2_calls, got["sample_slots"],
            f"route_collective_sharded ({what})"))
        if ring_mode:
            counts = got
            # K2 at the sharded shape: one shard's flows, fid_base != 0
            k2_args, k2_kw, _ = k2_calls[-1]
            k2 = measure_k2(k2_args, k2_kw, f"sharded program, shard "
                                            f"{N_SHARDS - 1}")
            log(f"K2 sharded shape: kernel {k2['ms']:.4f} ms, bound "
                f"{bound_ms(k2)[0]:.5f} ms ({bound_ms(k2)[1]})")
        del k2_calls
        slots_sh, maxc = out["r"]
        slots = torch.cat(slots_sh)
        if not torch.equal(slots, single):
            fail(f"sharded program ({what}): "
                 f"{int((slots != single).any(dim=1).sum())} flows differ "
                 "from the single-device route_collective")
        rel = abs(float(maxc) - float(single_maxc)) / abs(float(single_maxc))
        if not rel <= 1e-5:
            fail(f"sharded program ({what}): maxc {float(maxc)} vs "
                 f"{float(single_maxc)}")
        ms = time_ms(run, reps=5, warm=1)
        log(f"sharded program ({what}): {len(p['src']):,} flows, slots "
            f"bit-equal to one device, maxc {float(maxc):.3f} vs "
            f"{float(single_maxc):.3f} (rel {rel:.2e}); {ms:.3f} ms per "
            f"collective (CUDA events, median of 5); launches {got}")
        log_profile(f"sharded program ({what})", *profile_device(run))
    live = p["src"] >= 0
    nodes = slots_to_nodes(p["t"].host_adj(), p["src"][live],
                           single.cpu().numpy()[live], dst=p["dst"][live],
                           complete=True)
    n = check_paths(nodes, p["src"][live], p["dst"][live], p["dist_h"],
                    p["t"].host_adj(), "sharded program")
    log(f"sharded program: {n:,} flows on valid shortest paths")
    return counts, err


def main() -> int:
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)

    # phase 2: build
    from sdnmpi_tpu_torch.kernels import _build

    secs = _build.build()
    log(f"build: {secs:.1f} s for {len(_build.BUILD_LOG)} kernel(s) "
        f"({', '.join(_build.SOURCES)})")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # phase 3: kernels against their plain versions
    t0 = time.perf_counter()
    p = build_problem(FATTREE_K, N_RANKS, V_PAD, device)
    log(f"problem: fattree-k{FATTREE_K} V={p['t'].v} diameter {p['levels']}, "
        f"{p['n_pairs']:,} rank pairs -> {p['src'].shape[0]:,} edge-pair "
        f"flows, T={p['dst_nodes'].shape[0]} "
        f"[{time.perf_counter() - t0:.1f} s]")
    report: dict = {}
    phase_kernels(p, device, report)

    # phases 4 and 5: the two main paths, each with its launch counts
    slice_counts = phase_slice(FATTREE_K, N_RANKS, V_PAD, device, report)
    program_counts = phase_program(p, device)
    del p

    # phases 7 to 9: K3, then the sharded entry point and one program
    phase_ring(device, report)
    entry_counts, entry_err = phase_sharded_entry(device)
    shard_counts, shard_err = phase_sharded_program(device)
    report["sample_slots"]["max_abs_err"] = max(
        report["sample_slots"]["max_abs_err"], entry_err, shard_err)
    paths = (slice_counts, program_counts, entry_counts, shard_counts)
    launches = {n: sum(c[n] for c in paths) for n in slice_counts}

    # phase 6: report
    meta = {
        "bfs_distances": ("csrc/bfs.cu", "sdnmpi_tpu/kernels/bfs.py:130"),
        "sample_slots": ("csrc/sampler.cu", "sdnmpi_tpu/kernels/sampler.py:245"),
        "ring_all_gather": ("csrc/ring.cu", "sdnmpi_tpu/kernels/ring.py:365"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = report[name]
        bound, bound_by = bound_ms(r)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"sdnmpi_tpu_torch/kernels/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound, "bound_by": bound_by,
            "library_ms": r.get("library_ms"),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())

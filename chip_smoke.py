"""Drive sdnmpi_tpu_torch's routing paths on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and builds the
package's kernels from ``sdnmpi_tpu_torch/kernels/csrc``. Phases, in
order; the first failure ends the run with a non-zero exit:

1. device   — a CUDA card is present; print its name and power limit.
2. build    — build kernels K1 (BFS), K2 (path sampler and its set-up)
               and K3 (all-gather), one nvcc per source, in parallel.
3. kernels  — K1 exactly against its plain version at every sources-per-
               block width that fits (config 4's fat-tree at its
               diameter, 2 and 0 levels; an asymmetric random digraph
               and a directed chain of 1000 nodes at 999 levels; config
               13's k=56 fat-tree at V=3,968), timed at both fat-trees'
               shapes beside its bound and swept over the widths; K2
               against its plain version on the card at the main path's
               shapes (bit for bit, in both sampler layouts, with K2's
               tables built by the wrapper and with the topology table
               of tensorize), timed with CUDA events and the profiler,
               as its per-call set-up and its kernel apart, and the
               one-time topology table apart from both.
4. slice    — a 4096-rank alltoall over a k=28 fat-tree (980 switches,
               padded to V=1024) through TopologyDB.find_routes_collective;
               every routed pair is checked against the fabric.
5. program  — one route_collective call with no cached distances at the
               bench-config-4 shape (~86k aggregated edge-pair flows,
               rounds=2): K1 and K2 in one call.
6. report   — one JSON line of per-kernel numbers, then the result line;
               printed last, after phases 7 to 12.
7. ring     — K3 against its plain version (s in {2, 3, 8}, uneven rows,
               bf16/int16/int32/f32 words, exactly, three calls each),
               timed at the distance exchange's shape beside
               torch.cat(blocks * s), which writes the same s copies, and
               torch.cat(blocks), one copy.
8. sharded  — config 13's primary shape: an 8192-rank alltoall over a
               k=56 fat-tree (3,920 switches, V=3,968) through
               TopologyDB(mesh_devices=8, shard_oracle=True,
               ring_exchange=True), all 8 shards on this card; every pair
               checked, routes bit-equal to a single-device TopologyDB.
9. sharded program — route_collective_sharded on config 13's edge flows
               in ring and gather modes, slots bit-equal to the
               single-device route_collective; K2 timed at one shard's
               share of the flows, set-up and kernel apart.
10. UGAL program — config 5's route_adaptive with no cached distances: a
               dragonfly of 8 groups of 32 routers (V=256), 10,000 flows
               in the adversarial +1-group shift, the direct global links
               loaded; K1 exact at V=256, both K2 segment launches (one
               shared set-up) bit-equal to their plain versions, packed
               and unpacked results, two calls identical, every segment a
               shortest path, forced-minimal beside adaptive.
11. pair batches — TopologyDB.find_routes_batch_adaptive,
               find_routes_batch_balanced (DAG and greedy legs),
               find_routes_batch (device and host chase) and
               find_routes_batch_dispatch on that fabric with the same
               flows as host pairs; every fdb checked, the shortest legs
               against find_route.
12. collective policies — find_routes_collective(policy="shortest" and
               "adaptive") over phase 4's fat-tree and alltoall, every
               pair checked.

Launch counts are zeroed just before one call of each path and read just
after it: find_routes_collective (phase 4), route_collective(dist=None)
(phase 5), one steady sharded find_routes_collective and one sharded
refresh (phase 8), one route_collective_sharded call per mode (phase 9),
route_adaptive(dist=None) (phase 10, exactly K1 1, set-up 1, K2 2), each
pair-batch entry point (phase 11) and each collective policy (phase 12),
the last two against the counts each path must launch.
A kernel of a path that did not launch in its call fails the run. The
sampler call of phase 4 is recorded and held bit for bit against the
plain version on its own arguments, and so are both of phase 10's and
every shard's sampler call
(with its ``fid_base``) of the steady sharded call and of each
route_collective_sharded call, and the tables its set-up kernels
(``sampler_tables``) built for it against the plain set-up. The set-up
has a launch count of its own: every call must launch it once for its
one device, however many shards sample, and the profiles of the entry
points and the programs must show no sort kernel. Nothing here imports JAX or the JAX package.
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
#: nodes of K1's asymmetric random digraph and directed chain
DIGRAPH_V = 1000
#: config 5 (benchmarks/config5_dragonfly.py): a dragonfly of 8 groups of
#: 32 routers, 10,000 flows, 8.0 flow units on the direct global links,
#: route_adaptive(levels=4, rounds=2, max_len=8, n_candidates=8)
DFLY_GROUPS = 8
DFLY_ROUTERS = 32
DFLY_FLOWS = 10_000
DFLY_UTIL = 8.0
DFLY_LEVELS = 4
DFLY_MAX_LEN = 8
DFLY_CANDIDATES = 8


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


def queued_ms(fn, n: int = 50) -> float:
    """Device time per call of ``fn()`` in ms: ``n`` calls queued behind
    a spin kernel, so that the host's launch time between them does not
    show, with CUDA events around the ``n`` calls. When ``fn`` launches
    one kernel, this is the bare kernel's time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # some 25 ms, longer than the enqueueing
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def profile_device(fn) -> tuple[float, float, list]:
    """Run ``fn()`` once under torch.profiler: (wall ms, summed device
    time ms of the kernels and copies it ran, every (ms, name, count) by
    time)."""
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
    return wall, sum(r[0] for r in rows), rows


def log_profile(what: str, wall: float, busy: float, rows: list,
                top: int = 6) -> list:
    """Log a profile's wall, device busy time and its ``top`` kernels;
    returns ``rows``."""
    if not rows:
        log(f"{what} profile: wall {wall:.3f} ms; the profiler recorded no "
            "device time")
        return rows
    log(f"{what} profile: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f}% of wall)")
    for ms, name, n in rows[:top]:
        log(f"  {ms:9.3f} ms  x{n:<4d} {name[:90]}")
    return rows


def device_ms(rows: list, name: str) -> float:
    """Summed device time of the profiled kernels whose name holds
    ``name``."""
    return sum(ms for ms, n, _ in rows if name in n)


def require_no_sort(rows: list, what: str) -> None:
    """K2's per-call path builds no ``[V, V]`` sorted table any more: a
    sort kernel in ``what``'s profile fails the run."""
    if not rows:
        fail(f"{what}: the profiler recorded no kernels to check for sorts")
    sorts = [n for _, n, _ in rows if "sort" in n.lower()]
    if sorts:
        fail(f"{what}: the profile shows sort kernels: {sorts[:3]}")
    log(f"{what}: no sort kernel among {len(rows)} profiled kernels")


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


def fattree_tensors(k: int, v_pad: int, device):
    """A k-ary fat-tree's TopoTensors (the compact table included), padded
    as the TopologyDB pads it, and its diameter."""
    from sdnmpi_tpu_torch.oracle.apsp import apsp_distances
    from sdnmpi_tpu_torch.oracle.engine import tensorize
    from sdnmpi_tpu_torch.topogen import fattree

    db = fattree(k).to_topology_db(backend="torch", device=device,
                                   pad_multiple=v_pad)
    t = tensorize(db, pad_multiple=v_pad, device=device)
    dist = apsp_distances(t.adj).cpu().numpy()
    return t, int(dist[np.isfinite(dist)].max())


def check_k1(adj, levels: int, neigh, what: str):
    """K1 through its wrapper must equal the plain version exactly;
    returns the plain distances and the largest difference (0.0)."""
    import torch

    from sdnmpi_tpu_torch.kernels import bfs

    got = bfs.bfs_distances(adj, levels, neigh=neigh)
    ref = bfs.bfs_distances_plain(adj, levels)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        fail(f"K1 {what}: {int((got != ref).sum())} entries differ from the "
             "plain version")
    fin = ref[torch.isfinite(ref)]
    log(f"K1 {what}: exact ({adj.shape[0]}x{adj.shape[0]}, {levels} levels, "
        f"largest distance {int(fin.max()) if fin.numel() else 0})")
    return ref, float(torch.where(got == ref, 0.0, (got - ref).abs()).max())


def time_k1(adj, levels: int, neigh, what: str, widths: dict) -> dict:
    """K1 at one shape: the wrapper with the topology table (CUDA events),
    the bare kernel (:func:`queued_ms`), the wrapper building its own
    table and the plain version, and the bare kernel at each width of
    ``widths`` (:func:`sweep_k1`'s times), beside the bound: the table in
    and the [V, V] f32 distances out, once each."""
    from sdnmpi_tpu_torch.kernels import bfs

    v = adj.shape[0]
    ms = time_ms(lambda: bfs.bfs_distances(adj, levels, neigh=neigh))
    bare = queued_ms(lambda: bfs.bfs_distances(adj, levels, neigh=neigh))
    own = time_ms(lambda: bfs.bfs_distances(adj, levels))
    plain = time_ms(lambda: bfs.bfs_distances_plain(adj, levels))
    n_bytes = v * neigh.shape[1] * 4 + v * v * 4
    ops = v * int((neigh < v).sum())  # every source relaxes every link once
    bound = bound_ms({"bytes": n_bytes, "ops": ops})[0]
    log(f"K1 time ({what}, V={v}, D={neigh.shape[1]}, {levels} levels): "
        f"wrapper with the topology table {ms:.4f} ms, bare kernel "
        f"{bare:.4f} ms (queued), wrapper building its own table "
        f"{own:.4f} ms, plain {plain:.4f} ms; bound {bound:.5f} ms for "
        f"{n_bytes} bytes (wrapper {100 * bound / ms:.1f}%, bare "
        f"{100 * bound / bare:.1f}% of it); bare by sources per block "
        + ", ".join(f"{s}: {t:.4f} ms ({100 * bound / t:.1f}%)"
                    for s, t in widths.items()))
    return {"ms": ms, "plain_ms": plain, "bytes": n_bytes, "ops": ops}


def sweep_k1(neigh, levels: int, ref, what: str) -> dict:
    """K1's bare kernel at every sources-per-block width whose block fits
    shared memory, each launch exact against ``ref``, each width timed
    (:func:`queued_ms` over 50 uncounted launches) beside the width the
    wrapper picks: the evidence for ``bfs.sources_per_block``. Returns
    the times by width."""
    import torch

    from sdnmpi_tpu_torch.kernels import _build, bfs

    v = neigh.shape[0]
    steps = min(levels, v - 1)
    out = torch.empty_like(ref)
    times = {}
    for s in bfs.SOURCE_WIDTHS:
        if bfs.smem_bytes(v, s, steps) > bfs.SMEM_LIMIT:
            continue
        out.fill_(-1.0)
        bfs.launch_kernel(neigh, steps, s, out)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"K1 {what}: {s} sources per block: "
                 f"{int((out != ref).sum())} entries differ from the plain version")
        times[s] = queued_ms(lambda: bfs.launch_kernel(neigh, steps, s, out))
    pick = bfs.sources_per_block(v, steps, _build.sm_count(neigh.device))
    log(f"K1 bare kernel by sources per block ({what}, exact at each): "
        + ", ".join(f"{s}: {ms:.4f} ms" for s, ms in times.items())
        + f"; {sorted(set(bfs.SOURCE_WIDTHS) - set(times))} do not fit shared "
        f"memory; the wrapper picks {pick}")
    return times


def phase_bfs(device, report: dict) -> None:
    """K1 exactly against its plain version: config 4's fat-tree (k=28,
    V=1024) at its diameter, at 2 levels and at 0, an asymmetric random
    digraph and a directed chain (V=1000, V-1 levels: distances up to
    999), and config 13's fat-tree (k=56, V=3,968) with its topology
    table; then timed at both fat-trees' shapes."""
    import torch

    from sdnmpi_tpu_torch.kernels import bfs

    t4, lv4 = fattree_tensors(FATTREE_K, V_PAD, device)
    t13, lv13 = fattree_tensors(SHARD_K, SHARD_PAD, device)
    rng = np.random.default_rng(0)
    v_r = DIGRAPH_V
    rand = (rng.random((v_r, v_r)) < 0.004).astype(np.float32)
    np.fill_diagonal(rand, 0.0)
    chain = np.zeros((v_r, v_r), np.float32)
    chain[np.arange(v_r - 1), np.arange(1, v_r)] = 1.0
    put = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    cases = [
        (f"fattree-k{FATTREE_K} levels=diameter", t4.adj, lv4, t4.neigh),
        (f"fattree-k{FATTREE_K} levels=2", t4.adj, 2, t4.neigh),
        (f"fattree-k{FATTREE_K} levels=0", t4.adj, 0, t4.neigh),
        ("random digraph V=1000 levels=V-1", put(rand), v_r - 1, None),
        ("directed chain V=1000 levels=V-1", put(chain), v_r - 1, None),
        (f"fattree-k{SHARD_K} levels=diameter", t13.adj, lv13, t13.neigh),
    ]
    widths = {}
    err = 0.0
    for what, adj, levels, neigh in cases:
        ref, case_err = check_k1(adj, levels, neigh, what)
        err = max(err, case_err)
        if what.startswith("directed chain") and float(ref[0, v_r - 1]) != v_r - 1:
            fail(f"K1 {what}: the chain's far end reads {float(ref[0, -1])}")
        widths[what] = sweep_k1(
            bfs.neighbor_rows_of(adj) if neigh is None else neigh, levels, ref, what)
    # the one-time topology build (per topology version) of the compact
    # table that K1 and K2 walk
    adj, d = t4.adj, t4.max_degree
    topo = time_ms(lambda: bfs.neighbor_rows(adj > 0, d))
    log(f"topology table [V={t4.v}, D={d}]: {topo:.4f} ms per build (once "
        "per topology version, CUDA events)")
    log_profile("topology table", *profile_device(
        lambda: bfs.neighbor_rows(adj > 0, d)))
    log_profile("K1 wrapper", *profile_device(
        lambda: bfs.bfs_distances(adj, lv4, neigh=t4.neigh)))
    for t, lv, k in ((t4, lv4, FATTREE_K), (t13, lv13, SHARD_K)):
        what = f"fattree-k{k}"
        r = time_k1(t.adj, lv, t.neigh, what, widths[f"{what} levels=diameter"])
        report.setdefault("bfs_distances", {**r, "max_abs_err": err})


def phase_kernels(p, device, report: dict) -> None:
    """K2 against its plain version, at the main path's shapes."""
    import torch

    from sdnmpi_tpu_torch.kernels import sampler
    from sdnmpi_tpu_torch.oracle.dag import balance_rounds, sampled_hops

    t = p["t"]
    v, lv, neigh = t.v, p["levels"], t.neigh
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
        for how, tabs in (
            ("tables built by the wrapper", None),
            ("tensorize's table", sampler.sampler_tables(
                weights, p["dist"], dn, neigh=neigh)),
        ):
            got = sampler.sample_slots(*args, **kw, tables=tabs)
            k2_err = max(k2_err, check_k2(args, kw, got, f"program {name}, {how}"))
        measure_k2(args, kw, f"program {name}", neigh)
    report["sample_slots"] = {"max_abs_err": k2_err}


def check_k2(args: tuple, kw: dict, got, what: str) -> float:
    """``got`` (K2's slots) must be bit-equal to the plain version on
    the same arguments; returns the largest slot difference."""
    import torch

    from sdnmpi_tpu_torch.kernels import sampler

    if kw.get("tables") is not None:
        check_tables(args, kw, what)
    kw = {k: x for k, x in kw.items() if k != "tables"}
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


def check_tables(args: tuple, kw: dict, what: str) -> float:
    """The tables that K2's set-up kernels built for a call must be
    bit-equal to the plain set-up on the same inputs; returns the largest
    difference (0.0)."""
    import torch

    from sdnmpi_tpu_torch.kernels import sampler

    got = kw["tables"]
    ref = sampler.sampler_tables_plain(args[0], args[1], kw.get("dst_nodes"),
                                       got.neigh)
    torch.cuda.synchronize()
    for field in ("neigh", "lw", "dtab", "row_of"):
        a, b = getattr(got, field), getattr(ref, field)
        if (a is None) != (b is None) or (
                a is not None and (a.shape != b.shape or not torch.equal(a, b))):
            fail(f"K2 set-up {what}: {field} differs from the plain set-up")
    return max(float((got.lw.float() - ref.lw.float()).abs().max()),
               float((got.dtab.float() - ref.dtab.float()).abs().max()))


def sweep_lane_groups(args: tuple, kw: dict, tabs, what: str) -> float:
    """K2's bare kernel at each lanes-per-flow width on one call's
    tables (:func:`queued_ms` over 50 uncounted launches, each width
    checked bit-equal to the wrapper's slots), beside the width the
    wrapper picks: the evidence for ``sampler.lane_group``. Returns the
    bare time at the wrapper's width."""
    import torch

    from sdnmpi_tpu_torch.kernels import _build, sampler

    weights, _, src, dst, hops = args
    dev = weights.device
    want = sampler.sample_slots(*args, **kw, tables=tabs)
    f, d = src.shape[0], tabs.neigh.shape[1]
    out = torch.empty_like(want)
    salt, fid_base = kw.get("salt", 0), kw.get("fid_base", 0)

    def launch(g):
        sampler.launch_kernel(tabs, src, dst, hops, salt, fid_base, g, out)

    times = {}
    for g in (4, 8):
        out.fill_(99)
        launch(g)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            fail(f"K2 {what}: {g} lanes per flow differ from the wrapper's slots")
        times[g] = queued_ms(lambda: launch(g))
    pick = sampler.lane_group(f, _build.sm_count(dev))
    log(f"K2 bare kernel by lanes per flow ({what}, F={f}, D={d}): "
        + ", ".join(f"{g}: {ms:.4f} ms" for g, ms in times.items())
        + f"; the wrapper picks {pick}")
    return times[pick]


def measure_k2(args: tuple, kw: dict, what: str, neigh) -> dict:
    """Time K2 on one call's arguments as the main path runs it (the
    topology table ``neigh`` given: the per-call set-up, then the
    kernel), each of the two alone, the wrapper building everything
    itself, and the plain version; work out the bytes and operations the
    function needs for them. ``ms`` is set-up plus kernel."""
    import torch

    from sdnmpi_tpu_torch.kernels import sampler

    weights, dist, src, dst, hops = args
    kw = {k: x for k, x in kw.items() if k != "tables"}
    dn = kw.get("dst_nodes")

    def set_up():
        return sampler.sampler_tables(weights, dist, dn, neigh=neigh)

    tabs = set_up()
    setup_err = check_tables(args, {**kw, "tables": tabs}, what)
    setup_ms = time_ms(set_up)
    setup_bare = queued_ms(set_up)
    setup_plain = time_ms(
        lambda: sampler.sampler_tables_plain(weights, dist, dn, neigh))
    kernel_ms = time_ms(lambda: sampler.sample_slots(*args, **kw, tables=tabs))
    ms = time_ms(lambda: sampler.sample_slots(*args, **kw, tables=set_up()))
    own = time_ms(lambda: sampler.sample_slots(*args, **kw))
    plain = time_ms(lambda: sampler.sample_paths_dense(*args, **kw),
                    reps=5, warm=1)
    _, setup_busy, _ = profile_device(set_up)
    bare = sweep_lane_groups(args, kw, tabs, what)
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
    d = neigh.shape[1]
    links = int((neigh < v).sum())
    t = 0 if dn is None else dn.shape[0]
    rows = v if dn is None else t  # rows of the set-up's distance table
    # the distance rows this run's flows read: one per distinct destination
    n_dst = int(torch.unique(dst[dst >= 0]).numel())
    flows = 2 * f * 4 + f * hops  # src and dst in, slots out
    # set-up + kernel (the path's ``ms``): the topology table and its
    # links' f32 weights, the f32 distance columns of the destinations the
    # flows name and the set, once each
    n_bytes = v * d * 4 + links * 4 + n_dst * v * 4 + t * 4 + flows
    # the kernel alone: the table, its bf16 log weights, the bf16 rows the
    # flows read (and each destination's row)
    kernel_bytes = v * d * 6 + n_dst * v * 2 + (0 if dn is None else n_dst * 4) + flows
    # the dense yardstick, [V, V] f32 weights and the set-up's f32
    # distance rows read once (what a [V, V] formulation moves)
    dense_bytes = v * v * 4 + rows * v * 4 + t * 4 + flows
    # the set-up: the table in, each link's weight, the distance columns
    # the rows name (and the set); log weights, rows (and row_of) out
    setup_bytes = v * d * 4 + links * 4 + rows * v * 4 + v * d * 2 + rows * v * 2
    if dn is not None:
        setup_bytes += t * 4 + v * 4
    ops = 4 * n_cand + 2 * links
    log(f"K2 time ({what}, F={f}, distance rows {rows}, table width "
        f"{d}): set-up + kernel {ms:.4f} ms = set-up "
        f"{setup_ms:.4f} ms (bare {setup_bare:.4f} ms queued, device "
        f"{setup_busy:.4f} ms profiled, plain "
        f"{setup_plain:.4f} ms) + kernel "
        f"{kernel_ms:.4f} ms (bare {bare:.4f} ms); wrapper building its own "
        f"tables {own:.4f} ms; plain {plain:.4f} ms; {n_cand} candidates "
        f"scored")
    bounds = {name: bound_ms({"bytes": b, "ops": o})[0] for name, b, o in (
        ("path", n_bytes, ops), ("kernel", kernel_bytes, 4 * n_cand),
        ("set-up", setup_bytes, 2 * links), ("dense", dense_bytes, ops))}
    log(f"K2 bounds ({what}, {n_dst} distinct destinations): set-up + kernel "
        f"{bounds['path']:.5f} ms ({n_bytes} bytes; {ms / bounds['path']:.1f}x); "
        f"kernel alone {bounds['kernel']:.5f} ms ({kernel_bytes} bytes; bare "
        f"{bare / bounds['kernel']:.1f}x); set-up alone {bounds['set-up']:.5f} "
        f"ms ({setup_bytes} bytes; device time {setup_busy / bounds['set-up']:.1f}x "
        f"it); dense yardstick ([V, V] weights read once) "
        f"{bounds['dense']:.5f} ms ({dense_bytes} bytes)")
    return {"ms": ms, "plain_ms": plain, "bytes": n_bytes, "ops": ops,
            "setup": {"ms": setup_ms, "plain_ms": setup_plain,
                      "bytes": setup_bytes, "ops": 2 * links,
                      "max_abs_err": setup_err}}


@contextlib.contextmanager
def recording_sampler(calls: list):
    """Record ``(args, kwargs, slots)`` of every K2 call that
    ``oracle.dag`` (one device), ``oracle.adaptive`` (two segments) or
    ``shardplane.routes`` (one call per shard) makes while the context is
    open."""
    from sdnmpi_tpu_torch.kernels import sampler
    from sdnmpi_tpu_torch.oracle import adaptive, dag
    from sdnmpi_tpu_torch.shardplane import routes

    def record(*args, **kw):
        out = sampler.sample_slots(*args, **kw)
        calls.append((args, kw, out))
        return out

    dag.sample_slots = routes.sample_slots = adaptive.sample_slots = record
    try:
        yield
    finally:
        dag.sample_slots = routes.sample_slots = sampler.sample_slots
        adaptive.sample_slots = sampler.sample_slots


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
            args, kw, got, f"{what}, fid_base {kw.get('fid_base', 0)}, salt "
            f"{kw.get('salt', 0):#x}"))
    return err


def checked_launches(fn, what: str, report: dict) -> dict:
    """:func:`path_launches` of ``fn()`` with every K2 call recorded and
    held, its set-up's tables included, against the plain versions
    (:func:`check_k2_calls`, folded into ``report``); two launches in one
    call (UGAL's segments) must share one set-up."""
    k2_calls: list = []
    with recording_sampler(k2_calls):
        counts = path_launches(fn)
    report["sample_slots"]["max_abs_err"] = max(
        report["sample_slots"]["max_abs_err"],
        check_k2_calls(k2_calls, counts["sample_slots"], what))
    if len(k2_calls) == 2 and k2_calls[0][1]["tables"] is not k2_calls[1][1]["tables"]:
        fail(f"{what}: the two segment launches did not share one set-up")
    return counts


def path_launches(fn) -> dict:
    """Run ``fn()`` with every launch count zeroed just before it and
    return the counts just after."""
    import torch

    from sdnmpi_tpu_torch.kernels import bfs, ring, sampler

    bfs.bfs_distances.launches = 0
    sampler.sample_slots.launches = 0
    ring.ring_all_gather.launches = 0
    sampler.sampler_tables.launches = 0
    fn()
    torch.cuda.synchronize()
    return {
        "bfs_distances": bfs.bfs_distances.launches,
        "sampler_tables": sampler.sampler_tables.launches,
        "sample_slots": sampler.sample_slots.launches,
        "ring_all_gather": ring.ring_all_gather.launches,
    }


def require_one_set_up(counts: dict, what: str) -> None:
    """K2's set-up runs once per device per call (one card here), however
    many shards launch the sampler."""
    if counts["sampler_tables"] != 1:
        fail(f"{what}: {counts['sampler_tables']} K2 set-ups for "
             f"{counts['sample_slots']} launches on one device")
    log(f"{what}: 1 K2 set-up for {counts['sample_slots']} sampler launches")


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
    require_launched(counts, ("sampler_tables", "sample_slots"),
                     "find_routes_collective")
    # the sampler call of the entry point, on the arguments it was given
    err = check_k2_calls(k2_calls, counts["sample_slots"],
                         "slice (find_routes_collective)")
    require_one_set_up(counts, "find_routes_collective")
    args, kw, _ = k2_calls[0]
    k2 = measure_k2(args, kw, "slice", kw["tables"].neigh)
    report["sampler_tables"] = k2.pop("setup")
    report["sample_slots"] = {
        **k2, "max_abs_err": max(err, report["sample_slots"]["max_abs_err"]),
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
    require_no_sort(log_profile("slice", *profile_device(
        lambda: db.find_routes_collective(macs, src_idx, dst_idx)
    )), "slice")
    check_routes("slice", spec, db, macs, src_idx, dst_idx, routes)
    return counts


def log_split(what: str, oracle, db, macs, src_idx, dst_idx, n: int = 3,
              policy: str = "balanced") -> None:
    """Median dispatch and reap wall times of ``n`` steady calls."""
    split = []
    for _ in range(n):
        t0 = time.perf_counter()
        window = oracle.routes_collective_dispatch(db, macs, src_idx, dst_idx,
                                                   policy)
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
        dst_nodes=p["dst_nodes"], neigh=t.neigh,
    )

    def run(dist=None):
        return route_collective(
            t.adj, p["li"], p["lj"], util, p["traffic"], p["src"], p["dst"],
            dist=dist, **kw,
        )

    out = {}
    counts = path_launches(lambda: out.update(first=run()))
    require_launched(counts, ("bfs_distances", "sampler_tables", "sample_slots"),
                     "route_collective(dist=None)")
    require_one_set_up(counts, "route_collective(dist=None)")
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
    require_no_sort(log_profile("program", *profile_device(run)), "program")
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
        for _ in range(3):  # repeated calls reuse nothing of the last
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
    # one PyTorch call writing the same s copies, and one copy
    lib = time_ms(lambda: torch.cat(blocks * N_SHARDS), reps=20)
    one = time_ms(lambda: torch.cat(blocks), reps=20)
    # each block read once, each shard's [V, V] copy written once
    n_bytes = v * v * 2 + N_SHARDS * v * v * 2
    rows = log_profile("K3 wrapper", *profile_device(
        lambda: ring.ring_all_gather(blocks, mesh)))
    log(f"K3 time (V={v} int16 wire, {N_SHARDS} shards, all on one card): "
        f"wrapper {ms:.4f} ms (bare kernel "
        f"{device_ms(rows, 'broadcast_gather'):.4f} ms), plain {plain:.4f} ms, "
        f"torch.cat(blocks * {N_SHARDS}) {lib:.4f} ms, torch.cat(blocks) "
        f"(one copy) {one:.4f} ms; {n_bytes} bytes, exchange_bytes per shard "
        f"{ring.exchange_bytes(v, v, N_SHARDS)}")
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
    require_launched(counts, ("sampler_tables", "sample_slots", "ring_all_gather"),
                     "steady sharded find_routes_collective")
    # each shard's sampler call of the steady call, fid_base included
    err = check_k2_calls(k2_calls, counts["sample_slots"],
                         "steady sharded find_routes_collective")
    require_one_set_up(counts, "steady sharded find_routes_collective")
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
    require_no_sort(log_profile("sharded slice", *profile_device(
        lambda: db.find_routes_collective(macs, src_idx, dst_idx))), "sharded slice")
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
              dst_nodes=p["dst_nodes"], neigh=p["t"].neigh)
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
        require_launched(got, ("sampler_tables", "sample_slots", "ring_all_gather"),
                         f"route_collective_sharded ({what})")
        err = max(err, check_k2_calls(
            k2_calls, got["sample_slots"],
            f"route_collective_sharded ({what})"))
        require_one_set_up(got, f"route_collective_sharded ({what})")
        if ring_mode:
            counts = got
            # K2 at the sharded shape: one shard's flows, fid_base != 0
            k2_args, k2_kw, _ = k2_calls[-1]
            k2 = measure_k2(k2_args, k2_kw, f"sharded program, shard "
                                            f"{N_SHARDS - 1}", p["t"].neigh)
            log(f"K2 sharded shape: set-up + kernel {k2['ms']:.4f} ms, "
                f"bound {bound_ms(k2)[0]:.5f} ms ({bound_ms(k2)[1]})")
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
        require_no_sort(log_profile(f"sharded program ({what})",
                                    *profile_device(run), top=12),
                        f"sharded program ({what})")
    live = p["src"] >= 0
    nodes = slots_to_nodes(p["t"].host_adj(), p["src"][live],
                           single.cpu().numpy()[live], dst=p["dst"][live],
                           complete=True)
    n = check_paths(nodes, p["src"][live], p["dst"][live], p["dist_h"],
                    p["t"].host_adj(), "sharded program")
    log(f"sharded program: {n:,} flows on valid shortest paths")
    return counts, err


def dragonfly_problem(device) -> dict:
    """Config 5's problem (``benchmarks/config5_dragonfly.py``): the
    dragonfly of 8 groups of 32 routers (one host each, 2 global links per
    router; V = 256), 10,000 flows in the adversarial +1-group shift drawn
    from ``default_rng(0)`` as the config draws them, and 8.0 flow units
    of measured load on every direct next-group global link."""
    import torch

    from sdnmpi_tpu_torch.oracle.engine import tensorize
    from sdnmpi_tpu_torch.topogen import dragonfly

    spec = dragonfly(DFLY_GROUPS, DFLY_ROUTERS, hosts_per_router=1, global_links=2)
    db = spec.to_topology_db(backend="torch", device=device)
    t = tensorize(db, device=device)
    v = t.v
    adj = t.host_adj()
    rng = np.random.default_rng(0)
    src = rng.integers(0, spec.n_switches, DFLY_FLOWS).astype(np.int32)
    grp = src // DFLY_ROUTERS
    dst = (((grp + 1) % DFLY_GROUPS) * DFLY_ROUTERS
           + rng.integers(0, DFLY_ROUTERS, DFLY_FLOWS)).astype(np.int32)
    weight = np.ones(DFLY_FLOWS, np.float32)
    groups_idx = np.arange(v) // DFLY_ROUTERS
    direct = (groups_idx[None, :] == (groups_idx[:, None] + 1) % DFLY_GROUPS) & (adj > 0)
    util = np.where(direct, DFLY_UTIL, 0.0).astype(np.float32)
    put = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    return {"spec": spec, "t": t, "src": src, "dst": dst, "weight": weight,
            "util": util, "direct": direct, "src_d": put(src), "dst_d": put(dst),
            "w_d": put(weight), "util_d": put(util)}


def check_segments(adj_h, dist_h, src, dst, inter, n1, n2, what: str) -> np.ndarray:
    """Every flow's two segments are shortest paths over real links (the
    second only for detours) and stitch into one path from src to dst;
    returns the stitched paths."""
    from sdnmpi_tpu_torch.oracle.adaptive import stitch_paths

    detour = inter >= 0
    mid = np.where(detour, inter, dst)
    check_paths(n1, src, mid, dist_h, adj_h, f"{what} segment 1")
    if detour.any():
        check_paths(n2[detour], mid[detour], dst[detour], dist_h, adj_h,
                    f"{what} segment 2")
    if (n2[~detour] >= 0).any():
        fail(f"{what}: a minimal flow has a second segment")
    paths = stitch_paths(n1, n2, inter)
    length = (paths >= 0).sum(axis=1)
    last = paths[np.arange(len(paths)), np.maximum(length - 1, 0)]
    if (paths[:, 0] != src).any() or (last != dst).any():
        fail(f"{what}: a stitched path does not join its flow's endpoints")
    a, b = paths[:, :-1], paths[:, 1:]
    hop = (a >= 0) & (b >= 0)
    if not (adj_h[a[hop], b[hop]] > 0).all():
        fail(f"{what}: a stitched path uses a link the fabric lacks")
    return paths


def phase_ugal_program(device, report: dict) -> dict:
    """Config 5's UGAL program, ``route_adaptive`` with no cached
    distances: K1 exactly against its plain version at V = 256, four
    levels and 33-wide rows; both of K2's segment launches and their one
    shared set-up recorded and held bit for bit against the plain
    versions; launches K1 1, set-up 1, K2 2 per call; packed and unpacked
    results, two calls identical, every segment a shortest path over real
    links; forced-minimal (bias 1e9) detours nothing. Reports the detour
    share, the discrete max link load against forced-minimal, the program
    time and the device busy share. Returns the launch counts of one
    call."""
    import torch

    from sdnmpi_tpu_torch.kernels import bfs
    from sdnmpi_tpu_torch.oracle.adaptive import (
        decode_segments,
        link_loads,
        route_adaptive,
        stitch_paths,
    )

    p = dragonfly_problem(device)
    t = p["t"]
    v = t.v
    adj_h = t.host_adj()
    kw = dict(levels=DFLY_LEVELS, rounds=ROUNDS, max_len=DFLY_MAX_LEN,
              n_candidates=DFLY_CANDIDATES, neigh=t.neigh)

    def run(bias=1.0, packed=False):
        return route_adaptive(t.adj, p["util_d"], p["src_d"], p["dst_d"], p["w_d"],
                              t.n_real, bias=bias, packed=packed, **kw)

    log(f"dragonfly g{DFLY_GROUPS}a{DFLY_ROUTERS}: V={v}, "
        f"{int((adj_h > 0).sum())} directed links, table width "
        f"{t.neigh.shape[1]} ({int((adj_h > 0).sum(axis=1).max())} links per "
        f"router), {DFLY_FLOWS:,} flows, {int(p['direct'].sum())} loaded links")
    # K1 on the inputs the program gives it
    dist, k1_err = check_k1(t.adj, DFLY_LEVELS, t.neigh, f"dragonfly V={v} levels=4")
    widths = sweep_k1(t.neigh, DFLY_LEVELS, dist, f"dragonfly V={v} levels=4")
    time_k1(t.adj, DFLY_LEVELS, t.neigh, f"dragonfly V={v}", widths)
    report["bfs_distances"]["max_abs_err"] = max(
        report["bfs_distances"]["max_abs_err"], k1_err)

    out = {}
    k2_calls: list = []
    with recording_sampler(k2_calls):
        counts = path_launches(lambda: out.update(r=run()))
    require_launched(counts, ("bfs_distances", "sampler_tables", "sample_slots"),
                     "route_adaptive(dist=None)")
    want = {"bfs_distances": 1, "sampler_tables": 1, "sample_slots": 2,
            "ring_all_gather": 0}
    if counts != want:
        fail(f"route_adaptive: launches {counts}, want {want}")
    err = check_k2_calls(k2_calls, 2, "UGAL program")
    if k2_calls[0][1]["tables"] is not k2_calls[1][1]["tables"]:
        fail("UGAL program: the two segment launches did not share one set-up")
    dead = int((k2_calls[1][0][2] < 0).sum())
    log(f"UGAL program: segment 2 has {dead:,} dead flows of {DFLY_FLOWS:,}")
    for seg, (args, skw, _) in enumerate(k2_calls, 1):
        k2 = measure_k2(args, skw, f"UGAL segment {seg}", t.neigh)
        log(f"K2 UGAL segment {seg}: set-up + kernel {k2['ms']:.4f} ms, bound "
            f"{bound_ms(k2)[0]:.5f} ms ({bound_ms(k2)[1]}); set-up bound "
            f"{bound_ms(k2['setup'])[0]:.5f} ms")
    report["sample_slots"]["max_abs_err"] = max(report["sample_slots"]["max_abs_err"], err)
    del k2_calls

    inter, n1, n2, load = out["r"]
    again = run()
    if not all(torch.equal(a, b) for a, b in zip(out["r"], again)):
        fail("UGAL program: two calls on the same inputs differ")
    p_inter, s1, s2, p_load = run(packed=True)
    if not torch.equal(p_inter, inter) or not torch.equal(p_load, load):
        fail("UGAL program: packed and unpacked calls differ")
    inter_h, n1_h, n2_h = inter.cpu().numpy(), n1.cpu().numpy(), n2.cpu().numpy()
    d1, d2 = decode_segments(adj_h, p["src"], p["dst"], inter_h, s1.cpu().numpy(),
                             s2.cpu().numpy(), DFLY_MAX_LEN)
    if not (np.array_equal(d1, n1_h) and np.array_equal(d2, n2_h)):
        fail("UGAL program: decode_segments of the packed slots differs from the "
             "unpacked nodes")
    dist_h = dist.cpu().numpy()
    paths_a = check_segments(adj_h, dist_h, p["src"], p["dst"], inter_h, n1_h, n2_h,
                             "UGAL program")
    m_inter, m1, m2, _ = run(bias=1e9)
    m_inter = m_inter.cpu().numpy()
    if (m_inter != -1).any():
        fail(f"UGAL program: bias 1e9 detoured {int((m_inter >= 0).sum())} flows")
    paths_m = check_segments(adj_h, dist_h, p["src"], p["dst"], m_inter,
                             m1.cpu().numpy(), m2.cpu().numpy(), "forced-minimal")
    load_a = link_loads(paths_a, p["weight"], v).max()
    load_m = link_loads(paths_m, p["weight"], v).max()
    detours = float((inter_h >= 0).mean())
    if not 0.0 < detours < 1.0 or load_a <= 0:
        fail(f"UGAL program: detour share {detours}, max load {load_a}")
    ms = time_ms(run, reps=10, warm=1)
    ms_packed = time_ms(lambda: run(packed=True), reps=10, warm=1)
    wall, busy, rows = profile_device(lambda: run(packed=True))
    log_profile("UGAL program (packed)", wall, busy, rows, top=10)
    require_no_sort(rows, "UGAL program")
    log(f"UGAL program: {100 * detours:.2f}% of {DFLY_FLOWS:,} flows detoured; "
        f"discrete max link load adaptive {load_a:.0f}, forced-minimal "
        f"{load_m:.0f} ({load_m / load_a:.3f}x flatter); fractional max "
        f"{float(load.max()):.3f}; {ms:.3f} ms per call unpacked, "
        f"{ms_packed:.3f} ms packed (dist=None, CUDA events, median of 10); "
        f"device busy {busy:.3f} ms of a {wall:.3f} ms call "
        f"({100 * busy / wall:.1f}%)")
    return counts


def check_fdbs(db, pairs, fdbs, what: str) -> None:
    """Every fdb runs hop by hop over real links with their ports, from
    the source host's switch to the destination host's port."""
    for (a, b), fdb in zip(pairs, fdbs):
        if not fdb:
            fail(f"{what}: {a} -> {b} is unrouted")
        if fdb[0][0] != db.hosts[a].port.dpid or fdb[-1] != (
                db.hosts[b].port.dpid, db.hosts[b].port.port_no):
            fail(f"{what}: {a} -> {b} does not join its hosts: {fdb}")
        for (d1, p1), (d2, _) in zip(fdb, fdb[1:]):
            link = db.links.get(d1, {}).get(d2)
            if link is None or link.src.port_no != p1:
                fail(f"{what}: {a} -> {b} leaves {d1} by port {p1} toward {d2}")
    log(f"{what}: all {len(pairs):,} fdbs valid hop by hop")


def timed_calls(fn, n: int = 3) -> tuple:
    """``fn()`` once (the first call) and ``n`` more times: (last result,
    first ms, steady median ms, steady times)."""
    import torch

    times = []
    out = None
    for _ in range(n + 1):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times[0], statistics.median(times[1:]), times[1:]


def phase_pair_batches(device, report: dict) -> list:
    """The pair-batch entry points of ``TopologyDB(backend="torch")`` on
    config 5's fabric with its 10,000 flows as host pairs: the adaptive
    batch (the same links loaded, as a Monitor dict), the balanced batch
    on its DAG leg and, 64 pairs, on its greedy leg, the shortest batch
    on the device chase and, 100 pairs, on the host chase, and the
    split-phase window. Every fdb checked hop by hop, the shortest legs
    against ``find_route`` on 1,000 pairs, launch counts per call held,
    and every K2 call of the counted run (the adaptive batch's two
    segments, the DAG leg's one) recorded and held bit for bit, its
    set-up's tables included, against the plain versions. Returns the
    launch counts of each call."""
    p = dragonfly_problem(device)
    spec, t = p["spec"], p["t"]
    db = spec.to_topology_db(backend="torch", device=device)
    mac_of = {dpid: mac for mac, dpid, _ in spec.hosts}
    macs = [mac_of[int(d)] for d in t.dpids]
    pairs = [(macs[s], macs[d]) for s, d in zip(p["src"], p["dst"])]
    port = t.host_port()
    n_links = int((t.host_adj() > 0).sum())
    # bps whose normalized cost is the program's 8.0 flow units
    share = max(1.0, len(pairs) / n_links)
    bps = DFLY_UTIL * 10e9 / share
    link_util = {(int(t.dpids[i]), int(port[i, j])): bps
                 for i, j in zip(*np.nonzero(p["direct"]))}
    sample = np.random.default_rng(2).choice(len(pairs), 1000, replace=False)
    calls = [
        ("find_routes_batch_adaptive", lambda: db.find_routes_batch_adaptive(
            pairs, link_util=link_util, ugal_candidates=DFLY_CANDIDATES),
         {"bfs_distances": 0, "sampler_tables": 1, "sample_slots": 2}, pairs),
        ("find_routes_batch_balanced (DAG leg)", lambda: db.find_routes_batch_balanced(
            pairs, link_util=link_util),
         {"bfs_distances": 0, "sampler_tables": 1, "sample_slots": 1}, pairs),
        ("find_routes_batch_balanced (greedy leg, 64 pairs)",
         lambda: db.find_routes_batch_balanced(pairs[:64], link_util=link_util),
         {"bfs_distances": 0, "sampler_tables": 0, "sample_slots": 0}, pairs[:64]),
        ("find_routes_batch (device chase)", lambda: db.find_routes_batch(pairs),
         {"bfs_distances": 0, "sampler_tables": 0, "sample_slots": 0}, pairs),
        ("find_routes_batch (host chase, 100 pairs)",
         lambda: db.find_routes_batch(pairs[:100]),
         {"bfs_distances": 0, "sampler_tables": 0, "sample_slots": 0}, pairs[:100]),
        ("find_routes_batch_dispatch().reap()",
         lambda: db.find_routes_batch_dispatch(pairs).reap().fdbs(),
         {"bfs_distances": 0, "sampler_tables": 0, "sample_slots": 0}, pairs),
    ]
    all_counts = []
    for what, fn, want, these in calls:
        out, first, steady, times = timed_calls(fn)
        res = {}
        counts = checked_launches(lambda: res.update(r=fn()), what, report)
        if any(counts[k] != n for k, n in want.items()) or counts["ring_all_gather"]:
            fail(f"{what}: launches {counts}, want {want}")
        all_counts.append(counts)
        fdbs = out if isinstance(out, list) else out[0]
        if res["r"] != out:
            fail(f"{what}: two calls on the same inputs differ")
        check_fdbs(db, these, fdbs, what)
        extra = ""
        if what.startswith("find_routes_batch_adaptive"):
            extra = f"; {out[1]:,} pairs detoured, max congestion {out[2]}"
        elif what.startswith("find_routes_batch_balanced"):
            extra = f"; max congestion {out[1]}"
        else:
            for k in sample if len(these) == len(pairs) else range(len(these)):
                if fdbs[k] != db.find_route(*these[k]):
                    fail(f"{what}: pair {k} differs from find_route")
            extra = "; equal to find_route on the sampled pairs"
        log(f"{what}: {len(these):,} pairs, first call {first:.1f} ms, steady "
            f"{', '.join(f'{x:.1f}' for x in times)} ms (median {steady:.1f}); "
            f"launches {counts}{extra}")
    return all_counts


def phase_collective_policies(device, report: dict) -> list:
    """``find_routes_collective`` with the shortest and adaptive policies
    over config 4's fat-tree (k=28, V=1024) and its 4096-rank alltoall:
    every pair checked (``check_routes``; the fabric is idle, so UGAL
    keeps every route minimal), two calls identical, first and steady
    calls, the dispatch/reap split, launches shortest 0 / 0 / 0 and
    adaptive K1 0, set-up 1, K2 2, the adaptive policy's two K2 segment
    launches recorded and held bit for bit, their shared set-up's tables
    included, against the plain versions. Returns the launch counts of
    one call of each."""
    from sdnmpi_tpu_torch.collectives import alltoall_pairs
    from sdnmpi_tpu_torch.topogen import fattree

    spec = fattree(FATTREE_K)
    db = spec.to_topology_db(backend="torch", device=device, pad_multiple=V_PAD)
    macs = [m for m, _, _ in spec.hosts[:N_RANKS]]
    pairs = alltoall_pairs(len(macs))
    src_idx, dst_idx = pairs[:, 0], pairs[:, 1]
    del pairs
    wants = {
        "shortest": {"bfs_distances": 0, "sampler_tables": 0, "sample_slots": 0},
        "adaptive": {"bfs_distances": 0, "sampler_tables": 1, "sample_slots": 2},
    }
    all_counts = []
    for policy, want in wants.items():
        what = f"collective {policy}"

        def route():
            return db.find_routes_collective(macs, src_idx, dst_idx, policy=policy)

        routes, first, steady, times = timed_calls(route)
        res = {}
        counts = checked_launches(lambda: res.update(r=route()), what, report)
        if any(counts[k] != n for k, n in want.items()) or counts["ring_all_gather"]:
            fail(f"{what}: launches {counts}, want {want}")
        all_counts.append(counts)
        for field in ("pair_sub", "hop_dpid", "hop_port", "hop_len"):
            if not np.array_equal(getattr(res["r"], field), getattr(routes, field)):
                fail(f"{what}: two calls on the same inputs differ in {field}")
        log(f"{what}: {len(src_idx):,} pairs -> {routes.n_subflows:,} sub-flows; "
            f"first call {first:.1f} ms{' (includes refresh)' if policy == 'shortest' else ''}, "
            f"steady {', '.join(f'{x:.1f}' for x in times)} ms (median "
            f"{steady:.1f}); {routes.n_detours} detoured pairs; launches {counts}")
        log_split(what, db._oracle_engine(), db, macs, src_idx, dst_idx,
                  policy=policy)
        check_routes(what, spec, db, macs, src_idx, dst_idx, routes)
    return all_counts


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
            if "registers" in line or "spill" in line or "stack" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # phase 3: kernels against their plain versions
    t0 = time.perf_counter()
    p = build_problem(FATTREE_K, N_RANKS, V_PAD, device)
    log(f"problem: fattree-k{FATTREE_K} V={p['t'].v} diameter {p['levels']}, "
        f"{p['n_pairs']:,} rank pairs -> {p['src'].shape[0]:,} edge-pair "
        f"flows, T={p['dst_nodes'].shape[0]} "
        f"[{time.perf_counter() - t0:.1f} s]")
    report: dict = {}
    phase_bfs(device, report)
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

    # phases 10 to 12: the UGAL program, the pair batches, the collective
    # policies
    ugal_counts = phase_ugal_program(device, report)
    batch_counts = phase_pair_batches(device, report)
    policy_counts = phase_collective_policies(device, report)
    paths = (slice_counts, program_counts, entry_counts, shard_counts, ugal_counts,
             *batch_counts, *policy_counts)
    launches = {n: sum(c[n] for c in paths) for n in slice_counts}

    # phase 6: report
    meta = {
        "bfs_distances": ("csrc/bfs.cu", "sdnmpi_tpu/kernels/bfs.py:130"),
        # K2's set-up: the XLA prep inside sample_slots_pallas
        "sampler_tables": ("csrc/sampler.cu", "sdnmpi_tpu/kernels/sampler.py:270"),
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

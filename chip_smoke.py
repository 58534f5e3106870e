"""Drive sdnmpi_tpu_torch's collective path on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and builds the
package's kernels from ``sdnmpi_tpu_torch/kernels/csrc``. Phases, in
order; the first failure ends the run with a non-zero exit:

1. device   — a CUDA card is present; print its name and power limit.
2. build    — build kernels K1 (BFS) and K2 (path sampler), in parallel.
3. kernels  — hold each kernel against its plain PyTorch version on the
               card at the main path's shapes (K1 exactly, K2 bit for
               bit, in both sampler layouts); time both with CUDA events.
4. slice    — a 4096-rank alltoall over a k=28 fat-tree (980 switches,
               padded to V=1024) through TopologyDB.find_routes_collective;
               every routed pair is checked against the fabric.
5. program  — one route_collective call with no cached distances at the
               bench-config-4 shape (~86k aggregated edge-pair flows,
               rounds=2): K1 and K2 in one call.
6. report   — one JSON line of per-kernel numbers, then the result line.

Launch counts are zeroed just before one find_routes_collective call
(phase 4) and just before one route_collective call (phase 5), and read
just after each; a kernel of either path that did not launch in its
call fails the run. The sampler call of that find_routes_collective is
recorded and held bit for bit against the plain version on its own
arguments. Nothing here imports JAX or the JAX package.
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
PEAK_F32_S = 67e12


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
    ``oracle.dag`` makes while the context is open."""
    from sdnmpi_tpu_torch.kernels import sampler
    from sdnmpi_tpu_torch.oracle import dag

    def record(*args, **kw):
        out = sampler.sample_slots(*args, **kw)
        calls.append((args, kw, out))
        return out

    dag.sample_slots = record
    try:
        yield
    finally:
        dag.sample_slots = sampler.sample_slots


def path_launches(fn) -> dict:
    """Run ``fn()`` with every launch count zeroed just before it and
    return the counts just after."""
    import torch

    from sdnmpi_tpu_torch.kernels import bfs, sampler

    bfs.bfs_distances.launches = 0
    sampler.sample_slots.launches = 0
    fn()
    torch.cuda.synchronize()
    return {
        "bfs_distances": bfs.bfs_distances.launches,
        "sample_slots": sampler.sample_slots.launches,
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
    if len(k2_calls) != counts["sample_slots"]:
        fail(f"slice: {len(k2_calls)} sampler calls recorded for "
             f"{counts['sample_slots']} launches")
    args, kw, got = k2_calls[0]
    err = check_k2(args, kw, got, "slice (find_routes_collective)")
    report["sample_slots"] = {
        **measure_k2(args, kw, "slice"),
        "max_abs_err": max(err, report["sample_slots"]["max_abs_err"]),
    }
    del k2_calls, args, kw, got
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
    split = []
    for _ in range(3):
        t0 = time.perf_counter()
        window = oracle.routes_collective_dispatch(db, macs, src_idx, dst_idx)
        t1 = time.perf_counter()
        window.reap()
        split.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
    log(f"slice split (median of 3): dispatch "
        f"{statistics.median(d for d, _ in split):.1f} ms, reap "
        f"{statistics.median(r for _, r in split):.1f} ms")
    log_profile("slice", *profile_device(
        lambda: db.find_routes_collective(macs, src_idx, dst_idx)
    ))
    t = oracle.refresh(db)
    dist_h = oracle._dist
    # every pair routed, from its source's edge switch to its
    # destination's, over real links, shortest
    host_dpid = {m: d for m, d, _ in spec.hosts[:n_ranks]}
    edge_row = np.array([t.index[host_dpid[m]] for m in macs], np.int64)
    sub = routes.pair_sub
    if (sub < 0).any() or (routes.hop_len[sub] == 0).any():
        fail("slice: a pair is unrouted")
    row_of = np.full(int(t.dpids.max()) + 2, -1, np.int64)
    row_of[t.dpids] = np.arange(len(t.dpids))
    hop_rows = np.where(routes.hop_dpid >= 0, row_of[routes.hop_dpid], -1)
    length = routes.hop_len.astype(np.int64)
    first = hop_rows[:, 0]
    last = hop_rows[np.arange(len(length)), length - 1]
    s_edge = edge_row[src_idx]
    d_edge = edge_row[dst_idx]
    if (first[sub] != s_edge).any() or (last[sub] != d_edge).any():
        fail("slice: a route does not join its pair's edge switches")
    if (length[sub] != dist_h[s_edge, d_edge] + 1).any():
        fail("slice: a route is not a shortest path")
    a, b = hop_rows[:, :-1], hop_rows[:, 1:]
    hop = (a >= 0) & (b >= 0)
    port_h = t.host_port()
    if not (port_h[a[hop], b[hop]] >= 0).all():
        fail("slice: a route uses a link the fabric lacks")
    if not (routes.hop_port[:, :-1][hop] == port_h[a[hop], b[hop]]).all():
        fail("slice: a route's out-port is not its link's port")
    log(f"slice: all {len(pairs):,} pairs routed over shortest real paths; "
        f"max_congestion {routes.max_congestion}")
    return counts


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
    launches = {n: slice_counts[n] + program_counts[n] for n in slice_counts}

    # phase 6: report
    meta = {
        "bfs_distances": ("csrc/bfs.cu", "sdnmpi_tpu/kernels/bfs.py:130"),
        "sample_slots": ("csrc/sampler.cu", "sdnmpi_tpu/kernels/sampler.py:245"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = report[name]
        bytes_ms = r["bytes"] / PEAK_BYTES_S * 1e3
        ops_ms = r["ops"] / PEAK_F32_S * 1e3
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"sdnmpi_tpu_torch/kernels/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
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

"""Drive sdnmpi_tpu_torch's routing paths on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and builds the
package's kernels from ``sdnmpi_tpu_torch/kernels/csrc``. Phases, in
order; the first failure ends the run with a non-zero exit:

1. device   — a CUDA card is present; print its name and power limit.
2. build    — build kernels K1 (BFS), K2 (path sampler and its set-up),
               K3 (all-gather, and its step form), S1 (greedy scanner)
               and S2 (phase packer), one nvcc per source, in parallel.
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
               printed last, after phases 7 to 28.
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
               against find_route; the greedy leg's scanner call (S1,
               chunk 4096, the resident form) equal to its plain version
               and to the spread form.
12. collective policies — find_routes_collective(policy="shortest" and
               "adaptive") over phase 4's fat-tree and alltoall, every
               pair checked.
13. controller collective — config 4 through the Controller: the k=28
               fat-tree as a simulated fabric, 4096 ranks announced, one
               kickoff packet; the 16.7M-pair alltoall takes the block
               install (K2's set-up and K2 once each). Kickoff to
               EventCollectiveInstalled timed (first and steady), the
               install's max congestion against a direct
               find_routes_collective, its block paths shortest, 1,000
               seeded rank pairs delivered through the switch tables;
               then five Monitor passes with every plane at its default
               pacing, each plane's wall per pass timed, and steady
               installs with the flight recorder armed and disarmed.
14. controller packet-in — config 5 through the Controller with the
               route coalescer: 10,000 unicast packet-ins in windows
               (packet-in to FlowMods p50/p99), a 64-rank alltoall on
               the adaptive window install (K2's set-up once, K2 twice),
               then one loaded global link failed and revalidated.
15. launcher — config 4 through the command line, in this process
               (``sdnmpi_tpu_torch.launch.main``): ``--demo`` of the
               4096-rank alltoall on the k=28 fat-tree writing checkpoint
               A, ``--restore A --checkpoint B``, and the demo on the
               sharded oracle (``--shard-oracle --ring-exchange
               --mesh-devices 8``); the start -> demo-installed wall, the
               checkpoint's bytes and write and restore seconds; A and B
               agree, the sharded install's max congestion is the
               unsharded one's.
16. southbound — config 14's fabric over TCP: the 80 switches of a k=8
               fat-tree as scripted raw-byte OpenFlow 1.0 switches
               dialling the port's OFSouthbound, 128 ranks announced as
               UDP:61000 packet-in bytes, one 16,256-pair alltoall
               kickoff through the block install; every FlowMod checked
               on the switch its oracle route names.
17. serving  — config 14's shape through the command line (``--topo
               fattree:8 --wire --tenants 4 --offered-rate 400
               --duration 1.5``) with and without the route cache, in
               turns: routes/s and p50/p99/p999 per tenant, the cache's hit ==
               miss on one 256-pair window; then the port started twice
               as a child process with ``--warm-serving`` and one kernel
               build directory, empty (nvcc builds) and warm (loads).
18. churn    — config 8's shape: the k=28 fat-tree, its 85,556 installed
               edge pairs, 20 seeded flaps (10 cables removed and
               restored), each absorbed by the in-place repair and
               routes_batch_delta over the affected pairs; every flap's
               distances and next hops equal to a full refresh on the
               card, its window to routes_batch, touched to the host
               intersection; repair, re-score and flap -> converged
               timed beside one full refresh.
19. utilization plane — config 9's shape: one Monitor pass on every
               directed link of the k=28 fat-tree staged and flushed
               (timed), the device base equal to the host dict's bit for
               bit, config 4's balanced collective with the plane equal
               to the dict's, hot_links(8) equal to a numpy stable sort.
20. phased collectives — config 12's shape (k=16 fat-tree, 512-rank
               alltoall, 261,632 pairs), uncut: S2 (the dataflow
               packer) at 4,096 groups against its host twin and its
               plain version, 20 calls identical, its first step
               timed, clean under sync debug mode 'error', and held on
               a serial chain (K = 32), a gather, a mix of pads, zero
               weights and repeated pairs, K = 1, V = 3,968 (K = 16)
               and V = 65,536, each shape's longest chain logged beside
               its time; routes_collective_phased with auto K on the
               adaptive and the balanced policy (every sub-flow through S1 at chunk
               1; one phase of a 128-rank, two-pod program held against
               the plain scanner, both S1 forms timed and run under
               sync debug mode 'error', and so are S1 on an 80-slot
               neighbour table (the spread form), S1 on a directed
               chain of 300 switches whose hop counts do not narrow to
               uint8 (both forms); S1's
               form sweep on config 12's and config 5's tables; every
               phase's load equal to the load of its paths and both
               forms bit-equal on every phase, timed per step beside
               the SM clock),
               partitions and shortest real paths checked, walls and
               congestion over the flat fractional bound; then the
               512 ranks through the Controller with
               schedule_collectives on both policies, every FlowMod on
               its route's switch.
21. audit and traffic plane — config 16's shape (k=16 wire fat-tree,
               1,536 pairs): eight seeded table mutations, each confirmed
               once and healed within five audited passes, then one
               sentinel sweep of the whole installed population (its
               padded shadow batch: K2's set-up and K2 once, held against
               the plain versions); config 17's shape (k=8, 256 pairs, a
               1 Hz clock): the matrix bit-equal to a numpy fold of the
               staged deltas at alpha 1 and within four f32 units in the
               last place at 0.5, a published epoch unchanged by later
               flushes, the flush, audit and sentinel walls, and a
               cross-pod burst confirmed within 2 flush edges.
22. observability — config 14's serving shape through the command line
               with the SLO, flight, metrics, trace and profile dumps
               armed; the Monitor's flush edge published around the load;
               a bundle frozen and dumped, the incident's profile naming
               K2's kernel, every registered instrument in the Prometheus
               text, the Perfetto JSON with slices and counter tracks;
               then phase 17's serving run with the flight recorder
               armed and disarmed, in turns.
23. chaos and the pair — config 11's shape (k=8, 384 pairs): five
               crashes of the busiest switches redriven (timed), then a
               seeded fault plan quiesced to installed == desired; config
               18's shape (a pair over k=8, 256 pairs): 20 storm rounds
               (replication lag) and a killed controller's failover
               (reconverge wall). Both on the card's oracle.
24. hier     — config 15 through the hierarchical oracle
               (TopologyDB(hier_oracle=True, mesh_devices=8,
               ring_exchange=True)): fattree(64, pods=1008), 65,536
               switches, 128 ranks strided over the hosts, 16,256 pairs
               through find_routes_collective(policy="shortest"); the DB
               build, cold refresh, first route and median of 3 steady
               routes timed, every pair routed over live links, K3's
               border plane equal to its plain version and the host
               slice, the per-shard device bytes at least 8x under the
               dense [V, V] f32 plane; warm_serving, the route after it,
               the scalar escape hatch and a border snapshot restored
               into a fresh oracle, their fdbs equal, 16 border rows of
               the card equal to sweep_rows_host; one intra-pod and one
               inter-pod flap (block repairs and level-2 refreshes as the
               reference counts them, routes equal to a cold rebuild's,
               then the original routes back); the refresh twin at k=56
               (the dense sharded refresh beside the full hier build,
               hier lengths equal to the dense oracle's over a 256-rank
               alltoall, the mesh equal to one device); a k=8 Controller
               block install under hier_oracle (flows as the dense
               controller's, every block path shortest, 200 pairs
               delivered) and the launcher's --hier-oracle --demo; the
               three device programs timed with CUDA events.
25. sharded legs — config 13 (fattree(56), V = 3,968, 8 shards of this
               card) on the legs that ROADMAP A1 ported: (a) an 8,192-pair
               unicast window through find_routes_batch_dispatch on the
               shard_oracle, ring on and off (batch_fdb_ringed and
               batch_fdb_sharded), and the narrowed re-route
               (find_routes_batch_delta_dispatch) of one flapped link,
               every fdb valid hop by hop and equal to a single-device
               TopologyDB's, K3 timed on the int16 next-hop wire and the
               int32 rows; (b) warm_serving of the sharded chase; (c)
               find_routes_collective(policy="shortest") at 8192 ranks
               through the next hops gathered once per refresh; (d)
               config 5's find_routes_batch_adaptive with mesh_devices=8
               and config 13's find_routes_collective(policy="adaptive"),
               both equal to one device, K2 timed at a shard's UGAL
               segment; (e) route_flows_sharded and multichip_route_step
               on config 13's alltoall (S1 once per shard, one shard's
               call, the spread form, equal to the plain scanner, run
               under sync debug mode 'error' and timed), every path
               shortest and the summed load equal to link_loads of the
               paths.
26. overlapped exchange — config 13 (fattree(56), V = 3,968, 8 shards of
               this card) on the three ring consumers that wait for each
               step of K3's step form on the exchange stream: (a) every
               step of the step kernel exactly against its plain version
               (s = 3 and 8, bf16, int16 and int32 wires, uneven and full
               width), timed per step beside its bound, Tensor.copy_ and
               torch._foreach_copy_; (b) the gated chase of an 8,192-pair
               window, the refresh's column-pipelined next-hop argmin and
               the DAG step, each bit-equal to its gather twin and to one
               device over 20 calls of a poisoned exchange delayed by
               torch.cuda._sleep before each step; (c) the exchange's
               events: a step's start precedes the end of the consumer
               work enqueued before its wait; (d) each consumer's
               overlapped wall, its serial equivalent (the exchange alone
               plus the consumer on landed data) and their ratio, the
               refresh leg's set as shard_exchange_overlap_gain and
               shard_exchange_seconds observed; (e) the step kernel's CTA
               sweep and the consumers' walls over CTA counts and stream
               priorities; (f) the ring consumers under sync debug mode
               'warn', every sync reported; (g) the ring re-route's first
               call after a refresh split into host (cProfile) and device
               (profiler) time, beside the host distance twin's download.
27. processes — config 13 uncut on a mesh over two processes of this
               card (``make_multihost_mesh``: 2 x 4 shards, a gloo group
               over localhost, both processes spawned): each holds K3
               and its step form, storing through CUDA IPC pointers into
               the other process's buffers, against their plain versions
               (int32, int16, f32 and bf16 rows of ``[496, 3968]``, the
               views poisoned) and times both per call beside the same
               call in one process (the host's enqueue apart; two
               processes time-sliced on one card, not an NVLink time);
               each holds the psum of the greedy balancer and the UGAL
               program (eight [3968, 3968] f32 and f64 parts, the f64 as
               int32 pairs, every process's parts stored once into each
               process by K3) against the plain version and the
               shard-order sum, timed beside the same sum in one process;
               then the refresh in ring and gather modes, an 8,192-pair
               window in each mode, route_collective_sharded in each
               mode, route_flows_sharded and multichip_route_step on the
               edge flows (S1 per local shard, the same form in both
               processes), find_routes_batch_adaptive on the window's
               pairs (the sharded UGAL program) and the mesh-only refresh
               of a TopologyDB without shard_oracle, every host result
               bit-equal to this process's single-process run of the
               same path.
28. hier processes — config 15 uncut through the hierarchical oracle on
               a mesh over two processes of this card (2 x 4 shards, the
               ring on, both processes spawned, each building the
               TopologyDB): the cold refresh (each process's pod blocks,
               the host stacks gathered, the border plane over K3), the
               first and a steady route (each process sweeping its own
               rows, K3 replicating the plane), one intra-pod flap's
               repair and the route after it, every digest equal to phase
               24's single-process result.

Launch counts are zeroed just before one call of each path and read just
after it: find_routes_collective (phase 4), route_collective(dist=None)
(phase 5), one steady sharded find_routes_collective and one sharded
refresh (phase 8: the ring exchange's step form at least once in each),
one route_collective_sharded call per mode (phase 9: the step form in
ring mode, K3 in gather mode),
route_adaptive(dist=None) (phase 10, exactly K1 1, set-up 1, K2 2), each
pair-batch entry point (phase 11; the greedy leg S1 once, the others no
S1), each collective policy (phase 12),
one controller block install (phase 13, K1 0, set-up 1, K2 1), and the
packet-in burst, the adaptive window install (K1 0, set-up 1, K2 2) and
the link failure of phase 14, each launcher run of phase 15 (demo and
restore: K1 0, set-up 1, K2 1; sharded demo: set-up 1, K2 8, K3 or its
step form at least once), the TCP block install of phase 16 (K1 0, set-up 1, K2 1) and
each serving run of phase 17, the flap storm of phase 18 (nothing: the
shortest leg runs no kernel), the collective with the utilization plane
of phase 19 (K1 0, set-up 1, K2 1), and the flat batches, the phased
programs (S2 once each; adaptive: set-up 1 and K2 2 per phase; balanced:
S1 once per phase) and the phased Controller installs of phase 20, the
Monitor passes of phase
13 and the audited passes of phase 21 (no K1, no K3; the sentinel's
default sample of 64 pairs takes the greedy scanner), phase 21's
whole-population sentinel sweep (K1 0, set-up 1, K2 1), the launcher run
of phase 22 (K1 0, set-up 2, K2 2: the demo's install and its
re-install), phase 23's crashes, storm and failover and every leg of
phase 24 (K1 and K2 0; K3 at least 1 on each hier refresh with the
ring, the step form at least once on the dense sharded refresh), and
phase 27's path in each of its two processes (K3, its step form, K2's
set-up, K2 and S1 at least once each; their counts are added to the
report's), phase 28's in each of its two (K3 at least once, no K1 and
no K2; added too), and
phase 25's legs (each window and narrowed re-route: in ring mode 5
launches of K3's step form, in gather mode K3 1, nothing else;
warm_serving: the same per warmed bucket; the shortest collective: K3
1 on its first call after a refresh, 0 after; each UGAL leg: set-up 1,
K2 2 per shard, no K1, no K3; the library legs: S1 once per shard,
nothing else), against the
counts each path must launch.
A kernel of a path that did not launch in its call fails the run. The
wall of every phase is logged after it, and all phases' wall before the
report. The
sampler call of phase 4 is recorded and held bit for bit against the
plain version on its own arguments, and so are both of phase 10's and
every shard's sampler call
(with its ``fid_base``) of the steady sharded call, of every launcher
run and of the TCP block install and of each
route_collective_sharded call, and the tables its set-up kernels
(``sampler_tables``) built for it against the plain set-up. The set-up
has a launch count of its own: every call must launch it once for its
one device, however many shards sample, and the profiles of the entry
points and the programs must show no sort kernel. Every K3 launch of
phase 25 is recorded and held against the plain version on its own
blocks. S1 and S2 count in every path's launches as K1-K3 do (none on
the paths not named above). Nothing here imports JAX or the JAX
package.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import logging
import math
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
#: rank pairs phase 13 delivers through the switch tables, and the ranks
#: of phase 14's adaptive window install (4,032 pairs, below
#: Config.block_install_threshold)
CTL_DELIVER = 1000
CTL_WINDOW_RANKS = 64
#: where phases 15-17 write checkpoints and the warm-start kernel
#: directory (inside the checkout, git-ignored; removed again)
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke_out")
#: config 14's cache-fence window (benchmarks/config14_serving.py)
CACHE_WINDOW = 256
#: phase 18: config 8's storm (benchmarks/config8_churn.py runs 100 flaps)
CHURN_FLAPS = 20
#: phase 20: config 12's shape (benchmarks/config12_schedule.py:42-43), a
#: k=16 fat-tree and a 512-rank alltoall (261,632 pairs), uncut: the
#: direct programs and the Controller's phased installs (the balanced one
#: is what --schedule-phases runs by default) at all 512 ranks, the
#: balanced phases' sub-flows scanned by kernel S1 one at a time. The
#: plain scanner (a loop of ~40 torch ops a hop, about 4 ms a row at
#: max_len 5) holds one phase of a 128-rank program, ~4,000 sub-flows:
#: two pods, so cross-pod paths of 4 hops choose among the core uplinks
#: (the first 64 ranks are one pod, where every path stays below the
#: cores); a 512-rank phase (~65,000 rows) would take minutes
SCHED_K = 16
SCHED_RANKS = 512
SCHED_HOLD_RANKS = 128
#: S2 held at config 13's V and K = 16 (phase 20's program has K = 4),
#: seeded rows
PACK_WIDE_V = 3968
PACK_WIDE_K = 16
#: S2's other holds: 4,096 rows each (config 12's count); the serial case
#: (one source and one destination: a chain of every row) at K = 32, and a
#: V whose turnstiles (4 V bytes) do not fit in shared memory
PACK_HOLD_ROWS = 4096
PACK_HUGE_V = 65_536
#: S2 at config 12 is called this many times: every result identical
PACK_REPEATS = 20
#: the H100's SM clock under load (MHz; clocks.sm read 1,980 in every
#: reading of S1's runs), for S2's chain floor
H100_SM_MHZ = 1980
#: S1 held on a neighbour table wider than 64 slots (random_regular(256,
#: 80), diameter 2: ~25 equal-cost middles a pair across three 32-slot
#: groups), 4,096 seeded weight-1 flows in chunks of 256
SCAN_WIDE = (256, 80)
SCAN_WIDE_FLOWS = 4096
SCAN_WIDE_CHUNK = 256
#: S1 held where its hop counts do not narrow to uint8: a directed chain
#: of 300 switches (diameter 299 > 254), flows end to end
SCAN_CHAIN_V = 300
#: S1's form sweep: seeded weight-1 flows timed in both forms at each
#: chunk width, on config 12's and config 5's tables
SCAN_SWEEP_ROWS = 4096
SCAN_SWEEP_WIDTHS = (1, 8, 32, 64, 128, 256, 512)
#: a floor for one dependent step, for the log beside a chain's time: S1's
#: resident hop step waits at least for its neighbour read and then its
#: hop-count read from shared memory, some 32 cycles each on Hopper, and
#: an S2 row at least for its turnstile's read and its in column's (an
#: estimate stated here, not measured; a floor, not a bound)
STEP_FLOOR_CYCLES = 64
#: the profiler's kernel names of S1's two forms
S1_KERNELS = {"resident": "scan_resident", "spread": "spread"}


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


@contextlib.contextmanager
def recording_scanner(calls: list):
    """Record ``(args, kwargs, result)`` of every greedy scanner call
    (kernel S1) that ``oracle.engine`` (the balanced pair batch and the
    phase-grain leg) and ``shardplane.routes`` (one call per shard) make
    while the context is open."""
    from sdnmpi_tpu_torch.oracle import congestion, engine
    from sdnmpi_tpu_torch.shardplane import routes

    def record(*args, **kw):
        out = congestion.route_flows_balanced(*args, **kw)
        calls.append((args, kw, out))
        return out

    engine.route_flows_balanced = routes.route_flows_balanced = record
    try:
        yield
    finally:
        engine.route_flows_balanced = congestion.route_flows_balanced
        routes.route_flows_balanced = congestion.route_flows_balanced


def check_scan(args: tuple, kw: dict, got, what: str) -> float:
    """One kernel S1 call held against ``route_flows_balanced_plain`` on
    its own arguments on the card: nodes, load and max exactly equal.
    Returns the plain version's wall in ms."""
    import torch

    from sdnmpi_tpu_torch.oracle.congestion import route_flows_balanced_plain

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = route_flows_balanced_plain(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for name, g, w in zip(("nodes", "load", "max"), got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            fail(f"S1 {what}: {name} differs from route_flows_balanced_plain")
    log(f"S1 {what}: nodes {tuple(got[0].shape)}, load and max equal to the "
        f"plain version (plain {plain_ms:.1f} ms on the card)")
    return plain_ms


def scan_work(args: tuple, kw: dict, got) -> dict:
    """What one scanner call's data needs: its live flows, the moves
    (flow hops that placed load: a row's hops, and one more where
    ``max_len`` cut it short of its destination), the dependent hop
    steps the kernel runs in order (per chunk, its longest walk in
    moves), and the bytes and operations of its bound: the flow rows read
    and the node rows and the [V, V] f32 load written once, a neighbour
    row and each slot's distance, base and load read per move."""
    nodes = got[0].cpu().numpy()
    u, max_len = nodes.shape
    chunk = kw.get("chunk", 4096)
    v = args[0].shape[0]
    d = kw["neigh"].shape[1]
    dst = args[4].cpu().numpy()
    n = (nodes >= 0).sum(axis=1)
    last = nodes[np.arange(u), np.maximum(n - 1, 0)]
    per_row = np.where(n > 0, n - 1 + ((n == max_len) & (last != dst)), 0)
    live = int((args[3].cpu().numpy() >= 0).sum())
    moves = int(per_row.sum())
    n_chunks = -(-u // chunk)
    per_chunk = np.zeros(n_chunks * chunk, np.int64)
    per_chunk[:u] = per_row
    steps = int(per_chunk.reshape(n_chunks, chunk).max(axis=1).sum())
    n_bytes = u * 12 + u * max_len * 4 + v * v * 4 + moves * d * 16
    return {"flows": live, "moves": moves, "steps": steps, "bytes": n_bytes,
            "ops": moves * d * 4}


def scan_form_of(args: tuple, kw: dict) -> str:
    """The form kernel S1's rule gives one scanner call."""
    from sdnmpi_tpu_torch.oracle.congestion import scan_form

    return scan_form(args[0].shape[0], kw["neigh"].shape[1], kw.get("chunk", 4096),
                     args[3].shape[0])


def resident_takes(args: tuple, kw: dict) -> bool:
    """Whether S1's resident form takes a call: its tables fit and few
    enough flows pick together."""
    from sdnmpi_tpu_torch.oracle import congestion

    v, d = args[0].shape[0], kw["neigh"].shape[1]
    return (congestion.resident_bytes(v, d) <= congestion.RESIDENT_SMEM_BYTES
            and min(kw.get("chunk", 4096), args[3].shape[0])
            <= congestion.RESIDENT_THREADS)


def same_scan(a, b) -> bool:
    """Nodes, load and max of two scanner results equal bit for bit."""
    import torch

    return all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))


def hold_scan_forms(args: tuple, kw: dict, got, what: str, want: str) -> None:
    """``got``, one scanner call in the rule's form, which must be
    ``want``; the other form, forced on the same arguments where it takes
    them, must equal it bit for bit."""
    from sdnmpi_tpu_torch.oracle.congestion import resident_bytes, route_flows_balanced

    form = scan_form_of(args, kw)
    if form != want:
        fail(f"S1 {what}: the rule gives the {form} form, not the {want} form")
    other = "spread" if form == "resident" else "resident"
    if other == "resident" and not resident_takes(args, kw):
        log(f"S1 {what}: {form} form (the rule's); the resident form does not take "
            f"it ({resident_bytes(args[0].shape[0], kw['neigh'].shape[1]):,} bytes "
            "of tables)")
        return
    if not same_scan(route_flows_balanced(*args, **kw, _form=other), got):
        fail(f"S1 {what}: the {other} form differs from the {form} form")
    log(f"S1 {what}: {form} form (the rule's), the {other} form equal bit for bit")


def without_sync(fn, what: str):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: a call
    that waits for the card fails the run."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    except RuntimeError as e:
        fail(f"{what} synchronised with the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"{what}: no host synchronisation (sync debug mode 'error')")
    return out


@contextlib.contextmanager
def sm_clocks(samples: list):
    """Sample the card's SM clock (MHz) every 100 ms with nvidia-smi
    while the context is open; the readings go to ``samples``."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
        for word in out.split():
            try:
                samples.append(float(word))
            except ValueError:
                pass


def per_step(ms: float, steps: int, mhz: float) -> str:
    """A scanner time per dependent step, in ns and SM cycles."""
    ns = ms * 1e6 / max(1, steps)
    return f"{ns:.1f} ns = {ns * mhz / 1e3:.0f} cycles a step"


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


def checked_launches(fn, what: str, report: dict, installs: int = 1) -> dict:
    """:func:`path_launches` of ``fn()`` with every K2 call recorded and
    held, its set-up's tables included, against the plain versions
    (:func:`check_k2_calls`, folded into ``report``); two launches in one
    call (UGAL's segments) must share one set-up, unless ``fn`` runs
    ``installs`` separate installs, one set-up each."""
    k2_calls: list = []
    with recording_sampler(k2_calls):
        counts = path_launches(fn)
    report["sample_slots"]["max_abs_err"] = max(
        report["sample_slots"]["max_abs_err"],
        check_k2_calls(k2_calls, counts["sample_slots"], what))
    if (installs == 1 and len(k2_calls) == 2
            and k2_calls[0][1]["tables"] is not k2_calls[1][1]["tables"]):
        fail(f"{what}: the two segment launches did not share one set-up")
    return counts


def counted_wrappers() -> dict:
    """Every kernel wrapper by its name in the report, each with its
    launch count."""
    from sdnmpi_tpu_torch.kernels import bfs, ring, sampler
    from sdnmpi_tpu_torch.oracle import congestion
    from sdnmpi_tpu_torch.sched import phases

    return {
        "bfs_distances": bfs.bfs_distances,
        "sampler_tables": sampler.sampler_tables,
        "sample_slots": sampler.sample_slots,
        "ring_all_gather": ring.ring_all_gather,
        "ring_step": ring.ring_step,
        "route_flows_balanced": congestion.route_flows_balanced,
        "pack_greedy": phases._pack_greedy_device,
    }


def zero_launches() -> None:
    for fn in counted_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in counted_wrappers().items()}


def path_launches(fn) -> dict:
    """Run ``fn()`` with every launch count zeroed just before it and
    return the counts just after."""
    import torch

    zero_launches()
    fn()
    torch.cuda.synchronize()
    return read_launches()


def launches_of(k1=0, setup=0, k2=0, k3=0, step=0, scan=0, pack=0) -> dict:
    """The launch counts a path must make: K1, K2's set-up, K2, K3, K3's
    step form, the scanner S1 and the packer S2."""
    return {"bfs_distances": k1, "sampler_tables": setup, "sample_slots": k2,
            "ring_all_gather": k3, "ring_step": step, "route_flows_balanced": scan,
            "pack_greedy": pack}


def ring_steps(n_shards: int = N_SHARDS) -> int:
    """Step launches of one streamed exchange over ``n_shards``."""
    from sdnmpi_tpu_torch.kernels.ring import ring_legs

    return max(ring_legs(n_shards)) + 1


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
    # dist=None on the card runs K1 once for `levels` steps, as the
    # reference's Pallas path does (the CPU computes exact distances)
    if counts["bfs_distances"] != 1:
        fail(f"program: dist=None launched K1 {counts['bfs_distances']} times")
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
    # the ring branch's distance exchange: K3's step form
    require_launched(counts, ("sampler_tables", "sample_slots", "ring_step"),
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
    require_launched(refresh, ("ring_step",), "sharded refresh")
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


def shard_problem(device, k: int = SHARD_K, n_ranks: int = SHARD_RANKS) -> dict:
    """Config 13's primary problem: alltoall of 8192 ranks on fat-tree
    k=56 aggregated to edge-switch flows (as benchmarks/common's
    alltoall_problem builds it), end-padded to the shard count; an idle
    fabric."""
    from sdnmpi_tpu_torch.oracle.apsp import apsp_distances
    from sdnmpi_tpu_torch.oracle.engine import tensorize
    from sdnmpi_tpu_torch.topogen import fattree

    spec = fattree(k)
    db = spec.to_topology_db(backend="torch", device=device, pad_multiple=SHARD_PAD)
    t = tensorize(db, pad_multiple=SHARD_PAD, device=device)
    dist = apsp_distances(t.adj)
    dist_h = dist.cpu().numpy()
    levels = int(dist_h[np.isfinite(dist_h)].max())
    return dict(edge_flows(spec, t, n_ranks, device), dist=dist, dist_h=dist_h,
                levels=levels)


def edge_flows(spec, t, n_ranks: int, device) -> dict:
    """The alltoall of ``spec``'s first ``n_ranks`` hosts aggregated to
    edge-switch flows (as benchmarks/common's alltoall_problem builds
    it), end-padded to the shard count, on an idle fabric: the
    arguments of ``route_collective_sharded`` before the mesh, the
    destination set and the flows on the host."""
    import torch

    from sdnmpi_tpu_torch.oracle.dag import make_dst_nodes

    host_edge = np.array(
        [t.index[d] for _, d, _ in spec.hosts[:n_ranks]], np.int32
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
    weight = np.concatenate([weight, np.zeros(pad, np.float32)])
    live = usrc >= 0
    v = t.v
    traffic = np.zeros((v, v), np.float32)
    np.add.at(traffic, (udst[live], usrc[live]), weight[live])
    li, lj = (a.astype(np.int32) for a in np.nonzero(t.host_adj() > 0))
    put = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    return {
        "t": t,
        "args": [t.adj, put(li), put(lj), put(np.zeros(len(li), np.float32)),
                 put(traffic), put(usrc), put(udst)],
        "dst_nodes": put(make_dst_nodes(udst[live])), "src": usrc, "dst": udst,
        "weight": weight,
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
        require_launched(got, ("sampler_tables", "sample_slots",
                               "ring_step" if ring_mode else "ring_all_gather"),
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
    want = launches_of(k1=1, setup=1, k2=2)
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
    set-up's tables included, against the plain versions; the greedy
    leg's scanner call (kernel S1, chunk 4096) held against its plain
    version exactly. Returns the launch counts of each call."""
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
         launches_of(setup=1, k2=2), pairs),
        ("find_routes_batch_balanced (DAG leg)", lambda: db.find_routes_batch_balanced(
            pairs, link_util=link_util),
         launches_of(setup=1, k2=1), pairs),
        ("find_routes_batch_balanced (greedy leg, 64 pairs)",
         lambda: db.find_routes_batch_balanced(pairs[:64], link_util=link_util),
         launches_of(scan=1), pairs[:64]),
        ("find_routes_batch (device chase)", lambda: db.find_routes_batch(pairs),
         launches_of(), pairs),
        ("find_routes_batch (host chase, 100 pairs)",
         lambda: db.find_routes_batch(pairs[:100]),
         launches_of(), pairs[:100]),
        ("find_routes_batch_dispatch().reap()",
         lambda: db.find_routes_batch_dispatch(pairs).reap().fdbs(),
         launches_of(), pairs),
    ]
    all_counts = []
    for what, fn, want, these in calls:
        out, first, steady, times = timed_calls(fn)
        res = {}
        scans: list = []
        with recording_scanner(scans):
            counts = checked_launches(lambda: res.update(r=fn()), what, report)
        if counts != want:
            fail(f"{what}: launches {counts}, want {want}")
        for args, kw, got in scans:
            check_scan(args, kw, got, f"config 5 {what}, chunk {kw['chunk']}")
            hold_scan_forms(args, kw, got, f"config 5 {what}", "resident")
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
        "shortest": launches_of(),
        "adaptive": launches_of(setup=1, k2=2),
    }
    all_counts = []
    for policy, want in wants.items():
        what = f"collective {policy}"

        def route():
            return db.find_routes_collective(macs, src_idx, dst_idx, policy=policy)

        routes, first, steady, times = timed_calls(route)
        res = {}
        counts = checked_launches(lambda: res.update(r=route()), what, report)
        if counts != want:
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


# -- phases 13 and 14: the controller, from packet-in to FlowMods ---------


def controller_stack(spec, device, **config_kw):
    """The port's controller over ``spec``'s simulated fabric on
    ``device``, every plane at the port's defaults, and the list its
    EventCollectiveInstalled events land in, each with its time."""
    from sdnmpi_tpu_torch import Config, Controller
    from sdnmpi_tpu_torch.control import events as ev

    fabric = spec.to_fabric()
    ctl = Controller(fabric, Config(oracle_backend="torch", device=str(device),
                                    **config_kw))
    ctl.attach()
    installed: list = []
    ctl.bus.subscribe(ev.EventCollectiveInstalled,
                      lambda e: installed.append((time.perf_counter(), e)))
    return fabric, ctl, installed


def launch_ranks(fabric, macs: list) -> None:
    """Rank i announces itself from ``macs[i]`` (one LAUNCH each)."""
    from sdnmpi_tpu_torch.protocol import openflow as of
    from sdnmpi_tpu_torch.protocol.announcement import Announcement, AnnouncementType

    for rank, mac in enumerate(macs):
        fabric.hosts[mac].send(of.Packet(
            eth_src=mac, eth_dst="ff:ff:ff:ff:ff:ff", eth_type=of.ETH_TYPE_IP,
            ip_proto=of.IPPROTO_UDP, udp_dst=61000,
            payload=Announcement(AnnouncementType.LAUNCH, rank).encode(),
        ))


def send_mpi(fabric, macs: list, s: int, d: int) -> None:
    """One alltoall packet from rank ``s`` to rank ``d``'s virtual MAC."""
    from sdnmpi_tpu_torch.protocol import openflow as of
    from sdnmpi_tpu_torch.protocol.vmac import CollectiveType, VirtualMac

    vmac = VirtualMac(CollectiveType.ALLTOALL, s, d).encode()
    fabric.hosts[macs[s]].send(
        of.Packet(eth_src=macs[s], eth_dst=vmac, eth_type=of.ETH_TYPE_IP))


def timed_handler(ctl, request_type, walls: list) -> None:
    """Time every call of the bus handler of ``request_type``."""
    handler = ctl.bus._request_handlers[request_type]

    def timed(req):
        t0 = time.perf_counter()
        try:
            return handler(req)
        finally:
            walls.append((time.perf_counter() - t0) * 1e3)

    ctl.bus._request_handlers[request_type] = timed


def deliver_pairs(fabric, macs: list, pairs, what: str) -> int:
    """Send one packet per rank pair through the installed switch tables;
    each must reach its destination host with the virtual destination
    MAC rewritten to the host's own."""
    for s, d in pairs:
        inbox = fabric.hosts[macs[d]].received
        before = len(inbox)
        send_mpi(fabric, macs, int(s), int(d))
        if len(inbox) != before + 1 or inbox[-1].eth_dst != macs[d]:
            fail(f"{what}: rank {s} -> {d} was not delivered with the MAC "
                 "rewrite")
    return len(pairs)


#: the planes a Monitor pass (EventStatsFlush) drives, in the order the
#: Controller subscribes them: (attribute of the controller, its method)
PLANE_STEPS = (("audit", "sweep"), ("traffic", "flush"), ("sentinel", "sweep"),
               ("flight", "snapshot_tick"), ("timeline", "tick"))


@contextlib.contextmanager
def timed_planes(ctl, walls: dict):
    """Time every call of each plane's per-pass method (ms, appended to
    ``walls[attr]``) while the context is open."""
    patched = []
    for attr, meth in PLANE_STEPS:
        obj = getattr(ctl, attr)
        if obj is None:
            fail(f"the controller has no {attr} plane")
        inner = getattr(obj, meth)

        def timed(*a, _inner=inner, _attr=attr, **kw):
            t0 = time.perf_counter()
            try:
                return _inner(*a, **kw)
            finally:
                walls.setdefault(_attr, []).append((time.perf_counter() - t0) * 1e3)

        setattr(obj, meth, timed)
        patched.append((obj, meth))
    try:
        yield walls
    finally:
        for obj, meth in patched:
            delattr(obj, meth)


def monitor_passes(ctl, n: int, what: str, report: dict, before=None) -> tuple:
    """Publish ``n`` EventStatsFlush edges (one Monitor pass each, after
    ``before()`` when given), each plane's wall per pass timed. Returns
    (pass walls ms, plane walls ms, the launch counts of the passes)."""
    import torch

    from sdnmpi_tpu_torch.control import events as ev

    walls: list = []
    planes: dict = {}

    def run():
        for _ in range(n):
            if before is not None:
                before()
            t0 = time.perf_counter()
            ctl.bus.publish(ev.EventStatsFlush())
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)

    with timed_planes(ctl, planes):
        counts = checked_launches(run, what, report)
    log(f"{what}: {n} Monitor passes, wall per pass {tail(walls)}; per plane: "
        + "; ".join(f"{a} {tail(planes[a]) if planes.get(a) else 'not run'}"
                    for a, _ in PLANE_STEPS)
        + f"; launches {counts}")
    return walls, planes, counts


def phase_controller_collective(device, report: dict) -> list:
    """Config 4 through the controller: ``fattree(28).to_fabric()``
    (980 switches, 5,488 hosts), 4096 ranks announced (rank i on host i),
    one kickoff packet to ``VirtualMac(ALLTOALL, 0, 1)``; its 16,773,120
    pairs take the block install with the balanced policy. Reports the
    time from the kickoff packet-in to EventCollectiveInstalled, the
    first install (refresh included) and three steady re-installs, the
    router's share apart from the oracle call and the device's busy
    share. Holds launches K1 0, set-up 1, K2 1 per install, the K2 call
    and its tables against the plain versions, the install's pair count,
    its max congestion against a direct ``find_routes_collective`` of
    the same arguments, and 1,000 seeded rank pairs delivered through
    the switch tables on shortest paths; then steady installs with the
    flight recorder armed and disarmed in turns, and five Monitor passes
    with every plane at its default pacing (each plane's wall per pass).
    Returns the launch counts of one install and of the passes."""
    import torch

    from sdnmpi_tpu_torch.control import events as ev
    from sdnmpi_tpu_torch.topogen import fattree

    spec = fattree(FATTREE_K)
    t0 = time.perf_counter()
    fabric, ctl, installed = controller_stack(spec, device)
    macs = [m for m, _, _ in spec.hosts[:N_RANKS]]
    launch_ranks(fabric, macs)
    log(f"controller collective: fat-tree k={FATTREE_K}, {len(fabric.switches)} "
        f"switches, {len(fabric.hosts):,} hosts, {N_RANKS} ranks announced "
        f"[{time.perf_counter() - t0:.1f} s]")
    oracle_ms: list = []
    timed_handler(ctl, ev.FindCollectiveRoutesRequest, oracle_ms)
    router = ctl.router

    def kickoff(s: int, d: int) -> float:
        n0 = len(installed)
        t_send = time.perf_counter()
        send_mpi(fabric, macs, s, d)
        torch.cuda.synchronize()
        if len(installed) != n0 + 1:
            fail(f"controller collective: kickoff {s} -> {d} installed "
                 f"{len(installed) - n0} collectives")
        return (installed[-1][0] - t_send) * 1e3

    out: dict = {}
    counts = checked_launches(lambda: out.update(first=kickoff(0, 1)),
                              "controller collective (block install)", report)
    want = launches_of(setup=1, k2=1)
    if counts != want:
        fail(f"controller collective: launches {counts}, want {want}")
    install = next(iter(router.collectives))
    n_pairs = N_RANKS * (N_RANKS - 1)
    if install.n_pairs != n_pairs:
        fail(f"controller collective: {install.n_pairs:,} pairs installed, "
             f"want {n_pairs:,}")
    first, first_oracle = out["first"], oracle_ms[-1]
    steady, steady_oracle = [], []
    from sdnmpi_tpu_torch.utils.metrics import REGISTRY

    hits0 = REGISTRY.get("route_cache_hits_total").value
    for s in (2, 4, 6):
        router._remove_collective(next(iter(router.collectives)))
        steady.append(kickoff(s, s + 1))
        steady_oracle.append(oracle_ms[-1])
    router._remove_collective(next(iter(router.collectives)))
    wall, busy, rows = profile_device(lambda: kickoff(8, 9))
    log_profile("controller collective (steady install)", wall, busy, rows)
    router._remove_collective(next(iter(router.collectives)))
    log_host_profile("controller collective (steady install)",
                     lambda: kickoff(10, 11))
    med, med_oracle = statistics.median(steady), statistics.median(steady_oracle)
    log(f"controller collective: kickoff -> EventCollectiveInstalled first "
        f"{first:.1f} ms (oracle {first_oracle:.1f} ms, refresh included), "
        f"steady {', '.join(f'{x:.1f}' for x in steady)} ms (median {med:.1f}; "
        f"oracle call {med_oracle:.1f} ms, router install {med - med_oracle:.1f} "
        f"ms, {100 * (med - med_oracle) / med:.1f}%); device busy "
        f"{busy:.3f} ms of a {wall:.1f} ms profiled install "
        f"({100 * busy / wall:.2f}%); {install.n_flows:,} switch-level flow "
        f"entries in {len(install.switches)} switches")

    # the install against a direct call of the oracle with the router's
    # arguments: its src-major deduplicated pairs, the manager's knobs
    install = next(iter(router.collectives))
    tm = ctl.topology_manager
    cfg = ctl.config
    key = np.flatnonzero(~np.eye(N_RANKS, dtype=bool))
    src_idx, dst_idx = (a.astype(np.int32) for a in np.divmod(key, N_RANKS))
    # the steady re-installs of one collective are route-cache hits; the
    # hit's cost is the key over the 16.7M pairs
    cache = tm.topologydb.route_cache
    t0 = time.perf_counter()
    cache.collective_key(list(install.macs), src_idx, dst_idx, "balanced", None, {})
    log(f"controller collective: {REGISTRY.get('route_cache_hits_total').value - hits0:.0f} "
        f"of the 5 re-installs (3 steady, 2 profiled) served from the route "
        f"cache; one cache key "
        f"over the {N_RANKS * (N_RANKS - 1):,} pairs takes "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    # the flight recorder's cost on the install path: steady installs
    # with the recorder armed (the default) and disarmed, in turns
    by_state: dict = {True: [], False: []}
    for s, armed in ((12, True), (14, False), (16, False), (18, True)):
        (ctl.flight.arm if armed else ctl.flight.disarm)()
        router._remove_collective(next(iter(router.collectives)))
        by_state[armed].append(kickoff(s, s + 1))
    log(f"controller collective: steady install with the flight recorder armed "
        f"{', '.join(f'{x:.1f}' for x in by_state[True])} ms, disarmed "
        f"{', '.join(f'{x:.1f}' for x in by_state[False])} ms (in turns: armed, "
        "disarmed, disarmed, armed)")
    install = next(iter(router.collectives))
    # the direct call takes the uncached leg: a memo hit would compare
    # the install with itself
    direct = tm.topologydb._find_routes_collective(
        list(install.macs), src_idx, dst_idx, policy="balanced",
        link_util=tm.routing_util(), alpha=cfg.congestion_alpha,
        link_capacity=cfg.link_capacity_bps, ecmp_ways=cfg.ecmp_ways,
        rounds=cfg.balance_rounds,
    )
    if float(install.max_congestion) != float(direct.max_congestion):
        fail(f"controller collective: max congestion {install.max_congestion} "
             f"against {direct.max_congestion} from the direct call")
    check_routes("controller collective (direct call)", spec, tm.topologydb,
                 list(install.macs), src_idx, dst_idx, direct)
    del direct, src_idx, dst_idx, key
    rng = np.random.default_rng(0)
    pairs = rng.choice(N_RANKS, (CTL_DELIVER + 100, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]][:CTL_DELIVER]
    t0 = time.perf_counter()
    n = deliver_pairs(fabric, macs, pairs, "controller collective")
    check_block_paths(ctl, "controller collective")
    from sdnmpi_tpu_torch.utils.devprof import sample_memory

    rss = sample_memory("cpu")
    # five Monitor passes at the default pacing (the audit 64 switches a
    # pass, the sentinel 64 installed unicast pairs a pass: this fabric
    # holds none, the collective's rows are the scheduler's)
    _, _, pass_counts = monitor_passes(
        ctl, 5, "controller collective (Monitor passes)", report)
    if pass_counts["bfs_distances"] or pass_counts["ring_all_gather"]:
        fail(f"controller collective: the Monitor passes launched {pass_counts}")
    log(f"controller collective: audit cycle {ctl.audit.cycle}, "
        f"{sum(len(t) for t in ctl.audit._counters.values())} rows baselined, "
        f"sentinel {ctl.sentinel._last}, {len(ctl.flight.bundles)} flight "
        f"bundles, {ctl.timeline.n_recorded} timeline rows")
    log(f"controller collective: max congestion {install.max_congestion} equal "
        f"to the direct call's; {n} seeded rank pairs delivered through the "
        f"switch tables with the MAC rewrite [{time.perf_counter() - t0:.1f} s]; "
        f"host memory {rss['in_use'] / 2**30:.1f} GiB in use, peak "
        f"{rss['peak'] / 2**30:.1f} GiB")
    # the fabric's block tables and their member indexes are a heap of
    # ~10^8 Python objects in reference cycles: free them here, so that
    # the collector's pass over them is not billed to the next phase
    del fabric, ctl, router, tm, install, installed
    drop_recorder()
    t0 = time.perf_counter()
    gc.collect()
    log(f"controller collective: gc.collect() of the phase's fabric and "
        f"controller took {time.perf_counter() - t0:.1f} s")
    return [counts, pass_counts]


def log_host_profile(what: str, fn, top: int = 14) -> None:
    """Run ``fn()`` once under cProfile and log its ``top`` functions by
    own time (cProfile slows Python calls, not native code: the shares
    are leads, the wall times above are the measurement)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:top]
    log(f"{what} host profile (cProfile, own time):")
    for (path, line, name), (_, ncalls, own, cum, _) in rows:
        log(f"  {own * 1e3:9.1f} ms own {cum * 1e3:9.1f} ms cum x{ncalls:<7d} "
            f"{os.path.basename(path)}:{line} {name}")


def check_block_paths(ctl, what: str, dense=None) -> None:
    """Every block path of the installed collectives is a shortest path
    over the fabric's links, with each hop's port that link's port; the
    distances and ports are those of ``dense``'s oracle (a controller on
    the same fabric; ``ctl``'s own by default)."""
    db = (dense or ctl).topology_manager.topologydb
    t, dist, _ = db._oracle_engine().matrices(db)
    port_h = t.host_port()
    row_of = np.full(int(t.dpids.max()) + 2, -1, np.int64)
    row_of[t.dpids] = np.arange(len(t.dpids))
    n = 0
    for install in ctl.router.collectives:
        blocks = {id(e.block): e.block for sw in ctl.southbound.switches.values()
                  for e in sw.block_table if e.block.cookie == install.cookie}
        for b in blocks.values():
            hop_len = np.asarray(b.hop_len).astype(np.int64)
            live = hop_len > 0
            rows = np.where(np.asarray(b.hop_dpid) >= 0,
                            row_of[np.asarray(b.hop_dpid)], -1)[live]
            length = hop_len[live]
            last = rows[np.arange(len(rows)), length - 1]
            if (dist[rows[:, 0], last] != length - 1).any():
                fail(f"{what}: a block path is not a shortest path")
            a, c = rows[:, :-1], rows[:, 1:]
            hop = (a >= 0) & (c >= 0)
            if not (port_h[a[hop], c[hop]] == np.asarray(b.hop_port)[live][:, :-1][hop]).all():
                fail(f"{what}: a block hop leaves by a port that is not its link's")
            n += len(rows)
    log(f"{what}: {n:,} block paths are shortest paths over real links")


def fdb_path(ctl, fabric, src: str, dst: str) -> list:
    """The switch path of one installed (src, dst) unicast flow, walked
    hop by hop through the router's SwitchFDB from the source host's
    switch; fails when it does not end on the destination host's port."""
    fdb = ctl.router.fdb.fdb
    peer = {}
    for a, pa, b, pb in fabric.links:
        peer[(a, pa)] = b
        peer[(b, pb)] = a
    host = fabric.hosts[dst]
    node = fabric.hosts[src].dpid
    path = [node]
    while True:
        port = fdb.get(node, {}).get((src, dst))
        if port is None:
            fail(f"walk {src} -> {dst}: no flow at switch {node}")
        if node == host.dpid and port == host.port_no:
            return path
        node = peer.get((node, port))
        if node is None or len(path) > 64:
            fail(f"walk {src} -> {dst}: port {port} leads nowhere")
        path.append(node)


def check_unicast_paths(ctl, fabric, pairs, what: str) -> int:
    """Every installed pair of ``pairs`` rides a shortest path."""
    db = ctl.topology_manager.topologydb
    t, dist, _ = db._oracle_engine().matrices(db)
    for src, dst in pairs:
        path = fdb_path(ctl, fabric, src, dst)
        if len(path) - 1 != dist[t.index[path[0]], t.index[path[-1]]]:
            fail(f"{what}: {src} -> {dst} rides {path}, not a shortest path")
    return len(pairs)


def phase_controller_packet_in(device, report: dict) -> list:
    """Config 5 through the controller: ``dragonfly(8, 32).to_fabric()``
    (256 routers, one host each) with ``coalesce_routes=True`` and
    ``collective_policy="adaptive"``. (a) Config 5's 10,000 host pairs
    arrive as IP packet-ins from their source hosts' ports, a burst the
    coalescer parks and resolves in windows (the sim's idle edge flushes
    the rest, as ``control/loadgen.py`` drives it); reports the latency
    from each parked packet-in to its window's FlowMods, the windows and
    the packets delivered, every installed path a shortest path. (b) A
    64-rank alltoall kickoff (4,032 pairs, below the block threshold)
    takes the adaptive window install: launches K1 0, set-up 1, K2 2,
    both K2 calls held against the plain version, kickoff to the last
    FlowMod timed. (c) One loaded global link fails: the time until the
    revalidation has re-installed every affected pair, none on the dead
    link. Returns the launch counts of (a), (b) and (c)."""
    import torch

    from sdnmpi_tpu_torch.control import events as ev
    from sdnmpi_tpu_torch.protocol import openflow as of
    from sdnmpi_tpu_torch.protocol.vmac import CollectiveType, VirtualMac

    p = dragonfly_problem(device)
    spec, t = p["spec"], p["t"]
    fabric, ctl, _ = controller_stack(spec, device, coalesce_routes=True,
                                      collective_policy="adaptive")
    router = ctl.router
    mac_of = {dpid: mac for mac, dpid, _ in spec.hosts}
    host_macs = [mac_of[int(d)] for d in t.dpids[: t.n_real]]
    pairs = [(host_macs[s], host_macs[d]) for s, d in zip(p["src"], p["dst"])]
    windows: list = []
    timed_handler(ctl, ev.DispatchRoutesBatchRequest, windows)
    # each parked packet-in's latency: from its park (Router's
    # monotonic t_parked) to the end of its window's FlowMod install
    sizes: list = []
    stamp = [0.0]
    latency: list = []
    done: list = []
    install_window, finish_batch = router._install_window, router._finish_batch

    def stamped_install(*args, **kw):
        out = install_window(*args, **kw)
        stamp[0] = time.monotonic()
        return out

    def timed_finish(batch, *args, **kw):
        finish_batch(batch, *args, **kw)
        sizes.append(len(batch))
        latency.extend(stamp[0] - q.t_parked for q in batch)
        done.append(stamp[0])

    router._install_window, router._finish_batch = stamped_install, timed_finish

    def burst_of(these):
        for src, dst in these:
            h = fabric.hosts[src]
            ctl.bus.publish(ev.EventPacketIn(h.dpid, h.port_no, of.Packet(
                eth_src=src, eth_dst=dst, eth_type=of.ETH_TYPE_IP, payload=b"p",
            ), of.OFP_NO_BUFFER))
        router.flush_routes()  # the idle edge after the burst

    def burst():
        burst_of(pairs)

    t0 = time.perf_counter()
    t_mono = time.monotonic()
    counts_a = path_launches(burst)
    burst_ms = (time.perf_counter() - t0) * 1e3
    gaps = np.diff([t_mono, *done]) * 1e3
    if len(latency) != len(pairs):
        fail(f"packet-in burst: {len(latency)} of {len(pairs)} packets finished")
    delivered = sum(len(h.received) for h in fabric.hosts.values())
    if delivered != len(pairs):
        fail(f"packet-in burst: {delivered} of {len(pairs)} packets delivered")
    unique = sorted(set(pairs))
    check_unicast_paths(ctl, fabric, unique, "packet-in burst")
    lat = np.array(latency) * 1e3
    log(f"packet-in burst: {len(pairs):,} packet-ins ({len(unique):,} distinct "
        f"pairs) in {len(windows)} windows (sizes {min(sizes)}-{max(sizes)}, "
        f"median {statistics.median(sizes):.0f}; window dispatch median "
        f"{statistics.median(windows):.2f} ms) over {burst_ms:.1f} ms; "
        f"packet-in -> FlowMods p50 {np.percentile(lat, 50):.2f} ms, p99 "
        f"{np.percentile(lat, 99):.2f} ms, max {lat.max():.2f} ms; "
        f"{delivered:,} packets delivered; every path shortest; launches "
        f"{counts_a}; window to window: median {np.median(gaps):.1f} ms, "
        f"max {gaps.max():.1f} ms (window {int(gaps.argmax())})")
    log_host_profile("packet-in burst, 2,000 more packet-ins",
                     lambda: burst_of(pairs[:2000]))
    if any(counts_a.values()):
        fail(f"packet-in burst: the shortest windows launched {counts_a}")

    # (b) the adaptive window install of a 64-rank alltoall
    ranks = [m for m, _, _ in spec.hosts[:CTL_WINDOW_RANKS]]
    launch_ranks(fabric, ranks)
    mods: list = []
    flow_mods_window = fabric.flow_mods_window

    def stamped_mods(dpids, batch):
        out = flow_mods_window(dpids, batch)
        mods.append(time.perf_counter())
        return out

    fabric.flow_mods_window = stamped_mods
    out: dict = {}

    def kickoff():
        t_send = time.perf_counter()
        send_mpi(fabric, ranks, 0, 1)
        torch.cuda.synchronize()
        out["ms"] = (mods[-1] - t_send) * 1e3

    counts_b = checked_launches(kickoff, "adaptive window install", report)
    want = launches_of(setup=1, k2=2)
    if counts_b != want:
        fail(f"adaptive window install: launches {counts_b}, want {want}")
    n_pairs = CTL_WINDOW_RANKS * (CTL_WINDOW_RANKS - 1)
    fdb_pairs = router.fdb.pairs()
    missing = [(s, d) for s in range(CTL_WINDOW_RANKS)
               for d in range(CTL_WINDOW_RANKS) if s != d
               and (ranks[s], VirtualMac(CollectiveType.ALLTOALL, s, d).encode())
               not in fdb_pairs]
    if missing:
        fail(f"adaptive window install: {len(missing)} of {n_pairs} pairs "
             "have no flows")
    n_del = deliver_pairs(fabric, ranks, [(s, d) for s in range(0, 64, 7)
                                          for d in range(0, 64, 5) if s != d],
                          "adaptive window install")
    log(f"adaptive window install: {n_pairs:,} pairs, kickoff -> last FlowMod "
        f"{out['ms']:.1f} ms; launches {counts_b}; {n_del} pairs delivered")

    # (c) one loaded global link fails
    group = spec.podmap.pod_of
    fdb = router.fdb.fdb
    loaded = [c for c in fabric.links if group[c[0]] != group[c[2]]
              and any(port == c[1] for port in fdb.get(c[0], {}).values())]
    cable = loaded[0]
    a, pa, b, pb = cable
    affected = sorted(k for k, port in fdb.get(a, {}).items() if port == pa)
    affected += sorted(k for k, port in fdb.get(b, {}).items() if port == pb)
    out = {}

    def fail_link():
        t0 = time.perf_counter()
        fabric.remove_link(*cable)
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3

    # the revalidation's epoch gate narrows from its second pass on: this
    # first topology signal sets the baseline (a full pass that changes
    # no route here)
    ctl.bus.publish(ev.EventTopologyChanged())
    dirty_windows: list = []
    handler = ctl.bus._request_handlers[ev.DispatchRoutesBatchRequest]

    def narrowed(req):
        dirty_windows.append(req.dirty)
        return handler(req)

    ctl.bus._request_handlers[ev.DispatchRoutesBatchRequest] = narrowed
    oracle = ctl.topology_manager.topologydb._oracle_engine()
    full0, repairs0 = oracle.full_refresh_count, oracle.repair_count
    counts_c = path_launches(fail_link)
    ctl.bus._request_handlers[ev.DispatchRoutesBatchRequest] = handler
    if (not dirty_windows or not all(dirty_windows)
            or oracle.full_refresh_count != full0 or oracle.repair_count <= repairs0):
        fail(f"link failure: the revalidation did not take the narrowed leg "
             f"({len(dirty_windows)} windows, dirty sets {dirty_windows[:2]}; "
             f"{oracle.full_refresh_count - full0} full refreshes, "
             f"{oracle.repair_count - repairs0} repaired link deltas)")
    if any(port == pa for port in fdb.get(a, {}).values()) or any(
            port == pb for port in fdb.get(b, {}).values()):
        fail("link failure: a flow still rides the dead link")
    unicast = [(s, d) for s, d in affected if d in fabric.hosts]
    check_unicast_paths(ctl, fabric, unicast, "link failure")
    log(f"link failure: global link {a}:{pa} - {b}:{pb} carried "
        f"{len(affected)} flows ({len(unicast)} unicast pairs); revalidation "
        f"re-installed them in {out['ms']:.1f} ms, none on the dead link, the "
        f"unicast ones on shortest paths; launches {counts_c}; the narrowed leg: "
        f"{len(dirty_windows)} delta windows with the dirty set, "
        f"{oracle.repair_count - repairs0} link deltas repaired in place, no "
        f"full refresh")
    return [counts_a, counts_b, counts_c]


# -- phases 15 to 17: the command line, the TCP southbound, serving -------


class LogTimes(logging.Handler):
    """A logging handler that keeps ``(perf_counter, message)`` of every
    record it sees."""

    def __init__(self, out: list):
        super().__init__()
        self.out = out

    def emit(self, record) -> None:
        self.out.append((time.perf_counter(), record.getMessage()))


@contextlib.contextmanager
def launcher_probe(record: dict):
    """Instrument one in-process run of the port's launcher: the
    Controller it builds, the time of each ``launch`` log record, the
    walls of its checkpoint save and restore, and the serving-load
    reports of ``--tenants``. Everything lands in ``record``."""
    from sdnmpi_tpu_torch import launch
    from sdnmpi_tpu_torch.api import snapshot

    real = (launch.Controller, snapshot.save_checkpoint,
            snapshot.load_checkpoint, launch.run_serving_load)

    def controller(*a, **kw):
        record["controller"] = real[0](*a, **kw)
        return record["controller"]

    def timed(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                record[name] = time.perf_counter() - t0
        return call

    def serving(*a, **kw):
        record["reports"] = real[3](*a, **kw)
        return record["reports"]

    logger = logging.getLogger("launch")
    times = LogTimes(record.setdefault("log", []))
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(times)
    launch.Controller, launch.run_serving_load = controller, serving
    snapshot.save_checkpoint = timed("save_s", real[1])
    snapshot.load_checkpoint = timed("load_s", real[2])
    try:
        yield
    finally:
        (launch.Controller, snapshot.save_checkpoint, snapshot.load_checkpoint,
         launch.run_serving_load) = real
        logger.removeHandler(times)
        logger.setLevel(level)


@contextlib.contextmanager
def collector_pauses(out: dict):
    """Sum the passes of Python's cyclic collector while the context is
    open: ``out`` gets their count, the full (generation 2) ones and
    their seconds."""
    out.update(n=0, full=0, s=0.0)
    started = []

    def pause(phase: str, info: dict) -> None:
        if phase == "start":
            started.append(time.perf_counter())
            return
        out["s"] += time.perf_counter() - started.pop()
        out["n"] += 1
        out["full"] += info["generation"] == 2

    gc.callbacks.append(pause)
    try:
        yield
    finally:
        gc.callbacks.remove(pause)


def run_launcher(argv: list, what: str, report: dict,
                 installs: int = 1) -> tuple[dict, dict]:
    """``sdnmpi_tpu_torch.launch.main(argv)`` in this process, with every
    K2 call recorded and held against the plain sampler. Returns the
    launch counts of the run and the probe's record."""
    from sdnmpi_tpu_torch import launch

    record: dict = {}
    pauses: dict = {}
    log(f"{what}: python -m sdnmpi_tpu_torch {' '.join(argv)}")
    with launcher_probe(record), collector_pauses(pauses):
        record["t0"] = time.perf_counter()
        counts = checked_launches(lambda: launch.main(argv), what, report, installs)
        record["wall_s"] = time.perf_counter() - record["t0"]
    log(f"launches, {what}: {counts}; the cyclic collector ran {pauses['n']} "
        f"passes ({pauses['full']} full) for {pauses['s']:.2f} s of the "
        f"{record['wall_s']:.2f} s run")
    return counts, record


def logged_at(record: dict, text: str) -> float:
    """Seconds from the run's start to its first ``launch`` log record
    holding ``text``."""
    for t, msg in record["log"]:
        if text in msg:
            return t - record["t0"]
    fail(f"the launcher never logged {text!r}")


def drop_recorder() -> None:
    """Disarm the process's flight recorder and drop it as the process
    default (``utils.flight.RECORDER``). Its context providers hold its
    controller, so while the default names it a torn-down controller's
    heap stays alive, and the cyclic collector frees it in whatever runs
    after the next controller arms (both packages behave so)."""
    from sdnmpi_tpu_torch.utils import flight

    if flight.RECORDER is not None:
        flight.RECORDER.disarm()
        flight.RECORDER = None


def collect(what: str) -> None:
    drop_recorder()
    t0 = time.perf_counter()
    gc.collect()
    log(f"{what}: gc.collect() took {time.perf_counter() - t0:.1f} s")


def phase_launcher(device, report: dict, k: int = FATTREE_K,
                   n_ranks: int = N_RANKS, shards: int = N_SHARDS) -> list:
    """Config 4 through the port's command line, in this process: (1)
    ``--demo`` of a 4096-rank alltoall on the k=28 fat-tree (the 16.7M
    pairs of phase 13, block-installed) writing checkpoint A; (2)
    ``--restore A --checkpoint B`` with no demo; (3) the demo again on
    the sharded oracle (``--shard-oracle --ring-exchange --mesh-devices
    8``). Reports each run's launches, the start -> ``demo: ... flows
    installed`` wall, the checkpoint's bytes and write seconds and the
    restore seconds; A and B must agree on the rank DB, the collectives
    and the desired flows, and the sharded install must have the
    unsharded one's max congestion. Returns the launch counts."""
    os.makedirs(OUT_DIR, exist_ok=True)
    ckpt_a = os.path.join(OUT_DIR, "launcher-A.json")
    ckpt_b = os.path.join(OUT_DIR, "launcher-B.json")
    base = ["--topo", f"fattree:{k}", "--no-rpc", "--duration", "0.1",
            "--device", str(device)]
    demo = ["--demo", "--demo-ranks", str(n_ranks)]
    n_pairs = n_ranks * (n_ranks - 1)

    def installed(record: dict, what: str):
        colls = list(record["controller"].router.collectives)
        if len(colls) != 1 or colls[0].n_pairs != n_pairs:
            fail(f"{what}: {[c.n_pairs for c in colls]} pairs block-installed, "
                 f"want one collective of {n_pairs:,}")
        return colls[0]

    def want(counts: dict, expect: dict, what: str) -> None:
        for name, n in expect.items():
            if counts[name] != n:
                fail(f"{what}: launches {counts}, want {expect}")

    counts_a, rec = run_launcher(base + demo + ["--checkpoint", ckpt_a],
                                 "launcher demo", report)
    want(counts_a, launches_of(setup=1, k2=1), "launcher demo")
    max_congestion = float(installed(rec, "launcher demo").max_congestion)
    size_a = os.path.getsize(ckpt_a)
    log(f"launcher demo: start -> demo flows installed "
        f"{logged_at(rec, 'demo:'):.2f} s (start -> fabric and controller up "
        f"{logged_at(rec, 'topology'):.2f} s); run {rec['wall_s']:.2f} s; "
        f"checkpoint A {size_a:,} bytes written in {rec['save_s']:.2f} s; "
        f"max congestion {max_congestion}")
    rec.clear()
    collect("launcher demo")

    counts_b, rec = run_launcher(base + ["--restore", ckpt_a, "--checkpoint", ckpt_b],
                                 "launcher restore", report)
    want(counts_b, launches_of(setup=1, k2=1), "launcher restore")
    restored = float(installed(rec, "launcher restore").max_congestion)
    if restored != max_congestion:
        fail(f"launcher restore: max congestion {restored}, saved {max_congestion}")
    log(f"launcher restore: checkpoint A restored in {rec['load_s']:.2f} s; "
        f"checkpoint B {os.path.getsize(ckpt_b):,} bytes written in "
        f"{rec['save_s']:.2f} s; run {rec['wall_s']:.2f} s")
    rec.clear()
    collect("launcher restore")
    t0 = time.perf_counter()
    with open(ckpt_a) as f:
        snap_a = json.load(f)
    with open(ckpt_b) as f:
        snap_b = json.load(f)
    for key in ("rankdb", "collectives", "desired_flows"):
        if snap_a[key] != snap_b[key]:
            fail(f"launcher restore: checkpoints A and B differ in {key!r}")
    n_ranks_a = len(snap_a["rankdb"])
    del snap_a, snap_b
    os.remove(ckpt_a)
    os.remove(ckpt_b)
    log(f"launcher restore: A and B agree on the rank DB ({n_ranks_a} ranks), "
        f"the collectives and the desired flows "
        f"[{time.perf_counter() - t0:.1f} s]")
    collect("launcher checkpoints")

    sharded = ["--shard-oracle", "--ring-exchange", "--mesh-devices", str(shards)]
    counts_c, rec = run_launcher(base + demo + sharded, "launcher sharded demo", report)
    # ring mode streams every exchange with the step form, K3 idle: the
    # refresh's two column exchanges (its argmin split in two at this V)
    # and the collective's distance exchange
    want(counts_c, launches_of(setup=1, k2=shards, step=3 * ring_steps(shards)),
         "launcher sharded demo")
    got = float(installed(rec, "launcher sharded demo").max_congestion)
    if got != max_congestion:
        fail(f"launcher sharded demo: max congestion {got} against "
             f"{max_congestion} unsharded")
    log(f"launcher sharded demo: start -> demo flows installed "
        f"{logged_at(rec, 'demo:'):.2f} s (start -> fabric and controller up "
        f"{logged_at(rec, 'topology'):.2f} s); run {rec['wall_s']:.2f} s; max "
        f"congestion {got} equal to the unsharded install's")
    rec.clear()
    collect("launcher sharded demo")
    return [counts_a, counts_b, counts_c]


class ScriptedSwitch:
    """An OpenFlow 1.0 switch as raw bytes over TCP, the role a physical
    switch or OVS plays: it answers the handshake, echoes and barriers,
    and keeps every FlowMod it receives, decoded, with its arrival
    time."""

    def __init__(self, dpid: int, ports: list):
        self.dpid = dpid
        self.ports = ports
        self.flow_mods: list = []
        self.barriers = 0
        self.last_flow_mod = 0.0

    async def connect(self, port: int) -> None:
        import asyncio

        from sdnmpi_tpu_torch.protocol import ofwire

        self.reader, self.writer = await asyncio.open_connection("127.0.0.1", port)
        self.writer.write(ofwire.encode_hello(xid=1))
        self.task = asyncio.create_task(self._read())

    async def _read(self) -> None:
        from sdnmpi_tpu_torch.protocol import ofwire

        buf = b""
        while True:
            data = await self.reader.read(1 << 16)
            if not data:
                return
            buf += data
            while len(buf) >= 8:
                msg_type, length, xid = ofwire.peek_header(buf)
                if len(buf) < length:
                    break
                msg, buf = buf[:length], buf[length:]
                if msg_type == ofwire.OFPT_FEATURES_REQUEST:
                    self.writer.write(
                        ofwire.encode_features_reply(self.dpid, self.ports, xid))
                elif msg_type == ofwire.OFPT_FLOW_MOD:
                    self.flow_mods.append(ofwire.decode_flow_mod(msg))
                    self.last_flow_mod = time.perf_counter()
                elif msg_type == ofwire.OFPT_BARRIER_REQUEST:
                    self.barriers += 1
                    self.writer.write(ofwire.encode_barrier_reply(xid))
                elif msg_type == ofwire.OFPT_ECHO_REQUEST:
                    self.writer.write(ofwire.encode_echo_reply(msg[8:], xid))

    def send(self, payload: bytes) -> None:
        self.writer.write(payload)

    async def close(self) -> None:
        self.task.cancel()
        self.writer.close()


def expected_flow_mods(block) -> list:
    """The (switch, src, dst, out-port, rewrite) rows a block install
    must put on the wire: one per member per hop of its sub-flow's
    path, the last hop rewriting the virtual MAC to the host's."""
    from sdnmpi_tpu_torch.utils.mac import int_to_mac

    rows = []
    bounds = np.asarray(block.bounds)
    for s in range(len(block.hop_len)):
        n_hops = int(block.hop_len[s])
        for m in range(int(bounds[s]), int(bounds[s + 1])):
            src, dst = int_to_mac(int(block.src[m])), int_to_mac(int(block.dst[m]))
            for h in range(n_hops):
                last = h == n_hops - 1
                rows.append((
                    int(block.hop_dpid[s, h]), src, dst,
                    int(block.final_port[m] if last else block.hop_port[s, h]),
                    int_to_mac(int(block.rewrite[m])) if last else None,
                ))
    return sorted(rows)


def received_flow_mods(switches: dict, cookie: int) -> list:
    from sdnmpi_tpu_torch.protocol import openflow as of

    rows = []
    for dpid, sw in switches.items():
        for m in sw.flow_mods:
            if m.cookie != cookie:
                continue
            out = [a.port for a in m.actions if isinstance(a, of.ActionOutput)]
            rew = [a.mac for a in m.actions if isinstance(a, of.ActionSetDlDst)]
            rows.append((dpid, m.match.dl_src, m.match.dl_dst, out[0],
                         rew[0] if rew else None))
    return sorted(rows)


def phase_southbound(device, report: dict, k: int = 8, n_ranks: int = 128) -> list:
    """Config 14's fabric over TCP: the 80 switches of a k=8 fat-tree
    dial the port's ``OFSouthbound`` as scripted raw-byte switches, the
    links and hosts announced on the bus; 128 ranks announce with
    UDP:61000 packet-in bytes and one kickoff packet-in starts a
    16,256-pair alltoall, which takes the block install. Every FlowMod
    of the block must land as OF 1.0 bytes on the switch the oracle's
    route names (the route of the ``FindCollectiveRoutesRequest`` reply,
    unrolled per member and hop). Reports the FlowMods, the kickoff ->
    last FlowMod wall and the K2 launches (set-up 1, K2 1, each held
    against the plain version). Returns the launch counts."""
    import asyncio

    import torch

    from sdnmpi_tpu_torch import Config, Controller
    from sdnmpi_tpu_torch.control import events as ev
    from sdnmpi_tpu_torch.control.southbound import OFSouthbound
    from sdnmpi_tpu_torch.core.topology_db import Host, Link, Port
    from sdnmpi_tpu_torch.protocol import ofwire
    from sdnmpi_tpu_torch.protocol import openflow as of
    from sdnmpi_tpu_torch.protocol.announcement import Announcement, AnnouncementType
    from sdnmpi_tpu_torch.protocol.vmac import CollectiveType, VirtualMac
    from sdnmpi_tpu_torch.topogen import fattree

    spec = fattree(k)
    out: dict = {}

    async def run() -> None:
        sb = OFSouthbound(host="127.0.0.1", port=0)
        ctl = Controller(sb, Config(oracle_backend="torch", device=str(device)))
        ctl.attach()
        await sb.serve()
        ports: dict = {d: set() for d in spec.switches}
        for _, dpid, port in spec.hosts:
            ports[dpid].add(port)
        for a, pa, b, pb in spec.links:
            ports[a].add(pa)
            ports[b].add(pb)
        switches = {d: ScriptedSwitch(d, sorted(ports[d])) for d in spec.switches}
        t0 = time.perf_counter()
        for sw in switches.values():
            await sw.connect(sb.bound_port)
        while len(sb.connected_dpids()) < len(switches):
            if time.perf_counter() - t0 > 60:
                fail(f"southbound: {len(sb.connected_dpids())} of "
                     f"{len(switches)} switches completed the handshake")
            await asyncio.sleep(0.01)
        for a, pa, b, pb in spec.links:
            ctl.bus.publish(ev.EventLinkAdd(Link(Port(a, pa), Port(b, pb))))
            ctl.bus.publish(ev.EventLinkAdd(Link(Port(b, pb), Port(a, pa))))
        for mac, dpid, port in spec.hosts:
            ctl.bus.publish(ev.EventHostAdd(Host(mac, Port(dpid, port))))
        hosts = spec.hosts[:n_ranks]
        for rank, (mac, dpid, port) in enumerate(hosts):
            switches[dpid].send(ofwire.encode_packet_in(of.Packet(
                mac, "ff:ff:ff:ff:ff:ff", ip_proto=of.IPPROTO_UDP, udp_dst=61000,
                payload=Announcement(AnnouncementType.LAUNCH, rank).encode(),
            ), in_port=port, xid=100 + rank))
        while len(ctl.process_manager.rankdb) < n_ranks:
            if time.perf_counter() - t0 > 120:
                fail(f"southbound: {len(ctl.process_manager.rankdb)} of "
                     f"{n_ranks} ranks registered")
            await asyncio.sleep(0.01)
        log(f"southbound: {len(switches)} switches dialled and {n_ranks} ranks "
            f"announced over TCP [{time.perf_counter() - t0:.1f} s]")

        # the oracle's reply and the block the router hands the southbound
        replies, blocks = [], []
        handler = ctl.bus._request_handlers[ev.FindCollectiveRoutesRequest]

        def oracle(req):
            reply = handler(req)
            replies.append(reply.routes)
            return reply

        ctl.bus._request_handlers[ev.FindCollectiveRoutesRequest] = oracle
        block_set = sb.flow_block_set

        def flow_block_set(block):
            blocks.append(block)
            out["t_block"] = time.perf_counter()
            try:
                return block_set(block)
            finally:
                out["t_unrolled"] = time.perf_counter()

        sb.flow_block_set = flow_block_set
        mac0, dpid0, port0 = hosts[0]
        kickoff = ofwire.encode_packet_in(of.Packet(
            mac0, VirtualMac(CollectiveType.ALLTOALL, 0, 1).encode(),
            eth_type=of.ETH_TYPE_IP), in_port=port0, xid=999)
        k2_calls: list = []
        zero_launches()
        with recording_sampler(k2_calls):
            t_kick = time.perf_counter()
            switches[dpid0].send(kickoff)
            while not blocks:
                if time.perf_counter() - t_kick > 120:
                    fail("southbound: the kickoff installed no block")
                await asyncio.sleep(0.005)
            torch.cuda.synchronize()
            out["counts"] = read_launches()
        report["sample_slots"]["max_abs_err"] = max(
            report["sample_slots"]["max_abs_err"],
            check_k2_calls(k2_calls, out["counts"]["sample_slots"],
                           "southbound block install"))
        want = expected_flow_mods(blocks[0])
        while True:
            got = received_flow_mods(switches, blocks[0].cookie)
            if len(got) >= len(want) or time.perf_counter() - t_kick > 120:
                break
            await asyncio.sleep(0.01)
        out["ms"] = (max(sw.last_flow_mod for sw in switches.values()) - t_kick) * 1e3
        out["route_ms"] = (out["t_block"] - t_kick) * 1e3
        out["unroll_ms"] = (out["t_unrolled"] - out["t_block"]) * 1e3
        routes = replies[-1]
        if not np.array_equal(blocks[0].hop_dpid, routes.hop_dpid):
            fail("southbound: the installed block's paths are not the oracle's")
        if got != want:
            fail(f"southbound: {len(got):,} block FlowMods received, {len(want):,} "
                 f"expected, {len(set(want) - set(got)):,} missing")
        install = next(iter(ctl.router.collectives))
        if install.n_flows != len(want) or install.n_pairs != n_ranks * (n_ranks - 1):
            fail(f"southbound: install of {install.n_pairs:,} pairs and "
                 f"{install.n_flows:,} flows, {len(want):,} FlowMods expected")
        out["flow_mods"] = len(got)
        out["switches"] = sum(1 for sw in switches.values() if any(
            m.cookie == blocks[0].cookie for m in sw.flow_mods))
        # the run is over: the switches' disconnects must not re-route
        sb.bus = None
        for sw in switches.values():
            await sw.close()
        await sb.close()

    asyncio.run(run())
    counts = out["counts"]
    if counts != launches_of(setup=1, k2=1):
        fail(f"southbound block install: launches {counts}")
    log(f"southbound: block install of {n_ranks * (n_ranks - 1):,} pairs sent "
        f"{out['flow_mods']:,} FlowMods to {out['switches']} switches, every one "
        f"on the switch its oracle route names; kickoff -> last FlowMod "
        f"{out['ms']:.1f} ms (kickoff -> block handed to the southbound "
        f"{out['route_ms']:.1f} ms, its unroll into FlowMods "
        f"{out['unroll_ms']:.1f} ms); launches {counts}")
    return [counts]


def warm_start(cache_dir: str, k: int, device) -> tuple[float, int]:
    """Start ``python -m sdnmpi_tpu_torch --warm-serving`` with its
    kernel build directory at ``cache_dir`` as a child process: the
    seconds from the start to its ``serving path warmed`` log line, and
    its exit code."""
    cmd = [sys.executable, "-m", "sdnmpi_tpu_torch", "--topo", f"fattree:{k}",
           "--warm-serving", "--compile-cache-dir", cache_dir, "--duration",
           "0.1", "--no-rpc", "--device", str(device)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
    warmed, tail = None, []
    try:
        for line in proc.stderr:
            tail = (tail + [line.rstrip()])[-20:]
            if warmed is None and "serving path warmed" in line:
                warmed = time.perf_counter() - t0
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0 or warmed is None:
        fail(f"warm start: {' '.join(cmd)} exited {rc}:\n" + "\n".join(tail))
    return warmed, rc


def phase_serving(device, report: dict, k: int = 8, duration: float = 1.5) -> list:
    """Config 14's shape through the command line: ``--topo fattree:8
    --wire --tenants 4 --offered-rate 400 --duration 1.5`` (600
    requests per tenant, open loop) with the route cache and with
    ``--no-route-cache``, in turns (cache, no cache, no cache, cache);
    routes/s and p50/p99/p999 per tenant. The
    cache's hit equals its miss and the uncached route on one 256-pair
    window of the cached run's controller (config 14's fence). Then the
    port starts twice as a child process with ``--warm-serving`` and one
    kernel build directory: empty (nvcc builds the kernels) and then
    warm (the libraries load, unchanged on disk); the process start ->
    ``serving path warmed`` wall of each. Returns the launch counts of
    the two serving runs."""
    import shutil

    from sdnmpi_tpu_torch.kernels import _build

    argv = ["--topo", f"fattree:{k}", "--wire", "--tenants", "4", "--offered-rate",
            "400", "--duration", str(duration), "--no-rpc", "--device", str(device)]
    counts = []
    # in turns, cache / no cache / no cache / cache, so that the order
    # of the runs does not pass for the cache's effect
    cached, uncached = ("serving, route cache", []), (
        "serving, no route cache", ["--no-route-cache"])
    totals: dict = {}
    for what, extra in (cached, uncached, uncached, cached):
        c, rec = run_launcher(argv + extra, what, report)
        counts.append(c)
        reports = rec["reports"]
        if len(reports) != 4:
            fail(f"{what}: {len(reports)} tenant reports")
        for r in reports.values():
            if r.completed + r.rejected != r.offered or r.completed == 0:
                fail(f"{what}: tenant {r.tenant} completed {r.completed} of "
                     f"{r.offered}")
            log(f"{what}: {r.tenant} {r.routes_per_s:.1f} routes/s (offered "
                f"{r.offered}, completed {r.completed}, rejected {r.rejected}), "
                f"p50 {r.p50_ms:.3f} ms, p99 {r.p99_ms:.3f} ms, p999 "
                f"{r.p999_ms:.3f} ms")
        total = sum(r.routes_per_s for r in reports.values())
        totals.setdefault(what, []).append(total)
        log(f"{what}: {total:.1f} routes/s over the 4 tenants")
        if not extra and len(totals[what]) == 1:
            db = rec["controller"].topology_manager.topologydb
            macs = sorted(db.hosts)
            pairs = [(macs[i % len(macs)], macs[(7 * i + 3) % len(macs)])
                     for i in range(CACHE_WINDOW)]
            pairs = [(s, d) for s, d in pairs if s != d][:CACHE_WINDOW]
            miss = db.find_routes_batch_dispatch(pairs).reap()
            copy = [a.copy() for a in (miss.hop_dpid, miss.hop_port, miss.hop_len)]
            hit = db.find_routes_batch_dispatch(pairs).reap()
            off = db._find_routes_batch_dispatch(pairs).reap()
            if hit is not miss:
                fail(f"{what}: the repeat window was not served from the memo")
            for r in (hit, off):
                if not all(np.array_equal(a, b) for a, b in zip(
                        (r.hop_dpid, r.hop_port, r.hop_len), copy)):
                    fail(f"{what}: hit, miss and uncached windows differ")
            log(f"{what}: cache fence: hit == miss == uncached over "
                f"{len(pairs)} pairs")
        rec.clear()
        collect(what)
    log("serving: routes/s over the 4 tenants, with the cache (runs 1 and 4) "
        "and without (runs 2 and 3): " + "; ".join(
            f"{w} {', '.join(f'{x:.1f}' for x in v)}" for w, v in totals.items()))

    cache = os.path.join(OUT_DIR, "kernel-cache")
    shutil.rmtree(cache, ignore_errors=True)
    cold, _ = warm_start(cache, k, device)
    built = {f: os.path.getmtime(os.path.join(cache, f))
             for f in os.listdir(cache) if f.endswith(".so")}
    warm, _ = warm_start(cache, k, device)
    again = {f: os.path.getmtime(os.path.join(cache, f))
             for f in os.listdir(cache) if f.endswith(".so")}
    if len(built) != len(_build.SOURCES) or again != built:
        fail(f"warm start: {len(built)} libraries built, and the warm start "
             f"{'left them as they were' if again == built else 'rebuilt them'}")
    shutil.rmtree(cache, ignore_errors=True)
    log(f"warm start: process start -> serving path warmed cold (nvcc builds "
        f"{len(built)} kernels) {cold:.2f} s, warm (loads them) {warm:.2f} s")
    return counts


# -- phases 18 to 20: churn, the utilization plane, phased collectives ------


def alltoall_idx(n: int) -> tuple:
    """(src, dst) rank indices of an n-rank alltoall, src-major."""
    src, dst = np.nonzero(~np.eye(n, dtype=bool))
    return src.astype(np.int32), dst.astype(np.int32)


def pad_cols(a: np.ndarray, width: int) -> np.ndarray:
    """``a`` widened to ``width`` columns with -1."""
    if a.shape[1] >= width:
        return a
    out = np.full((a.shape[0], width), -1, a.dtype)
    out[:, : a.shape[1]] = a
    return out


def tail(xs) -> str:
    """Median and p99 of a list of ms."""
    return f"median {np.median(xs):.3f} ms, p99 {np.percentile(xs, 99):.3f} ms"


def phase_churn(device, report: dict, k: int = FATTREE_K, v_pad: int = V_PAD,
                n_ranks: int = N_RANKS, n_flaps: int = CHURN_FLAPS) -> list:
    """Config 8's shape (``benchmarks/config8_churn.py``): the k=28
    fat-tree padded to V=1024, the 4096-rank alltoall's aggregated edge
    pairs as the installed population (one host pair per ordered pair of
    edge switches, scored once), and a seeded storm of ``n_flaps`` flaps
    (each cable removal followed by its restore). Each flap is absorbed
    as the delta-narrowed revalidation does it: ``refresh`` (the delta
    log -> the in-place repair), ``routes_batch_delta`` over the pairs
    whose installed hops touch the flap's switches, and the fold of the
    new paths into the installed state; the three are timed. Per flap:
    the refresh repaired in place (no full refresh, ``repair_count``
    grew), distances and next hops equal a fresh oracle's full refresh
    on the card bit for bit (timed), the delta window's fdbs equal
    ``routes_batch`` over the same pairs, and ``touched`` equals a host
    set intersection. After the storm the maintained state equals a
    full re-score of every pair. Returns the launch counts of the
    storm's timed refreshes and re-scores, summed over every flap; the
    run fails unless they are all 0 (the shortest leg launches no
    kernel)."""
    import torch

    from sdnmpi_tpu_torch.oracle.engine import RouteOracle
    from sdnmpi_tpu_torch.topogen import fattree

    spec = fattree(k)
    db = spec.to_topology_db(backend="torch", device=device, pad_multiple=v_pad)
    oracle = db._oracle_engine()
    oracle.refresh(db)
    rep: dict = {}
    for mac, dpid, _ in spec.hosts[:n_ranks]:
        rep.setdefault(dpid, mac)
    edges = sorted(rep)
    pairs = [(rep[a], rep[b]) for a in edges for b in edges if a != b]
    t0 = time.perf_counter()
    wr = oracle.routes_batch_dispatch(db, pairs).reap()
    od, op, ln = wr.hop_dpid.copy(), wr.hop_port.copy(), wr.hop_len.copy()
    log(f"churn: fat-tree k={k} (V={oracle._tensors.v}), {len(pairs):,} installed "
        f"edge pairs scored in {(time.perf_counter() - t0) * 1e3:.1f} ms")
    cables = [(a, b) for a in sorted(db.links) for b in sorted(db.links[a]) if a < b]
    rng = np.random.default_rng(0)
    chosen = rng.choice(len(cables), size=(n_flaps + 1) // 2, replace=False)
    fresh = RouteOracle(db.pad_multiple, db.max_diameter, device=device)
    fresh.delta_repair_threshold = 0
    stages: dict = {"repair": [], "rescore": [], "converged": [], "full": []}
    affected: list = []
    full0 = oracle.full_refresh_count

    storm = launches_of()

    def absorb(dirty: set) -> None:
        nonlocal od, op, ln
        repairs0 = oracle.repair_count
        dirty_arr = np.fromiter(dirty, np.int64, len(dirty))
        out: dict = {}

        def timed() -> None:
            t0 = time.perf_counter()
            oracle.refresh(db)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            aff = np.nonzero(np.isin(od, dirty_arr).any(axis=1))[0]
            got = oracle.routes_batch_delta(db, [pairs[i] for i in aff], dirty)
            out.update(t0=t0, t1=t1, t2=time.perf_counter(), aff=aff, got=got)

        # the launches of the repair and the re-score, summed over the storm
        for name, n in path_launches(timed).items():
            storm[name] += n
        t0, t1, t2, aff, got = (out[x] for x in ("t0", "t1", "t2", "aff", "got"))
        aff_pairs = [pairs[i] for i in aff]
        width = max(od.shape[1], got.hop_dpid.shape[1])
        od, op = pad_cols(od, width), pad_cols(op, width)
        od[aff] = pad_cols(got.hop_dpid, width)[: len(aff)]
        op[aff] = pad_cols(got.hop_port, width)[: len(aff)]
        ln[aff] = got.hop_len[: len(aff)]
        t3 = time.perf_counter()
        stages["repair"].append((t1 - t0) * 1e3)
        stages["rescore"].append((t2 - t1) * 1e3)
        stages["converged"].append((t3 - t0) * 1e3)
        affected.append(len(aff))
        # the checks, untimed
        if oracle.full_refresh_count != full0 or oracle.repair_count <= repairs0:
            fail(f"churn: a flap took a full refresh ({oracle.full_refresh_count - full0}"
                 f" full, {oracle.repair_count - repairs0} repairs)")
        fresh._version = None
        t0 = time.perf_counter()
        fresh.refresh(db)
        torch.cuda.synchronize()
        stages["full"].append((time.perf_counter() - t0) * 1e3)
        if not (torch.equal(oracle._dist_d, fresh._dist_d)
                and torch.equal(oracle._next_d, fresh._next_d)):
            fail("churn: the repaired distances or next hops differ from a "
                 "full refresh")
        fdbs = got.fdbs()
        if fdbs != oracle.routes_batch(db, aff_pairs):
            fail("churn: routes_batch_delta differs from routes_batch")
        want = [any(d in dirty for d, _ in fdb) for fdb in fdbs]
        if got.touched.tolist() != want:
            fail("churn: touched differs from the host set intersection")

    for n, ci in enumerate(chosen):
        a, b = cables[int(ci)]
        links = [db.links[a][b], db.links[b][a]]
        for lk in links:
            db.delete_link(lk)
        absorb({a, b})
        if 2 * n + 1 < n_flaps:
            for lk in links:
                db.add_link(lk)
            absorb({a, b})
    if any(storm.values()):
        fail(f"churn: the storm's repairs and re-scores launched {storm}, want "
             "no launch (the shortest leg reads the cached distances)")
    check = oracle.routes_batch_dispatch(db, pairs).reap()
    width = max(od.shape[1], check.hop_dpid.shape[1])
    if not (np.array_equal(pad_cols(od, width), pad_cols(check.hop_dpid, width))
            and np.array_equal(pad_cols(op, width), pad_cols(check.hop_port, width))
            and np.array_equal(ln, check.hop_len)):
        fail("churn: the maintained state differs from a full re-score")
    log(f"churn: {len(affected)} flaps ({len(chosen)} cables removed and "
        f"restored), every one repaired in place ({oracle.repair_count} link "
        f"deltas, {oracle.full_refresh_count} full refresh): repair "
        f"{tail(stages['repair'])}; re-score {tail(stages['rescore'])}; "
        f"flap -> converged {tail(stages['converged'])}; affected pairs mean "
        f"{np.mean(affected):.1f} (max {max(affected)}); one full refresh "
        f"{tail(stages['full'])}; every flap's dist and next hops equal the "
        f"full refresh's, its window equal to routes_batch, touched equal to "
        f"the host intersection; the maintained state equals a full re-score; "
        f"launches of the repairs and re-scores, summed over the storm, {storm}")
    return [storm]


def phase_utilplane(device, report: dict, k: int = FATTREE_K, v_pad: int = V_PAD,
                    n_ranks: int = N_RANKS, n_passes: int = 20) -> list:
    """Config 9's shape (``benchmarks/config9_utilplane.py``): the k=28
    fat-tree, one Monitor pass of seeded samples on every directed link
    staged and flushed into a ``UtilPlane`` (timed per pass). The plane's
    normalized base equals the host dict's ``_normalized_base`` bit for
    bit (at a small and at the collective's row count); config 4's
    balanced collective with ``link_util=plane`` routes as with the dict
    (launches K1 0, set-up 1, K2 1, the K2 call and its tables held
    against the plain versions); ``hot_links(8)`` equals a numpy stable
    sort, with distinct loads and with equal loads on purpose. Returns
    the launch counts of the collective."""
    import torch

    from sdnmpi_tpu_torch.oracle.utilplane import UtilPlane
    from sdnmpi_tpu_torch.topogen import fattree

    spec = fattree(k)
    db = spec.to_topology_db(backend="torch", device=device, pad_multiple=v_pad)
    oracle = db._oracle_engine()
    t = oracle.refresh(db)
    rng = np.random.default_rng(0)
    samples = {}
    for a in sorted(db.links):
        for b in sorted(db.links[a]):
            lk = db.links[a][b]
            samples[(lk.src.dpid, lk.src.port_no)] = float(rng.random() * 1e9)
    items = list(samples.items())
    plane = UtilPlane()
    plane.sync(db, t)
    passes = []
    for i in range(n_passes + 1):
        t0 = time.perf_counter()
        for key, bps in items:
            plane.stage(key, bps + i)
        plane.flush()
        torch.cuda.synchronize()
        passes.append((time.perf_counter() - t0) * 1e3)
    for key, bps in items:
        plane.stage(key, bps)
    macs = [m for m, _, _ in spec.hosts[:n_ranks]]
    src_idx, dst_idx = alltoall_idx(len(macs))
    for n_rows in (37, len(src_idx)):
        got = oracle._normalized_base(db, t, plane, 1.0, 10e9, n_rows)
        want = oracle._normalized_base(db, t, samples, 1.0, 10e9, n_rows)
        if got.device.type != device.type or not np.array_equal(got.cpu().numpy(), want):
            diff = got.cpu().numpy() != want
            fail(f"utilization plane: the base at {n_rows} rows differs from "
                 f"the host dict's in {int(diff.sum())} entries")
    log(f"utilization plane: {len(items):,} directed links; stage + flush of "
        f"one Monitor pass (steady, {n_passes} passes) {tail(passes[1:])} "
        f"(first {passes[0]:.3f} ms); the device base equals the host dict's "
        f"bit for bit at 37 and {len(src_idx):,} rows")

    def route(link_util):
        return db.find_routes_collective(macs, src_idx, dst_idx, policy="balanced",
                                         link_util=link_util)

    out: dict = {}
    counts = checked_launches(lambda: out.update(r=route(plane)),
                              "collective with the plane", report)
    want = launches_of(setup=1, k2=1)
    if counts != want:
        fail(f"collective with the plane: launches {counts}, want {want}")
    _, first, steady, times = timed_calls(lambda: route(plane))
    host = route(samples)
    for field in ("pair_sub", "hop_dpid", "hop_port", "hop_len"):
        if not np.array_equal(getattr(out["r"], field), getattr(host, field)):
            fail(f"collective with the plane: {field} differs from the dict path's")
    if out["r"].max_congestion != host.max_congestion:
        fail("collective with the plane: max congestion differs from the dict path's")
    log(f"collective with the plane: {len(src_idx):,} pairs, steady "
        f"{', '.join(f'{x:.1f}' for x in times)} ms (median {steady:.1f}); "
        f"routes and max congestion {host.max_congestion} equal to the host "
        f"dict's; launches {counts}")
    for what, vals in (("distinct loads", None), ("equal loads", 3)):
        if vals:
            for i, (key, _) in enumerate(items):
                plane.stage(key, float((i % vals) * 1e8))
            plane.flush()
        t0 = time.perf_counter()
        hot = plane.hot_links(8)
        hot_ms = (time.perf_counter() - t0) * 1e3
        flat = plane.snapshot().cpu().numpy().reshape(-1)
        order = [int(i) for i in np.argsort(-flat, kind="stable")[:8] if flat[i] > 0]
        v = plane._v
        row_dpid = {r: d for d, r in t.index.items()}
        if [(h["src"], h["dst"], h["bps"]) for h in hot] != [
                (row_dpid[i // v], row_dpid[i % v], float(flat[i])) for i in order]:
            fail(f"hot_links ({what}): {hot} differs from the numpy stable sort")
        log(f"hot_links(8) ({what}): equal to the numpy stable sort (the lower "
            f"index first) in {hot_ms:.3f} ms; hottest {hot[0]['bps']:.0f} bps "
            f"on {hot[0]['src']} -> {hot[0]['dst']}")
    return [counts]


def check_phased(what: str, spec, db, macs, src_idx, dst_idx, program) -> None:
    """The phases partition the resolved pairs and every phase's routes
    are shortest real paths (``check_routes`` per phase)."""
    if (program.pair_phase < 0).any():
        fail(f"{what}: a pair is in no phase")
    parts = np.sort(np.concatenate([p.pair_idx for p in program.phases]))
    if not np.array_equal(parts, np.arange(len(src_idx))):
        fail(f"{what}: the phases do not partition the pairs")
    for plan in program.phases:
        if not (program.pair_phase[plan.pair_idx] == plan.phase).all():
            fail(f"{what}: phase {plan.phase} holds pairs of another phase")
        sel = plan.pair_idx
        check_routes(f"{what}, phase {plan.phase}", spec, db, macs, src_idx[sel],
                     dst_idx[sel], plan.reap())


def phased_launches(fn, what: str, report: dict, program_of, want_k2: bool) -> dict:
    """:func:`path_launches` of ``fn()`` with every K2 call recorded, held
    to the launches a phased program makes: no K1 and no K3; S2 once;
    per non-empty phase of ``program_of()`` (read after the run) one K2
    set-up and two K2 launches sharing it on the adaptive policy, or one
    S1 launch on the balanced policy; every K2 call and its tables held
    against the plain versions."""
    k2_calls: list = []
    with recording_sampler(k2_calls):
        counts = path_launches(fn)
    n = len(program_of().phases)
    want = (launches_of(setup=n, k2=2 * n, pack=1) if want_k2
            else launches_of(scan=n, pack=1))
    if counts != want:
        fail(f"{what}: launches {counts}, want {want}")
    report["sample_slots"]["max_abs_err"] = max(
        report["sample_slots"]["max_abs_err"],
        check_k2_calls(k2_calls, counts["sample_slots"], what))
    for i in range(0, len(k2_calls), 2):
        if k2_calls[i][1]["tables"] is not k2_calls[i + 1][1]["tables"]:
            fail(f"{what}: a phase's two segment launches did not share one set-up")
    return counts


def phased_run(what: str, oracle, db, spec, macs, src_idx, dst_idx, policy: str,
               report: dict, want_k2: bool) -> tuple:
    """One phased program through ``routes_collective_phased_dispatch``
    and its reaps, timed apart; its launches held by
    :func:`phased_launches`; checked with :func:`check_phased`. Returns
    (launch counts, program, wall in ms)."""
    import torch

    out: dict = {}

    def run():
        t0 = time.perf_counter()
        program = oracle.routes_collective_phased_dispatch(
            db, macs, src_idx, dst_idx, policy)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        program.reap_all()
        out.update(program=program, dispatch=(t1 - t0) * 1e3,
                   reap=(time.perf_counter() - t1) * 1e3)

    counts = phased_launches(run, what, report, lambda: out["program"], want_k2)
    program = out["program"]
    n = len(program.phases)
    check_phased(what, spec, db, macs, src_idx, dst_idx, program)
    wall = out["dispatch"] + out["reap"]
    log(f"{what}: K={program.n_phases} ({n} non-empty), pairs per phase "
        f"{[p.n_pairs for p in program.phases]}; wall {wall:.1f} ms = dispatch "
        f"{out['dispatch']:.1f} ms (the packer, then every phase enqueued) + reaps "
        f"{out['reap']:.1f} ms ({CARD}); launches {counts}")
    return counts, program, wall


def controller_phased(spec, device, policy: str, n_ranks: int, report: dict) -> dict:
    """The alltoall of the first ``n_ranks`` hosts by MAC through the
    Controller with ``schedule_collectives`` on ``policy``: the launches
    held by :func:`phased_launches`; one install and one phase event per
    phase; the program the oracle answered checked with
    :func:`check_phased`; every FlowMod on the switches one of that
    program's route hops, and every hop with its FlowMod. Returns the
    launch counts."""
    import torch

    from sdnmpi_tpu_torch.control import events as ev
    from sdnmpi_tpu_torch.protocol.vmac import CollectiveType, VirtualMac

    what = f"phased controller install, {policy} ({n_ranks} ranks)"
    fabric, ctl, installed = controller_stack(
        spec, device, schedule_collectives=True, collective_policy=policy)
    ranks = sorted(m for m, _, _ in spec.hosts)[:n_ranks]
    launch_ranks(fabric, ranks)
    captured: list = []
    handler = ctl.bus._request_handlers[ev.FindCollectiveRoutesRequest]

    def capture(req):
        reply = handler(req)
        captured.append((req, reply.routes))
        return reply

    ctl.bus._request_handlers[ev.FindCollectiveRoutesRequest] = capture
    phases: list = []
    ctl.bus.subscribe(ev.EventCollectivePhaseInstalled, phases.append)
    out: dict = {}

    def kickoff():
        t0 = time.perf_counter()
        send_mpi(fabric, ranks, 0, 1)
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3

    counts = phased_launches(kickoff, what, report, lambda: captured[-1][1],
                             want_k2=policy == "adaptive")
    if len(captured) != 1:
        fail(f"{what}: {len(captured)} collective route requests, want 1")
    req, program = captured[0]
    if len(installed) != 1 or len(phases) != len(program.phases):
        fail(f"{what}: {len(installed)} installs, {len(phases)} phase events for "
             f"{len(program.phases)} phases")
    db = ctl.topology_manager.topologydb
    check_phased(what, spec, db, req.macs, np.asarray(req.src_idx),
                 np.asarray(req.dst_idx), program)
    expected = set()
    for plan in program.phases:
        routes = plan.reap()
        for j in range(routes.n_pairs):
            kk = int(plan.pair_idx[j])
            si, di = int(req.src_idx[kk]), int(req.dst_idx[kk])
            vmac = VirtualMac(CollectiveType.ALLTOALL, si, di).encode()
            fdb = routes.fdb(j)
            for h, (dpid, port) in enumerate(fdb):
                last = h == len(fdb) - 1
                expected.add((dpid, req.macs[si], vmac, port,
                              req.macs[di] if last else None))
    got_rows = set()
    for dpid, sw in fabric.switches.items():
        for e in sw.flow_table:
            if e.match.dl_src is None:
                continue
            port = [a.port for a in e.actions if hasattr(a, "port")][-1]
            rew = [a.mac for a in e.actions if hasattr(a, "mac")]
            got_rows.add((dpid, e.match.dl_src, e.match.dl_dst, port,
                          rew[0] if rew else None))
    if got_rows != expected:
        fail(f"{what}: {len(got_rows - expected)} FlowMods off their routes, "
             f"{len(expected - got_rows)} route hops without one")
    log(f"{what}: {len(req.src_idx):,} pairs in {len(phases)} phases "
        f"(K={program.n_phases}), total discrete congestion "
        f"{program.total_discrete_congestion()}, hottest phase "
        f"{program.max_phase_congestion()}; kickoff -> last phase "
        f"{out['ms']:.1f} ms; all {len(expected):,} FlowMods on their routes' "
        f"switches; launches {counts}")
    return counts


def longest_chain(src: np.ndarray, dst: np.ndarray) -> int:
    """The longest chain of S2's dependent rows: rows that share a source
    or a destination switch, in order (rows with ``src < 0`` are free)."""
    last_s: dict = {}
    last_d: dict = {}
    best = 0
    for s, d in zip(src.tolist(), dst.tolist()):
        if s < 0:
            continue
        d = max(d, 0)
        level = 1 + max(last_s.get(s, 0), last_d.get(d, 0))
        last_s[s] = last_d[d] = level
        best = max(best, level)
    return best


def chain_floor_ms(chain: int) -> float:
    """The chain's floor at :data:`STEP_FLOOR_CYCLES` a step and
    :data:`H100_SM_MHZ` (an estimate, not a bound)."""
    return chain * STEP_FLOOR_CYCLES / (H100_SM_MHZ * 1e3)


def hold_pack(what: str, rows: tuple, k: int) -> dict:
    """Kernel S2 through its wrapper on ``rows`` (src, dst, w, util_out,
    util_in on the card) against ``_pack_greedy_plain`` on the card,
    exactly; logs the longest chain, the wrapper and bare times, the time
    a chain step and the placement. Returns the numbers."""
    import torch

    from sdnmpi_tpu_torch.sched.phases import (
        PACK_PLACEMENTS,
        _pack_greedy_device,
        _pack_greedy_plain,
        pack_placement,
    )

    g, v = rows[0].shape[0], rows[3].shape[0]
    got = _pack_greedy_device(*rows, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = _pack_greedy_plain(*rows, k)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(got, want):
        fail(f"S2 {what}: {int((got != want).sum())} of {g} rows differ from "
             "_pack_greedy_plain on the card")
    call = functools.partial(_pack_greedy_device, *rows, k)
    wrapper = time_ms(call, reps=10)
    bare = queued_ms(call, n=20)
    chain = longest_chain(rows[0].cpu().numpy(), rows[1].cpu().numpy())
    placement = PACK_PLACEMENTS[pack_placement(k, v)]
    log(f"S2 {what} ({g:,} rows, V={v:,}, K={k}; {placement}): equal to "
        f"_pack_greedy_plain ({plain_ms:.1f} ms); longest chain {chain:,}; wrapper "
        f"{wrapper:.4f} ms, bare {bare:.4f} ms, {bare / max(1, chain) * 1e6:.1f} ns a "
        f"chain step; chain floor {chain_floor_ms(chain):.4f} ms (an estimate) ({CARD})")
    return {"wrapper": wrapper, "bare": bare, "chain": chain, "plain_ms": plain_ms}


def pack_rows_on(device, src, dst, w, v: int, seed: int) -> tuple:
    """S2's arguments on the card: the rows and a seeded background."""
    import torch

    rng = np.random.default_rng(seed)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (put(np.asarray(src, np.int32)), put(np.asarray(dst, np.int32)),
            put(np.asarray(w, np.float32)), put((rng.random(v) * 4).astype(np.float32)),
            put((rng.random(v) * 4).astype(np.float32)))


def hold_pack_wide(device) -> None:
    """Kernel S2 at :data:`PACK_WIDE_V` switches and :data:`PACK_WIDE_K`
    phases (16 lanes scoring, a 508 KB state in device memory): 4,096
    seeded rows, heaviest first, with a seeded background, against
    ``_pack_greedy_plain`` on the card, exactly."""
    v, k, g = PACK_WIDE_V, PACK_WIDE_K, PACK_HOLD_ROWS
    rng = np.random.default_rng(13)
    src = rng.integers(0, v, g)
    dst = rng.integers(0, v, g)
    w = rng.integers(1, 65, g)
    order = np.argsort(-w, kind="stable")
    hold_pack(f"at V={v:,}, K={k} ({k * 2 * v * 4:,} bytes of state)",
              pack_rows_on(device, src[order], dst[order], w[order], v, 13), k)


def hold_pack_shapes(device, c12: tuple, k12: int) -> None:
    """Kernel S2's holds beside config 12 (``c12``: its sorted src, dst,
    w and V) and :func:`hold_pack_wide`: the serial case (every row on one
    source and one destination, K = 32), a gather (every row to one
    destination), a seeded mix of pads, zero weights and repeated pairs,
    config 12's rows at K = 1, and V = :data:`PACK_HUGE_V` (turnstiles
    and state in device memory). Each equal to ``_pack_greedy_plain`` on
    the card; the calls at the two placements past shared memory run
    under ``set_sync_debug_mode("error")``."""
    from sdnmpi_tpu_torch.sched.phases import _pack_greedy_device

    g = PACK_HOLD_ROWS
    rng = np.random.default_rng(14)
    v = c12[3]
    hold_pack("serial hold", pack_rows_on(
        device, np.full(g, 7), np.full(g, 9), rng.integers(1, 65, g), v, 1), 32)
    hold_pack("gather", pack_rows_on(
        device, rng.integers(0, v, g), np.full(g, 3), rng.integers(1, 65, g), v, 2), k12)
    src = rng.integers(0, 64, g)
    dst = rng.integers(0, 64, g)
    pads = rng.random(g) < 0.1
    src[pads], dst[pads] = -1, -1
    w = np.where(rng.random(g) < 0.2, 0.0, rng.random(g) * 16)
    src[100:200], dst[100:200] = 5, 6  # one pair, repeated
    hold_pack("mix of pads, zero weights and repeated pairs",
              pack_rows_on(device, src, dst, w, v, 3), k12)
    hold_pack("config 12 at K=1", pack_rows_on(device, *c12, 4), 1)
    hold_pack_wide(device)
    vh = PACK_HUGE_V
    huge = pack_rows_on(device, rng.integers(0, vh, g), rng.integers(0, vh, g),
                        rng.integers(1, 65, g), vh, 5)
    hold_pack(f"at V={vh:,}", huge, k12)
    wide = pack_rows_on(device, rng.integers(0, PACK_WIDE_V, g),
                        rng.integers(0, PACK_WIDE_V, g), rng.integers(1, 65, g),
                        PACK_WIDE_V, 6)
    without_sync(lambda: _pack_greedy_device(*wide, PACK_WIDE_K),
                 f"S2 at V={PACK_WIDE_V:,} (state in device memory)")
    without_sync(lambda: _pack_greedy_device(*huge, k12),
                 f"S2 at V={vh:,} (turnstiles and state in device memory)")


def hold_scan_wide(device) -> None:
    """Kernel S1 on a neighbour table wider than 64 slots
    (:data:`SCAN_WIDE`), where a hop's slots span three 32-slot groups
    and its ties are dealt across them: seeded flows against
    ``route_flows_balanced_plain`` on the card, exactly."""
    import torch

    from sdnmpi_tpu_torch.oracle.congestion import route_flows_balanced
    from sdnmpi_tpu_torch.topogen.basic import random_regular

    n, deg = SCAN_WIDE
    db = random_regular(n, deg).to_topology_db(backend="torch", device=device)
    oracle = db._oracle_engine()
    t = oracle.refresh(db)
    d = t.neigh.shape[1]
    if d <= 64:
        fail(f"S1 wide hold: the neighbour table is {d} slots wide, not past 64")
    real = np.nonzero(t.host_adj().sum(axis=1) > 0)[0]
    rng = np.random.default_rng(80)
    src = rng.choice(real, SCAN_WIDE_FLOWS).astype(np.int32)
    dst = rng.choice(real, SCAN_WIDE_FLOWS).astype(np.int32)
    dist = oracle._dist_full()
    max_len = int(dist[torch.isfinite(dist)].max()) + 1
    put = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    args = (t.adj, dist, torch.zeros((t.v, t.v), dtype=torch.float32, device=device),
            put(src), put(dst), put(np.ones(SCAN_WIDE_FLOWS, np.float32)), max_len)
    kw = {"chunk": SCAN_WIDE_CHUNK, "neigh": t.neigh}
    got = route_flows_balanced(*args, **kw)
    what = f"random_regular({n}, {deg}), D={d}, {SCAN_WIDE_FLOWS:,} flows, chunk " \
           f"{SCAN_WIDE_CHUNK}"
    check_scan(args, kw, got, what)
    hold_scan_forms(args, kw, got, what, "spread")
    ms = time_ms(lambda: route_flows_balanced(*args, **kw), reps=10)
    steps = scan_work(args, kw, got)["steps"]
    log(f"S1 time ({what}, spread form): wrapper {ms:.4f} ms for {steps:,} "
        f"dependent hop steps ({ms * 1e3 / max(1, steps):.3f} us a step) ({CARD})")


def hold_scan_chain(device) -> None:
    """Kernel S1 where ``dist`` does not narrow to uint8 hop counts: a
    directed chain of :data:`SCAN_CHAIN_V` switches (diameter 299 > 254),
    flows end to end, some unreachable, at chunk 1 and in one chunk of
    16; both forms against ``route_flows_balanced_plain`` on the card,
    exactly."""
    import torch

    from sdnmpi_tpu_torch.kernels.bfs import neighbor_rows
    from sdnmpi_tpu_torch.oracle.congestion import route_flows_balanced

    n = SCAN_CHAIN_V
    adj = np.zeros((n, n), np.float32)
    adj[np.arange(n - 1), np.arange(1, n)] = 1
    gap = np.arange(n)[None, :] - np.arange(n)[:, None]
    dist = np.where(gap >= 0, gap, np.inf).astype(np.float32)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(device)  # noqa: E731
    adj_d = put(adj)
    neigh = neighbor_rows(adj_d > 0, 1)
    rng = np.random.default_rng(300)
    src16 = rng.integers(0, n, 16).astype(np.int32)
    dst16 = rng.integers(0, n, 16).astype(np.int32)
    src16[:2], dst16[:2] = 0, n - 1
    for chunk, src, dst in (
        (1, np.array([0, n - 1, 17, 0], np.int32),
         np.array([n - 1, 0, n - 2, n - 1], np.int32)),
        (16, src16, dst16),
    ):
        w = rng.integers(1, 4, len(src)).astype(np.float32)
        args = (adj_d, put(dist), torch.zeros((n, n), dtype=torch.float32, device=device),
                put(src), put(dst), put(w), n)
        kw = {"chunk": chunk, "neigh": neigh}
        got = route_flows_balanced(*args, **kw)
        what = f"directed chain of {n} switches, {len(src)} flows, chunk {chunk}"
        check_scan(args, kw, got, what)
        hold_scan_forms(args, kw, got, what, "resident")
        if int((got[0][:, n - 1] >= 0).sum()) < 1:
            fail(f"S1 {what}: no flow walked the whole chain")


def sweep_scan_forms(device, tables: list) -> None:
    """Both forms of kernel S1 timed on each fabric's tables in
    ``tables`` (``(what, TopoTensors, dist)``) over
    :data:`SCAN_SWEEP_ROWS` seeded weight-1 flows at each chunk width of
    :data:`SCAN_SWEEP_WIDTHS` (the resident form up to its thread
    count), the two forms' results equal at every width: the sweep
    that ``congestion.RESIDENT_MAX_WIDTH`` is read from."""
    import torch

    from sdnmpi_tpu_torch.oracle import congestion

    for what, t, dist in tables:
        real = np.nonzero(t.host_adj().sum(axis=1) > 0)[0]
        rng = np.random.default_rng(13)
        put = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
        src = put(rng.choice(real, SCAN_SWEEP_ROWS).astype(np.int32))
        dst = put(rng.choice(real, SCAN_SWEEP_ROWS).astype(np.int32))
        max_len = int(dist[torch.isfinite(dist)].max()) + 1
        args = (t.adj, dist, torch.zeros((t.v, t.v), dtype=torch.float32, device=device),
                src, dst, put(np.ones(SCAN_SWEEP_ROWS, np.float32)), max_len)
        rows = []
        for width in SCAN_SWEEP_WIDTHS:
            kw = {"chunk": width, "neigh": t.neigh}
            ms = {}
            outs = {}
            for form in ("resident", "spread"):
                if form == "resident" and not resident_takes(args, kw):
                    continue
                call = functools.partial(congestion.route_flows_balanced, *args, **kw,
                                         _form=form)
                outs[form] = call()
                ms[form] = time_ms(call, reps=3, warm=1)
            if len(outs) == 2 and not same_scan(outs["resident"], outs["spread"]):
                fail(f"S1 sweep ({what}, chunk {width}): the forms differ")
            steps = scan_work(args, kw, outs["spread"])["steps"]
            best = min(ms, key=ms.get)
            rows.append(
                f"chunk {width}: {steps:,} steps, "
                + ", ".join(f"{f} {x:.4f} ms ({x * 1e3 / max(1, steps):.3f} us a step)"
                            for f, x in ms.items())
                + f"; faster {best}, the rule's {scan_form_of(args, kw)}")
        log(f"S1 form sweep ({what}, V={t.v}, D={t.neigh.shape[1]}, "
            f"{SCAN_SWEEP_ROWS:,} flows; resident bytes "
            f"{congestion.resident_bytes(t.v, t.neigh.shape[1]):,}; {CARD}):")
        for row in rows:
            log(f"  {row}")


def phase_sched(device, report: dict, k: int = SCHED_K, n_ranks: int = SCHED_RANKS,
                hold_ranks: int = SCHED_HOLD_RANKS) -> list:
    """Config 12's shape (``benchmarks/config12_schedule.py``): the k=16
    fat-tree and the alltoall of the first ``n_ranks`` hosts by MAC,
    uncut. (a) The packer at the program's shape (the alltoall's edge
    groups, auto K, a seeded per-switch background): kernel S2 through
    ``pack_phases`` against ``pack_phases_host``, and on the same sorted
    rows against ``_pack_greedy_plain`` on the card and
    ``pack_phases_host``, :data:`PACK_REPEATS` calls identical, timed
    (its first step apart), clean under sync debug mode, and
    :func:`hold_pack_shapes`. (b) The
    flat balanced collective for the fractional bound. (c)
    ``routes_collective_phased`` with auto K on the adaptive policy and
    (d) on the balanced policy, whose phases route every sub-flow through
    the greedy scanner (kernel S1, chunk 1): first a ``hold_ranks``
    program (two pods: cross-pod paths through the cores), one phase's
    scanner call held against the plain version and timed, and
    :func:`hold_scan_wide`; then the full program, every phase's scanner load equal to
    ``link_loads_from_paths`` of its own paths, its device time, the
    sub-flows scanned and the time per sub-flow. Each program is checked
    with :func:`check_phased`, its wall logged, and reported as total
    discrete congestion over the flat fractional bound. (e) The same
    alltoall through the Controller with ``schedule_collectives``
    (:func:`controller_phased`) on the adaptive policy and on the
    balanced one, the Controller's default. Returns the launch counts of
    (b) to (e)."""
    import torch

    from sdnmpi_tpu_torch.oracle.congestion import (
        link_loads_from_paths,
        route_flows_balanced,
    )
    from sdnmpi_tpu_torch.sched import choose_n_phases, pack_phases, pack_phases_host
    from sdnmpi_tpu_torch.sched.phases import (
        _pack_greedy_device,
        _pack_greedy_plain,
        aggregate_groups,
    )
    from sdnmpi_tpu_torch.topogen import fattree

    spec = fattree(k)
    db = spec.to_topology_db(backend="torch", device=device)
    oracle = db._oracle_engine()
    t = oracle.refresh(db)
    all_macs = sorted(m for m, _, _ in spec.hosts)
    macs = all_macs[:n_ranks]
    src_idx, dst_idx = alltoall_idx(n_ranks)

    # (a) the packer alone
    edge, _ = oracle._resolve_endpoints_array(db, t, macs)
    _, uniq, _, _, g_src, g_dst, w = aggregate_groups(edge[src_idx], edge[dst_idx], t.v)
    n_phases = choose_n_phases(len(uniq))
    rng = np.random.default_rng(0)
    util_out = (rng.random(t.v) * 4).astype(np.float32)
    util_in = (rng.random(t.v) * 4).astype(np.float32)
    dev_ms, got = [], None
    for _ in range(3):
        t0 = time.perf_counter()
        got = pack_phases(g_src, g_dst, w, n_phases, t.v, util_out, util_in,
                          device=device)
        dev_ms.append((time.perf_counter() - t0) * 1e3)
    order = np.argsort(-w, kind="stable")
    t0 = time.perf_counter()
    host = np.empty(len(w), np.int32)
    host[order] = pack_phases_host(g_src[order], g_dst[order], w[order], util_out,
                                   util_in, n_phases)
    host_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(got, host):
        fail(f"packer: {int((got != host).sum())} of {len(w)} groups in another "
             "phase than pack_phases_host's")
    c12 = (g_src[order], g_dst[order], w[order], t.v)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(device)  # noqa: E731
    rows = tuple(put(a) for a in (*c12[:3], util_out, util_in))
    kernel_out = _pack_greedy_device(*rows, n_phases)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_out = _pack_greedy_plain(*rows, n_phases)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(kernel_out, plain_out):
        fail(f"S2: {int((kernel_out != plain_out).sum())} of {len(w)} groups differ "
             "from _pack_greedy_plain on the card")
    if not torch.equal(kernel_out.cpu(), torch.as_tensor(host[order])):
        fail("S2: the kernel's phases differ from pack_phases_host's")
    # one schedule of many: the interleaving varies, the result must not
    differ = sum(not torch.equal(_pack_greedy_device(*rows, n_phases), kernel_out)
                 for _ in range(PACK_REPEATS))
    if differ:
        fail(f"S2: {differ} of {PACK_REPEATS} repeated calls differ from the first")
    call = functools.partial(_pack_greedy_device, *rows, n_phases)
    ms = time_ms(call, reps=20)
    bare = queued_ms(call, n=20)
    profiled = device_ms(log_profile("S2 wrapper", *profile_device(call)), "pack_dataflow")
    turns = queued_ms(functools.partial(call, _turns_only=True), n=20)
    without_sync(call, "S2 at config 12 (shared memory)")
    g, v = len(w), t.v
    chain = longest_chain(*c12[:2])
    hold_pack_shapes(device, c12, n_phases)
    # the rows and the background read once, the phases written once; a
    # step scores K phases (two adds, a max, a compare) and adds twice
    report["pack_greedy"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                             "bytes": g * 16 + 2 * v * 4, "ops": g * (4 * n_phases + 2),
                             "library_ms": None}
    bound, by = bound_ms(report["pack_greedy"])
    floor = chain_floor_ms(chain)
    log(f"packer: {g:,} groups of the {n_ranks}-rank alltoall, K={n_phases}: "
        f"pack_phases on the card {', '.join(f'{x:.1f}' for x in dev_ms)} ms (median "
        f"{np.median(dev_ms):.1f}, host work included), equal to pack_phases_host "
        f"({host_ms:.1f} ms on the host); {PACK_REPEATS} repeated kernel calls identical")
    profiled = f"{profiled:.4f} ms" if profiled else "not measured"
    log(f"S2 time ({g:,} rows, V={v}, K={n_phases}; shared memory): wrapper "
        f"{ms:.4f} ms, bare {bare:.4f} ms (profiler {profiled}), of which the first "
        f"step (turns and deal) {turns:.4f} ms ({100 * turns / bare:.1f}%); longest "
        f"chain {chain} ({bare / chain * 1e6:.1f} ns a chain step); plain "
        f"{plain_ms:.1f} ms on the card, equal bit for bit; bound {bound:.5f} ms "
        f"({by}, {100 * bound / ms:.2f}% of the wrapper); chain floor {floor:.4f} ms "
        f"(an estimate: {chain} x {STEP_FLOOR_CYCLES} cycles at {H100_SM_MHZ} MHz; "
        f"{100 * floor / ms:.1f}% of the wrapper, {100 * floor / bare:.1f}% of the "
        f"bare kernel) ({CARD})")

    all_counts = []
    # (b) the flat batch's fractional bound
    def flat(these_macs, s, d):
        out = {}
        what = f"phased: flat balanced batch of {len(these_macs)} ranks"
        c = checked_launches(lambda: out.update(r=oracle.routes_collective(
            db, these_macs, s, d, "balanced")), what, report)
        want = launches_of(setup=1, k2=1)
        if c != want:
            fail(f"{what}: launches {c}, want {want}")
        return c, out["r"], oracle.last_fractional_congestion

    counts, flat_routes, frac = flat(macs, src_idx, dst_idx)
    all_counts.append(counts)
    log(f"phased: flat balanced batch of {len(src_idx):,} pairs: discrete "
        f"{flat_routes.max_congestion} against the fractional bound {frac:.3f}")

    def quality(what, program, bound):
        total = program.total_discrete_congestion()
        log(f"{what}: total discrete congestion {total} = {total / bound:.3f}x the "
            f"flat fractional bound {bound:.3f}; hottest phase "
            f"{program.max_phase_congestion()}")

    # (c) the adaptive program
    what = f"phased adaptive ({n_ranks} ranks)"
    counts, program, _ = phased_run(what, oracle, db, spec, macs, src_idx, dst_idx,
                                    "adaptive", report, want_k2=True)
    all_counts.append(counts)
    quality(what, program, frac)
    log(f"{what}: {sum(r.n_detours for r in program.reap_all())} detoured pairs")

    # (d) the scanner's program: one phase of a small one held against the
    # plain version, then the full program
    h_macs = all_macs[:hold_ranks]
    h_src, h_dst = alltoall_idx(hold_ranks)
    scans: list = []
    with recording_scanner(scans):
        counts, _, _ = phased_run(f"phased balanced ({hold_ranks} ranks)", oracle, db,
                                  spec, h_macs, h_src, h_dst, "balanced", report,
                                  want_k2=False)
    all_counts.append(counts)
    # the phase of fewest rows (the plain version runs the pads too)
    q = min(range(len(scans)), key=lambda i: scans[i][0][3].shape[0])
    args, kw, got_scan = scans[q]
    if got_scan[0].shape[1] < 5 or not bool((got_scan[0][:, 4] >= 0).any()):
        fail(f"S1 hold: no path of the {hold_ranks}-rank phase takes 4 hops; the "
             "hold must cross pods")
    what = (f"phase {q} of the {hold_ranks}-rank balanced program, chunk "
            f"{kw['chunk']}, max_len {got_scan[0].shape[1]}")
    scan_plain_ms = check_scan(args, kw, got_scan, what)
    hold_scan_forms(args, kw, got_scan, what, "resident")
    for form in ("resident", "spread"):
        without_sync(lambda: route_flows_balanced(*args, **kw, _form=form),
                     f"S1's {form} form ({what})")
    work = scan_work(args, kw, got_scan)
    clocks: list = []
    with sm_clocks(clocks):
        forms = {}
        for form in ("resident", "spread"):
            call = functools.partial(route_flows_balanced, *args, **kw, _form=form)
            forms[form] = (time_ms(call, reps=10), device_ms(log_profile(
                f"S1 {form} form", *profile_device(call)), S1_KERNELS[form]),
                queued_ms(call, n=10))
    mhz = statistics.median(clocks) if clocks else float("nan")
    ms = forms["resident"][0]
    report["route_flows_balanced"] = {
        "max_abs_err": 0.0, "ms": ms, "plain_ms": scan_plain_ms,
        "bytes": work["bytes"], "ops": work["ops"], "library_ms": None}
    bound, by = bound_ms(report["route_flows_balanced"])
    floor = work["steps"] * STEP_FLOOR_CYCLES / (mhz * 1e3)
    for form, (wrapper, bare, queued) in forms.items():
        log(f"S1 time, {form} form (phase {q} of the {hold_ranks}-rank program, "
            f"{work['flows']:,} sub-flows in {args[3].shape[0]:,} rows, chunk 1): "
            f"wrapper {wrapper:.4f} ms, {wrapper / max(1, work['flows']) * 1e3:.3f} us "
            f"a sub-flow, {per_step(wrapper, work['steps'], mhz)}; bare kernel "
            f"{f'{bare:.4f} ms' if bare else 'not measured'}; queued {queued:.4f} ms")
    log(f"S1 at that phase: {work['steps']:,} dependent hop steps ({work['moves']:,} "
        f"moves); plain {scan_plain_ms:.1f} ms; bound {bound:.5f} ms ({by}); steps x "
        f"{STEP_FLOOR_CYCLES} cycles (a per-step floor, an estimate) {floor:.4f} ms; "
        f"clocks.sm {mhz:.0f} MHz (median of {len(clocks)} readings) ({CARD})")
    del scans, args, kw, got_scan
    hold_scan_wide(device)
    hold_scan_chain(device)
    from sdnmpi_tpu_torch.topogen import dragonfly

    ddb = dragonfly(DFLY_GROUPS, DFLY_ROUTERS, hosts_per_router=1,
                    global_links=2).to_topology_db(backend="torch", device=device)
    d_oracle = ddb._oracle_engine()
    sweep_scan_forms(device, [
        ("config 12, k=16 fat-tree", t, oracle._dist_full()),
        ("config 5, dragonfly 8x32", d_oracle.refresh(ddb), d_oracle._dist_full())])
    del ddb, d_oracle

    scans = []
    what = f"phased balanced ({n_ranks} ranks)"
    with recording_scanner(scans):
        counts, program, wall = phased_run(what, oracle, db, spec, macs, src_idx,
                                           dst_idx, "balanced", report, want_k2=False)
    all_counts.append(counts)
    per_phase, n_sub, n_steps, total_ms, spread_ms = [], 0, 0, 0.0, 0.0
    clocks = []
    with sm_clocks(clocks):
        for q, (args, kw, got_scan) in enumerate(scans):
            load = link_loads_from_paths(got_scan[0], t.v, args[5])
            if not torch.equal(load, got_scan[1]):
                fail(f"{what}, phase call {q}: the scanner's load is not the load of "
                     "its own paths")
            if scan_form_of(args, kw) != "resident":
                fail(f"S1 {what}, phase call {q}: the rule does not give the resident "
                     "form")
            work = scan_work(args, kw, got_scan)
            call_ms = time_ms(lambda: route_flows_balanced(*args, **kw), reps=2, warm=1)
            # the spread form's one call (~0.8 s at 512 ranks), timed and
            # held bit-equal to the resident form's result
            wide = {}
            wide_ms = time_ms(lambda: wide.update(r=route_flows_balanced(
                *args, **kw, _form="spread")), reps=1, warm=0)
            if not same_scan(wide["r"], got_scan):
                fail(f"S1 {what}, phase call {q}: the spread form differs from the "
                     "resident form")
            per_phase.append(f"{call_ms:.1f} ms (spread form {wide_ms:.1f}) / "
                             f"{work['flows']:,} sub-flows / {work['steps']:,} steps")
            n_sub += work["flows"]
            n_steps += work["steps"]
            total_ms += call_ms
            spread_ms += wide_ms
    mhz = statistics.median(clocks) if clocks else float("nan")
    log(f"{what}: every phase's scanner load equal to link_loads_from_paths of its "
        f"own paths, both forms bit-equal; scanner device time per phase "
        f"(resident form): {'; '.join(per_phase)}; {n_sub:,} sub-flows scanned in "
        f"{total_ms:.1f} ms, {total_ms / max(1, n_sub) * 1e3:.3f} us a sub-flow, "
        f"{per_step(total_ms, n_steps, mhz)} (clocks.sm {mhz:.0f} MHz, median of "
        f"{len(clocks)} readings; {min(clocks, default=float('nan')):.0f}-"
        f"{max(clocks, default=float('nan')):.0f}); the spread form "
        f"{spread_ms:.1f} ms, {per_step(spread_ms, n_steps, mhz)}; steps x "
        f"{STEP_FLOOR_CYCLES} cycles (a per-step floor, an estimate) "
        f"{n_steps * STEP_FLOOR_CYCLES / (mhz * 1e3):.1f} ms; program wall "
        f"{wall:.1f} ms ({CARD})")
    quality(what, program, frac)
    del scans, program

    # (e) through the Controller, on both policies
    for policy in ("adaptive", "balanced"):
        all_counts.append(controller_phased(spec, device, policy, n_ranks, report))
    return all_counts


# -- phases 21 to 23: the observability and HA planes ----------------------

AUDIT_K = 16
AUDIT_PAIRS = 1536
AUDIT_SWEEPS = 5
#: eight seeded table mutations, two of each kind, and the divergence
#: kind each must be confirmed as
AUDIT_MUTATIONS = ("drop_row", "insert_row", "blackhole", "freeze") * 2
AUDIT_KINDS = {"missing": 4, "orphan": 2, "counter_dead": 2}
TRAFFIC_K = 8
TRAFFIC_PAIRS = 256
TRAFFIC_SWEEPS = 6
#: relative tolerance of the alpha = 0.5 matrix against its numpy fold,
#: four f32 units in the last place (tests/test_torch_trafficplane.py's
#: EWMA_RTOL; at 0.5 both products are exact, so bit-equal is expected)
EWMA_RTOL = 2 ** -21
CHAOS_PAIRS = 384
CHAOS_CRASHES = 5
PAIR_PAIRS = 256
PAIR_ROUNDS = 20


def random_pairs(hosts: list, n: int, seed: int) -> list:
    """``n`` distinct seeded (src, dst) host pairs, sorted."""
    if n > len(hosts) * (len(hosts) - 1):
        fail(f"{n} distinct pairs asked of {len(hosts)} hosts")
    rng = np.random.default_rng(seed)
    pairs: set = set()
    while len(pairs) < n:
        a, b = rng.choice(len(hosts), size=2, replace=False)
        pairs.add((hosts[a], hosts[b]))
    return sorted(pairs)


def wire_stack(k: int, device, **config_kw):
    """fattree(k) as a wire-mode simulated fabric under the port's
    Controller on ``device``, the benchmarks' fast-recovery knobs, the
    Monitor's flush edge published by the caller."""
    from sdnmpi_tpu_torch import Config, Controller
    from sdnmpi_tpu_torch.topogen import fattree

    fabric = fattree(k).to_fabric(wire=True)
    kw = dict(enable_monitor=False, coalesce_routes=True,
              install_retry_backoff_s=0.0, barrier_timeout_s=0.0)
    kw.update(config_kw)
    ctl = Controller(fabric, Config(device=str(device), **kw))
    ctl.attach()
    return fabric, ctl


def pump(fabric, pairs, n: int = 1) -> None:
    """``n`` data-plane frames per pair through the installed tables."""
    from sdnmpi_tpu_torch.protocol import openflow as of

    for src, dst in pairs:
        for _ in range(n):
            fabric.hosts[src].send(of.Packet(src, dst, of.ETH_TYPE_IP))


def flows_installed(fabric) -> set:
    return {(d, e.match.dl_src, e.match.dl_dst, e.actions, e.priority)
            for d, sw in fabric.switches.items() for e in sw.flow_table
            if e.match.dl_src is not None}


def flows_desired(ctl) -> set:
    from sdnmpi_tpu_torch.protocol import openflow as of

    out = set()
    for d, table in ctl.router.recovery.desired.flows.items():
        for (src, dst), spec in table.items():
            actions: tuple = (of.ActionOutput(spec.out_port),)
            if spec.rewrite:
                actions = (of.ActionSetDlDst(spec.rewrite),) + actions
            out.add((d, src, dst, actions, ctl.config.priority_default))
    return out


def one_hz():
    """A clock that advances one second per reading."""
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    return clock


def phase_audit(device, report: dict, k: int = AUDIT_K,
                n_pairs: int = AUDIT_PAIRS) -> list:
    """Config 16's shape (``benchmarks/config16_audit.py:41-44``): a k=16
    wire fat-tree (320 switches, 1,024 hosts), 1,536 routed pairs, the
    audit sweeping the whole fabric each pass. Two baseline passes, then
    eight seeded mutations (two of each kind); five passes with traffic
    must confirm each exactly once and heal it (installed == desired, no
    blackholed or frozen row left). Then one pass
    with the sentinel sampling the whole installed population: its
    padded shadow batch takes the DAG leg, one K2 set-up and one K2
    launch, each call held against the plain version. Returns the launch
    counts of the audited passes and of that sweep."""
    from sdnmpi_tpu_torch.control.faults import FaultPlan
    from sdnmpi_tpu_torch.kernels.tiling import col_bucket
    from sdnmpi_tpu_torch.utils.metrics import REGISTRY

    t0 = time.perf_counter()
    fabric, ctl = wire_stack(k, device, audit_switches_per_flush=0,
                             audit_confirm_sweeps=2)
    pairs = random_pairs(sorted(fabric.hosts), n_pairs, 0)
    ctl.router.reinstall_pairs(pairs)
    log(f"audit: fat-tree k={k}, {len(fabric.switches)} switches, "
        f"{ctl.router.recovery.desired.total():,} desired rows for {len(pairs):,} "
        f"pairs [{time.perf_counter() - t0:.1f} s]")
    div = REGISTRY.get("fabric_divergence_total")
    div0 = dict(div.values)
    heals0 = REGISTRY.get("audit_heals_total").value
    traffic = lambda: pump(fabric, pairs)  # noqa: E731
    monitor_passes(ctl, 2, "audit (baseline passes)", report, before=traffic)
    plan = FaultPlan(seed=16, mutate_priority=ctl.config.priority_default).attach(fabric)
    for kind in AUDIT_MUTATIONS:
        if plan.mutate(kind=kind) is None:
            fail(f"audit: the fault plan found no row to {kind}")
    _, planes, counts = monitor_passes(ctl, AUDIT_SWEEPS, "audit (config 16's shape)",
                                       report, before=traffic)
    # the sentinel re-scores its default sample of 64 pairs once a pass
    # through the balanced pair batch's greedy leg: S1 once, nothing else
    if counts != launches_of(scan=AUDIT_SWEEPS):
        fail(f"audit: the default-pacing passes launched {counts}, want "
             f"{launches_of(scan=AUDIT_SWEEPS)}")
    got = {kk: v - div0.get(kk, 0) for kk, v in div.values.items() if v - div0.get(kk, 0)}
    if got != AUDIT_KINDS:
        fail(f"audit: confirmed divergences {got}, want {AUDIT_KINDS}")
    installed, desired = flows_installed(fabric), flows_desired(ctl)
    if installed != desired:
        fail(f"audit: {len(installed - desired)} rows installed and not desired, "
             f"{len(desired - installed)} desired and not installed after the heal")
    for sw in fabric.switches.values():
        for e in sw.flow_table:
            if e.match.dl_src and e.cookie == 0 and (e.actions == () or e.frozen):
                fail(f"audit: a blackholed or frozen row survived on {sw.dpid}")
    named = {(r["dpid"], row) for r in ctl.audit.recent for row in r["rows"]}
    for dpid, _kind, (src, dst) in plan.mutations:
        if (dpid, f"{src}>{dst}") not in named:
            fail(f"audit: the mutation of {src}>{dst} on {dpid} was not named")
    log(f"audit: {len(plan.mutations)} mutations confirmed as {got} and healed "
        f"({REGISTRY.get('audit_heals_total').value - heals0:.0f} heal rows); "
        f"audit sweep of {len(fabric.switches)} switches {tail(planes['audit'])}; "
        f"{sum(1 for b in ctl.flight.bundles if b['trigger'] == 'fabric:divergence')} "
        "divergence bundles frozen")
    ctl.config.sentinel_sample_per_flush = 0
    n_pop = len(ctl.sentinel._population())
    _, planes, full = monitor_passes(
        ctl, 1, "sentinel sweep of the whole installed population", report,
        before=traffic)
    want = launches_of(setup=1, k2=1)
    if full != want:
        fail(f"sentinel (whole population): launches {full}, want {want}")
    last = ctl.sentinel._last
    if last.get("sampled") != n_pop or not last.get("weighted"):
        fail(f"sentinel (whole population): sweep {last} over {n_pop} pairs")
    log(f"sentinel: one sweep of all {n_pop:,} installed pairs (padded to "
        f"{col_bucket(n_pop, 4096):,}, the DAG leg) {planes['sentinel'][0]:.3f} ms, "
        f"K2 set-up 1 and K2 1 (held against the plain versions); {last}")
    drop_recorder()
    return [counts, full]


def fold(state: dict, staged: dict, alpha: float) -> None:
    """The traffic plane's flush on the host in numpy f32, keyed by cell
    name: ``old * (1 - a) + bps * a`` for staged cells (bps = bytes over
    the 1 s interval, as the plane's f32 upload casts it), a zero sample
    for silent ones, cleared at alpha 1 or past 20 silent rounds."""
    keep, gain = np.float32(1.0 - alpha), np.float32(alpha)
    for name, (old, _silent) in list(state.items()):
        if name in staged:
            continue
        if _silent + 1 > 20 or alpha >= 1.0:
            del state[name]
        else:
            state[name] = (np.float32(old * keep) + np.float32(np.float32(0.0) * gain),
                           _silent + 1)
    for name, nbytes in staged.items():
        old = state.get(name, (np.float32(0.0), 0))[0]
        bps = np.float32(nbytes / 1.0)
        state[name] = (np.float32(old * keep) + np.float32(bps * gain), 0)


def staged_names(tp) -> dict:
    names = {}
    for cell, nbytes in tp._staged.items():
        t, a, b = tp._unflat(cell)
        names[(tp._tenant_names[t], tp._ep_names[a], tp._ep_names[b])] = nbytes
    return names


def matrix_cells(tp) -> dict:
    return {(t, a, b): bps for t, a, b, bps in tp.matrix()["cells"]}


def phase_traffic(device, report: dict, k: int = TRAFFIC_K,
                  n_pairs: int = TRAFFIC_PAIRS) -> list:
    """Config 17's shape (``benchmarks/config17_traffic.py:41-43``): a
    k=8 wire fat-tree, 256 routed pairs, the audit over the whole
    fabric, the traffic plane on a 1 Hz clock. Six sweeps of pumped
    traffic: the audit sweep and the matrix flush timed; every published
    matrix equal bit for bit to a numpy fold of the same staged deltas at
    alpha = 1, and a second plane at alpha = 0.5 fed the same deltas
    within ``EWMA_RTOL`` of its fold; a published epoch unchanged by the
    next flush. Then six sentinel sweeps at the default pacing (64
    pairs: the greedy scanner, no kernel), and config 17's detection:
    a cross-pod burst confirmed within 2 flush edges of a steady replay
    that confirms nothing. Returns the launch counts of the sweeps."""
    import dataclasses

    import torch

    from sdnmpi_tpu_torch.control import events as ev
    from sdnmpi_tpu_torch.oracle.trafficplane import TrafficPlane

    fabric, ctl = wire_stack(k, device, audit_switches_per_flush=0,
                             sentinel_divergence_factor=1.5)
    pairs = random_pairs(sorted(fabric.hosts), n_pairs, 17)
    ctl.router.reinstall_pairs(pairs)
    tp = ctl.traffic
    half = TrafficPlane(tp.db, dataclasses.replace(ctl.config, traffic_ewma_alpha=0.5))
    tp.clock, half.clock = one_hz(), one_hz()
    if tp._snap.device.type != torch.device(device).type:
        fail(f"traffic: the matrix lives on {tp._snap.device}, not {device}")
    ingest = tp.ingest

    def tee(*a):
        ingest(*a)
        half.ingest(*a)

    tp.ingest = tee
    fold1: dict = {}
    fold05: dict = {}
    audit_ms, flush_ms = [], []
    worst = 0.0

    def sweeps():
        nonlocal worst
        held = None
        for i in range(TRAFFIC_SWEEPS):
            pump(fabric, pairs, 1 + i % 3)
            t0 = time.perf_counter()
            ctl.audit.sweep()
            audit_ms.append((time.perf_counter() - t0) * 1e3)
            fold(fold1, staged_names(tp), 1.0)
            fold(fold05, staged_names(half), 0.5)
            t0 = time.perf_counter()
            tp.flush()
            torch.cuda.synchronize()
            flush_ms.append((time.perf_counter() - t0) * 1e3)
            half.flush()
            if held is not None and not torch.equal(held[0], held[1]):
                fail("traffic: a published epoch changed under a later flush")
            held = (tp._snap, tp._snap.clone())
            want = {n: float(v) for n, (v, _) in fold1.items() if v > 0}
            if matrix_cells(tp) != want:
                fail(f"traffic: sweep {i}: the alpha = 1 matrix differs from its "
                     "numpy fold")
            got = matrix_cells(half)
            want = {n: float(v) for n, (v, _) in fold05.items() if v > 0}
            if got.keys() != want.keys():
                fail(f"traffic: sweep {i}: alpha = 0.5 cells differ from the fold")
            for n, v in want.items():
                worst = max(worst, abs(got[n] - v) / v)
        if worst > EWMA_RTOL:
            fail(f"traffic: alpha = 0.5 off its fold by {worst:.3e} relative")

    counts = checked_launches(sweeps, "traffic plane sweeps", report)
    log(f"traffic (config 17's shape): {len(matrix_cells(tp))} active cells; "
        f"traffic_update_ms (the flush) {tail(flush_ms)} riding an audit sweep of "
        f"{tail(audit_ms)}; the alpha = 1 matrix bit-equal to its numpy fold in "
        f"all {TRAFFIC_SWEEPS} sweeps, alpha = 0.5 within {worst:.3e} relative; "
        f"published epochs unchanged by later flushes; launches {counts}")
    tp.ingest = ingest
    sentinel_ms = []

    def sentinel_sweeps():
        for i in range(TRAFFIC_SWEEPS):
            pump(fabric, pairs)
            ctl.audit.sweep()
            tp.flush()
            t0 = time.perf_counter()
            ctl.sentinel.sweep()
            torch.cuda.synchronize()
            sentinel_ms.append((time.perf_counter() - t0) * 1e3)

    scounts = checked_launches(sentinel_sweeps, "sentinel sweeps (default pacing)", report)
    log(f"sentinel (sample {ctl.config.sentinel_sample_per_flush} of {len(pairs)}): "
        f"sentinel_sweep_ms {tail(sentinel_ms)}; last sweep {ctl.sentinel._last}; "
        f"launches {scounts}")
    drop_recorder()
    del fabric, ctl

    # config 17's detection: steady intra-edge pairs, then a cross-pod
    # burst of one edge's hosts over paths that share its first uplink
    fabric, ctl = wire_stack(k, device, audit_switches_per_flush=0,
                             sentinel_divergence_factor=1.5,
                             sentinel_sample_per_flush=0)
    ctl.traffic.clock = one_hz()
    by_edge: dict = {}
    for mac in sorted(fabric.hosts):
        by_edge.setdefault(fabric.hosts[mac].dpid, []).append(mac)
    order = sorted(by_edge)
    steady = [(h[i], h[i + 1]) for e in order[: len(order) // 2]
              for h in [by_edge[e]] for i in range(0, len(h) - 1, 2)]
    shift = [(src, by_edge[e][0]) for src in by_edge[order[0]] for e in order[-2:]]
    ctl.router.reinstall_pairs(steady + shift)

    def confirmed():
        from sdnmpi_tpu_torch.utils.metrics import REGISTRY

        return sum(dict(REGISTRY.get("sentinel_divergence_total").values).values())

    base = confirmed()
    detected = -1

    def detection():
        nonlocal detected
        for _ in range(5):
            pump(fabric, steady)
            ctl.bus.publish(ev.EventStatsFlush())
        if confirmed() != base:
            fail("traffic: the sentinel confirmed a divergence on the steady replay")
        for i in range(1, 5):
            pump(fabric, shift, 2)
            ctl.bus.publish(ev.EventStatsFlush())
            if confirmed() > base:
                detected = i
                return

    dcounts = checked_launches(detection, "sentinel detection", report)
    if not 1 <= detected <= 2:
        fail(f"traffic: the cross-pod burst was confirmed at edge {detected}, "
             "want within 2")
    detail = ctl.sentinel.recent[-1]
    log(f"sentinel detection: the burst confirmed at flush edge {detected} "
        f"(divergence {detail['divergence']:.3f}, pod pair {detail['pod_pair']}, "
        f"hot link {detail['hot_link']}); launches {dcounts}")
    drop_recorder()
    return [counts, scounts, dcounts]


def profile_kernels(path: str) -> set:
    """Names of the device kernels in a ``torch.profiler`` Chrome trace."""
    with open(path) as f:
        return {e["name"] for e in json.load(f)["traceEvents"]
                if e.get("cat") == "kernel"}


def phase_observability(device, report: dict, k: int = 8, duration: float = 1.5,
                        demo_ranks: int = 128) -> list:
    """The flight recorder, the timeline, telemetry, traceview and SLOs
    through the command line at config 14's serving shape
    (``benchmarks/config14_serving.py:55-66``): ``--topo fattree:8 --wire
    --tenants 4 --offered-rate 400 --duration 1.5 --no-route-cache``
    with ``--demo --demo-ranks 128``, an SLO on tenant0, a latency
    threshold low enough to fire, and ``--flight-dump``,
    ``--metrics-dump``, ``--trace-dump`` and ``--profile-dump``. The
    serving load blocks the launcher's event loop, so its Monitor cannot
    run during it: the phase publishes the Monitor's flush edge before
    the load (the baseline) and after it (the trigger pass), as
    ``tests/test_slo.py``'s soak does, then re-installs the demo's
    alltoall inside the incident's profile window (K2's set-up and K2
    once more, kicked off by ranks 2 and 3). A bundle must freeze and
    be dumped, the profile must
    name K2's kernel, the Prometheus text must list every instrument
    registered when it was written, and the Perfetto JSON must load with
    span slices and counter tracks. Returns the run's launch counts."""
    import shutil

    from sdnmpi_tpu_torch import launch
    from sdnmpi_tpu_torch.api.telemetry import instrument_rows
    from sdnmpi_tpu_torch.control import events as ev
    from sdnmpi_tpu_torch.topogen import host_mac
    from sdnmpi_tpu_torch.utils.metrics import REGISTRY

    out = os.path.join(OUT_DIR, "observability")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    paths = {n: os.path.join(out, n) for n in ("bundles", "metrics.txt", "trace.json",
                                                "profile")}
    argv = ["--topo", f"fattree:{k}", "--wire", "--tenants", "4", "--offered-rate",
            "400", "--duration", str(duration), "--no-rpc", "--device", str(device),
            "--no-route-cache", "--demo", "--demo-ranks", str(demo_ranks),
            "--slo-target", "tenant0:0.5", "--anomaly-latency-threshold", "0.0005",
            "--flight-dump", paths["bundles"], "--metrics-dump", paths["metrics.txt"],
            "--trace-dump", paths["trace.json"], "--profile-dump", paths["profile"]]
    real = launch.run_serving_load
    seen: dict = {}

    def bracketed(controller, fabric, args):
        controller.bus.publish(ev.EventStatsFlush())  # the baseline pass
        reports = real(controller, fabric, args)
        controller.bus.publish(ev.EventStatsFlush())  # the trigger pass
        seen["bundles"] = [b["trigger"] for b in controller.flight.bundles]
        seen["capturing"] = controller.profile_capture.active
        router = controller.router
        if len(router.collectives) != 1:
            fail(f"observability: {len(router.collectives)} collectives installed "
                 "by the demo")
        router._remove_collective(next(iter(router.collectives)))
        # a kickoff from another rank pair: the first pair's packets now
        # match the rows the first kickoff installed
        send_mpi(fabric, [host_mac(r) for r in range(args.demo_ranks)], 2, 3)
        router.flush_routes()  # the coalescer's idle edge
        if len(router.collectives) != 1:
            fail("observability: the demo's alltoall was not installed again")
        seen["timeline_rows"] = controller.timeline.n_recorded
        return reports

    launch.run_serving_load = bracketed
    try:
        counts, rec = run_launcher(argv, "observability", report, installs=2)
    finally:
        launch.run_serving_load = real
    want = launches_of(setup=2, k2=2)
    if counts != want:
        fail(f"observability: launches {counts}, want {want} (the demo's install "
             "and its re-install)")
    for r in rec["reports"].values():
        log(f"observability: {r.tenant} {r.routes_per_s:.1f} routes/s (offered "
            f"{r.offered}, completed {r.completed}), p50 {r.p50_ms:.3f} ms, p99 "
            f"{r.p99_ms:.3f} ms")
    total = sum(r.routes_per_s for r in rec["reports"].values())
    if not seen.get("bundles") or not seen.get("capturing"):
        fail(f"observability: the trigger pass froze {seen.get('bundles')} and "
             f"opened no profile window ({seen.get('capturing')})")
    dumped = sorted(os.listdir(paths["bundles"]))
    if not dumped:
        fail("observability: no bundle was dumped under --flight-dump")
    triggers = sorted({json.load(open(os.path.join(paths["bundles"], f)))["trigger"]
                       for f in dumped})
    profiles = [f for f in os.listdir(paths["profile"]) if f.endswith(".json")]
    if len(profiles) != 1:
        fail(f"observability: {len(profiles)} profile windows written")
    kernels = profile_kernels(os.path.join(paths["profile"], profiles[0]))
    k2 = sorted(n for n in kernels if "sample_slots" in n)
    if not k2:
        fail(f"observability: the incident's profile names no K2 kernel "
             f"({len(kernels)} kernels: {sorted(kernels)[:8]})")
    text = open(paths["metrics.txt"]).read()
    series = {line.split("{")[0].split(" ")[0] for line in text.splitlines()}
    # the instruments registered in this process when the run dumped its
    # registry (a labeled family renders once it has a child)
    rows = {name: getattr(inst, "label", "") for name, inst in REGISTRY}
    listed = [n for n in rows if n in series or any(
        s_.startswith(n + "_") for s_ in series)]
    unlisted = sorted(set(rows) - set(listed))
    labeled_unlisted = [n for n in unlisted if rows[n]]
    if set(unlisted) - set(labeled_unlisted):
        fail(f"observability: the Prometheus text misses {unlisted}")
    n_port = len(instrument_rows())
    with open(paths["trace.json"]) as f:
        trace = json.load(f)
    slices = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
    tracks = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "C"}
    if not slices or len(tracks) < 3:
        fail(f"observability: the Perfetto trace has {slices} slices and "
             f"{len(tracks)} counter tracks")
    log(f"observability: {total:.1f} routes/s over the 4 tenants with every plane "
        f"on and the dumps armed; the trigger pass froze {seen['bundles']}, "
        f"{len(dumped)} bundle files ({triggers}); the incident's profile names "
        f"{k2}; the Prometheus text lists {len(listed)} of the "
        f"{len(rows)} instruments registered at the dump ({len(labeled_unlisted)} "
        f"labeled families without a child: {labeled_unlisted}; the port "
        f"registers {n_port} in all); the Perfetto JSON holds "
        f"{slices} span slices and {len(tracks)} counter tracks; "
        f"{seen['timeline_rows']} timeline rows")
    rec.clear()
    collect("observability")
    return [counts]


def serving_flight_cost(device, report: dict, k: int = 8, duration: float = 1.5) -> list:
    """The flight recorder's cost on the serving path: phase 17's
    serving run (config 14's shape, the route cache on) with the
    recorder armed (the default) and with ``--no-flight-recorder``, in
    turns (armed, disarmed, disarmed, armed, armed, disarmed); routes/s
    over the 4 tenants. Returns the runs' launch counts."""
    argv = ["--topo", f"fattree:{k}", "--wire", "--tenants", "4", "--offered-rate",
            "400", "--duration", str(duration), "--no-rpc", "--device", str(device)]
    counts, totals = [], {"armed": [], "disarmed": []}
    for state in ("armed", "disarmed", "disarmed", "armed", "armed", "disarmed"):
        extra = ["--no-flight-recorder"] if state == "disarmed" else []
        c, rec = run_launcher(argv + extra, f"serving, flight recorder {state}", report)
        counts.append(c)
        ctl = rec["controller"]
        if (ctl.flight is None) != (state == "disarmed"):
            fail(f"serving: the flight recorder is not {state}")
        totals[state].append(sum(r.routes_per_s for r in rec["reports"].values()))
        rec.clear()
        collect(f"serving, flight recorder {state}")
    log("serving: routes/s over the 4 tenants with the flight recorder armed "
        f"{', '.join(f'{x:.1f}' for x in totals['armed'])}, disarmed "
        f"{', '.join(f'{x:.1f}' for x in totals['disarmed'])} (runs 1, 4 and 5 "
        "armed)")
    return counts


def phase_chaos(device, report: dict, k: int = 8, n_pairs: int = CHAOS_PAIRS) -> list:
    """Config 11's shape (``benchmarks/config11_recovery.py:40-42``): a
    k=8 wire fat-tree, 384 routed pairs on the card's oracle. One warm
    crash, then the five busiest switches crashed and redialled, each
    timed to installed == desired (the redrive wall); then 40 steps of a
    seeded FaultPlan (crashes, flaps, drops, stalls, truncations, lost
    acks) with traffic, quiesced, and the fabric must equal the desired
    store exactly. Returns the launch counts of the crashes and of the
    storm."""
    import torch

    from sdnmpi_tpu_torch.control.faults import FaultPlan
    from sdnmpi_tpu_torch.utils.metrics import REGISTRY

    fabric, ctl = wire_stack(k, device)
    pairs = random_pairs(sorted(fabric.hosts), n_pairs, 0)
    ctl.router.reinstall_pairs(pairs)
    if flows_installed(fabric) != flows_desired(ctl):
        fail("chaos: the fresh install differs from the desired store")
    by_load = sorted(fabric.switches,
                     key=lambda d: -len(fabric.switches[d].flow_table))[: CHAOS_CRASHES + 1]
    warm = by_load.pop()
    fabric.crash_switch(warm)
    fabric.redial_switch(warm)
    ctl.router.recovery_tick(time.monotonic() + 10.0)
    walls = []
    c0 = REGISTRY.get("reconcile_flows_total").value

    def crashes():
        for victim in by_load:
            t0 = time.perf_counter()
            fabric.crash_switch(victim)
            fabric.redial_switch(victim)
            ctl.router.recovery_tick(time.monotonic() + 10.0)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            if flows_installed(fabric) != flows_desired(ctl):
                fail(f"chaos: no reconvergence after crashing switch {victim}")

    counts = checked_launches(crashes, "chaos (crash and redial)", report)
    log(f"chaos (config 11's shape): {len(flows_installed(fabric))} flows; "
        f"{len(walls)} crashes of the busiest switches redriven in {tail(walls)} "
        f"(crash -> installed == desired), "
        f"{REGISTRY.get('reconcile_flows_total').value - c0:.0f} flows reconciled; "
        f"launches {counts}")
    plan = FaultPlan(seed=11, p_send_drop=0.08, p_send_stall=0.05,
                     p_send_truncate=0.04, p_ack_drop=0.05, p_stats_delay=0.15,
                     p_crash=0.06, p_redial=0.4, p_flap=0.10, p_restore=0.5,
                     p_release=0.5, max_crashed=3).attach(fabric)
    rng = np.random.default_rng(11)
    hosts = sorted(fabric.hosts)
    from sdnmpi_tpu_torch.control import events as ev

    def storm():
        for step in range(40):
            plan.step()
            for _ in range(3):
                a, b = rng.choice(len(hosts), size=2, replace=False)
                if (fabric.hosts[hosts[a]].dpid in fabric.switches
                        and fabric.hosts[hosts[b]].dpid in fabric.switches):
                    pump(fabric, [(hosts[a], hosts[b])])
            ctl.bus.publish(ev.EventStatsFlush())
            fabric.tick(float(step))
        plan.quiesce()
        for _ in range(1 + int(ctl.config.install_retry_max) * 2):
            fabric.release_stalls()
            ctl.bus.publish(ev.EventStatsFlush())

    t0 = time.perf_counter()
    scounts = checked_launches(storm, "chaos (seeded fault plan)", report)
    if flows_installed(fabric) != flows_desired(ctl):
        fail("chaos: after quiesce the fabric differs from the desired store")
    if plan.counts["crash"] == 0:
        fail(f"chaos: the fault plan crashed nothing ({plan.counts})")
    log(f"chaos: 40 seeded fault steps {plan.counts} and quiesce in "
        f"{time.perf_counter() - t0:.1f} s; installed == desired exactly; "
        f"launches {scounts}")
    drop_recorder()
    return [counts, scounts]


def phase_pair(device, report: dict, k: int = 8, n_pairs: int = PAIR_PAIRS) -> list:
    """Config 18's shape (``benchmarks/config18_failover.py:38-40``): a
    controller pair over a k=8 wire fat-tree on a LoopLink, both on the
    card's oracle, 256 pairs replicated; 20 storm rounds of 16 fresh
    pairs (the replication lag sampled after each burst), then
    controller 0 killed: lease expiry to installed == desired under the
    survivor (the failover reconverge wall). Returns the launch counts
    of the storm and of the failover."""
    import torch

    from sdnmpi_tpu_torch import Config
    from sdnmpi_tpu_torch.control import events as ev
    from sdnmpi_tpu_torch.control.replica import build_pair
    from sdnmpi_tpu_torch.topogen import fattree

    fabric = fattree(k).to_fabric(wire=True)
    clock_t = [0.0]
    cfg = Config(device=str(device), enable_monitor=False, coalesce_routes=True,
                 audit_switches_per_flush=0, install_retry_backoff_s=0.0,
                 barrier_timeout_s=0.0)
    pair = build_pair(fabric, cfg, clock=lambda: clock_t[0])
    pair.attach()

    def tick(n=3):
        for _ in range(n):
            clock_t[0] += 1.0
            for i, c in enumerate(pair.controllers):
                if i not in pair.mux.dead:
                    c.replica.tick()

    hosts = sorted(fabric.hosts)
    pairs = random_pairs(hosts, n_pairs, 18)
    for c in pair.controllers:
        c.router.reinstall_pairs(pairs)
    tick()
    if flows_installed(fabric) != flows_desired(pair.controllers[0]):
        fail("pair: the replicated install differs from the desired store")
    rng = np.random.default_rng(181)
    installed = set(pairs)
    lags: list = []

    if len(pairs) + 16 * PAIR_ROUNDS > len(hosts) * (len(hosts) - 1):
        fail(f"pair: {PAIR_ROUNDS} rounds of 16 fresh pairs do not fit {len(hosts)} hosts")

    def storm():
        for _ in range(PAIR_ROUNDS):
            burst = []
            while len(burst) < 16:
                a, b = rng.choice(len(hosts), size=2, replace=False)
                p = (hosts[a], hosts[b])
                if p not in installed:
                    installed.add(p)
                    burst.append(p)
            for c in pair.controllers:
                c.router.reinstall_pairs(burst)
            for c in pair.controllers:
                c.replica.tick()
            lags.extend(c.replica.status()["lag"] for c in pair.controllers)
            tick(2)

    counts = checked_launches(storm, "pair (storm rounds)", report)
    pair.kill(0)
    surv = pair.controllers[1]
    n_before = len(surv.router.dps)
    clock_t[0] += surv.config.replica_lease_timeout_s + 1.0
    wall = [0.0]

    def failover():
        t0 = time.perf_counter()
        surv.replica.tick()
        deadline = time.perf_counter() + 120.0
        while time.perf_counter() < deadline:
            clock_t[0] += surv.config.replica_adopt_backoff_s
            surv.replica.tick()
            fabric.release_stalls()
            surv.bus.publish(ev.EventStatsFlush())
            if flows_installed(fabric) == flows_desired(surv):
                break
        torch.cuda.synchronize()
        wall[0] = (time.perf_counter() - t0) * 1e3

    fcounts = checked_launches(failover, "pair (failover)", report)
    if flows_installed(fabric) != flows_desired(surv):
        fail("pair: the survivor never reconverged")
    adopted = len(surv.router.dps) - n_before
    if adopted <= 0:
        fail("pair: the survivor adopted nothing")
    log(f"pair (config 18's shape): replication lag over {len(lags)} storm "
        f"samples p99 {np.percentile(lags, 99):.1f} batches (max {max(lags)}); "
        f"failover reconverge {wall[0]:.1f} ms (lease expiry -> installed == "
        f"desired, {adopted} switches adopted, ownership "
        f"{surv.ownership.to_dict()['epoch']}); launches {counts}, {fcounts}")
    drop_recorder()
    return [counts, fcounts]


# -- phase 24: the hierarchical two-level oracle ----------------------------

#: config 15 (benchmarks/config15_hier.py:43-47): fattree(64, pods=1008),
#: 65,536 switches and one host per edge switch, 128 ranks strided over
#: the hosts (16,256 pairs), the hierarchy on 8 shards of one card with
#: the ring (kernel K3) moving the border plane
HIER_K = 64
HIER_PODS = 1008
HIER_RANKS = 128
#: the refresh twin (15b): the config-13 pod shape, fat-tree k=56, and
#: the ranks of its dense-length check
HIER_TWIN_K = 56
HIER_TWIN_RANKS = 256
#: the Controller and launcher legs: a k=8 fat-tree, 128 ranks
HIER_CTL_K = 8
HIER_CTL_RANKS = 128
#: per-shard headroom over the dense [V, V] f32 plane that the
#: reference's config 15 asserts (MEM_HEADROOM_MIN)
HIER_HEADROOM_MIN = 8.0
#: border-plane rows held against the host sweep
HIER_ROW_SAMPLE = 16
HIER_COUNTERS = ("hier_block_repairs_total", "hier_l2_refreshes_total",
                 "hier_full_builds_total")


@contextlib.contextmanager
def hier_programs(record: dict):
    """Count the calls of the hier oracle's three device programs (the
    reference's three jitted programs: ``shardplane.hier._stack_apsp_core``,
    ``_sweep_core`` and ``kernels.hiercompose._compose_core``) while the
    context is open, sum the row-sweeps ``_sweep_core`` runs, and keep the
    arguments of the largest composition for :func:`time_hier_programs`."""
    from sdnmpi_tpu_torch.kernels import hiercompose
    from sdnmpi_tpu_torch.shardplane import hier as shier

    where = {"_stack_apsp_core": shier, "_sweep_core": shier,
             "_compose_core": hiercompose}
    real = {name: getattr(mod, name) for name, mod in where.items()}

    def wrapped(name):
        def call(*args):
            out = real[name](*args)
            record[name] = record.get(name, 0) + 1
            if name == "_sweep_core":
                record["row_sweeps"] = record.get("row_sweeps", 0) + out
            elif name == "_compose_core":
                size = args[1].numel() * args[2].shape[1]
                if size > record.get("compose_size", -1):
                    record.update(compose_size=size, compose_args=args)
            return out
        return call

    for name, mod in where.items():
        setattr(mod, name, wrapped(name))
    try:
        yield record
    finally:
        for name, mod in where.items():
            setattr(mod, name, real[name])


def time_hier_programs(state, record: dict) -> list:
    """The hier oracle's device programs timed with CUDA events at the
    main path's shapes on ``state``: the pod-stack APSP of each bucket
    (every shard's call), the row sweeps of the materialized destination
    pods' borders (every shard's call, the padded ladder included) and
    the largest composition chunk ``record`` kept; each beside its bound
    (bytes: inputs read once, outputs written once; operations: what this
    data needs). Returns the table's rows."""
    import torch

    from sdnmpi_tpu_torch.kernels import hiercompose
    from sdnmpi_tpu_torch.shardplane import hier as shier

    mesh = state.mesh
    shards = mesh.n_shards
    rows = []
    for b in state.buckets:
        n, s = len(b.pods), b.s
        finite = b.dist[np.isfinite(b.dist)]
        iters = int(finite.max()) + 1 if finite.size else 1
        rows.append({
            "name": "_stack_apsp_core", "shape": f"[{n}, {s}, {s}] "
            f"({'one call a shard' if n >= shards else 'one call'})",
            "ms": time_ms(lambda: torch.cuda.synchronize(
                shier.pod_stack_apsp_async(b.adj, mesh)[0][0].device), reps=5),
            "bytes": n * s * s * 12, "ops": iters * 2 * n * s ** 3 + n * s ** 3,
        })
    targets = np.concatenate([np.arange(state.pod_bstart[p], state.pod_bstart[p + 1])
                              for p in sorted(state.rows)]).astype(np.int32)
    t = len(targets)
    tloc = np.concatenate([targets, np.full(shier._ladder(t, shards) - t, -1, np.int32)])
    sweep: dict = {}
    with hier_programs(sweep):
        shier._sweep_local(state.deg_buckets, state.n_borders, tloc, mesh)
    per_row = sum(int(np.asarray(c).size) for _, c, _ in state.deg_buckets)
    ms = time_ms(lambda: shier._sweep_local(state.deg_buckets, state.n_borders, tloc,
                                            mesh), reps=3)
    rows.append({
        "name": "_sweep_core", "shape": f"[{len(tloc)}, {state.n_borders}] rows "
        f"({t} real), {per_row:,} gathers a row, "
        f"{sweep['row_sweeps'] / len(tloc):.2f} sweeps a row",
        # out [rows, B] f32 written, targets read, and per bucket the
        # int64 candidates, f32 weights and int64 border ids read once
        "ms": ms, "bytes": len(tloc) * (state.n_borders * 4 + 4) + sum(
            int(np.asarray(c).size) * 12 + len(i) * 8 for i, c, _ in state.deg_buckets),
        "ops": sweep["row_sweeps"] * per_row * 2,
    })
    if "compose_args" in record:
        args = record["compose_args"]
        m, bb = args[1].shape
        ba = args[2].shape[1]
        rows.append({
            "name": "_compose_core", "shape": f"m={m}, bA={ba}, bB={bb}",
            "ms": time_ms(lambda: hiercompose._compose_core(*args), reps=10),
            "bytes": m * ba * bb * 4 + m * (ba + bb) * (8 + 8) + m * 8,
            "ops": m * ba * bb * 5,
        })
    for r in rows:
        r["bound_ms"], r["bound_by"] = bound_ms(r)
    return rows


def hier_counters() -> list:
    from sdnmpi_tpu_torch.utils.metrics import REGISTRY

    return [REGISTRY.get(n).value for n in HIER_COUNTERS]


def check_hier_routes(db, macs, src_idx, dst_idx, routes, what: str) -> None:
    """Every pair routed (the fabric is connected), every fdb over live
    links with their ports from its source's switch to its destination
    host's port (the reference's ``validate_routes``, on every pair)."""
    if not routes.routed_mask().all():
        fail(f"{what}: unrouted pairs on a connected fabric")
    for kk in range(routes.n_pairs):
        fdb = routes.fdb(kk)
        src = db.hosts[macs[int(src_idx[kk])]].port
        dst = db.hosts[macs[int(dst_idx[kk])]].port
        if not fdb or fdb[0][0] != src.dpid or fdb[-1] != (dst.dpid, dst.port_no):
            fail(f"{what}: pair {kk} does not join its hosts: {fdb}")
        for (a, pa), (b, _) in zip(fdb, fdb[1:]):
            link = db.links.get(a, {}).get(b)
            if link is None or link.src.port_no != pa:
                fail(f"{what}: pair {kk} leaves {a} by port {pa} toward {b}")
    log(f"{what}: all {routes.n_pairs:,} pairs routed over live links")


def check_hier_ring(state, what: str) -> int:
    """K3 on every bucket's border-plane wire blocks equals its plain
    version, and the unpacked plane equals the host slice of the pod
    blocks; returns the buckets held."""
    from sdnmpi_tpu_torch.kernels.ring import unpack_dist_wire
    from sdnmpi_tpu_torch.shardplane.hier import border_plane_blocks

    held = 0
    for bi, b in enumerate(state.buckets):
        blocks, counts, bmax = border_plane_blocks(state, b)
        if not bmax:
            continue
        got = check_k3(blocks, state.mesh, f"{what} bucket {bi}")
        plane = unpack_dist_wire(got[0][:len(b.pods)]).cpu().numpy().reshape(
            len(b.pods), bmax, b.s)
        for i, p in enumerate(b.pods):
            lo = int(state.pod_bstart[p])
            bl = state.border_local[lo:lo + int(counts[i])]
            if not np.array_equal(plane[i, :len(bl)], b.dist[i][bl, :]):
                fail(f"{what}: K3's border plane differs from the host slice "
                     f"(bucket {bi}, pod {p})")
        log(f"{what}: K3 on bucket {bi} ({len(b.pods)} pods of {b.s}, "
            f"{len(blocks)} shards, {blocks[0].dtype} wire) equal to the plain "
            "version and to the host slice")
        held += 1
    return held


def hier_state_digests(state) -> dict:
    """Digests of a hier state: its pod blocks (every bucket's host
    distances and next hops) and its level 2 (the border numbering and
    the skeleton's candidate table, built from the border plane)."""
    return {
        "pod blocks": digest(*(a for b in state.buckets for a in (b.dist, b.nxt))),
        "level 2": digest(state.pod_bstart, state.border_local, state.cstart,
                          state.ccand, state.cw, state.cport),
    }


def hier_plane_digest(state) -> str:
    """Digest of the border plane as the ring exchanges it (K3 once per
    bucket)."""
    from sdnmpi_tpu_torch.shardplane.hier import ring_exchange_border_plane

    planes = ring_exchange_border_plane(state)
    return digest(*(planes[i] for i in sorted(planes)))


def hier_route_digest(routes) -> str:
    return digest(*(np.asarray(getattr(routes, key)) for key in (
        "pair_sub", "final_port", "hop_dpid", "hop_port", "hop_len")))


def intra_pod_cable(spec):
    """The first cable of ``spec`` inside one pod."""
    pm = spec.podmap
    return next(c for c in spec.links if pm.pod_of[c[0]] == pm.pod_of[c[2]])


def flip_cable(db, cable, add: bool) -> None:
    """Add or delete both directions of ``cable`` (a, port, b, port)."""
    from sdnmpi_tpu_torch.core.topology_db import Link, Port

    a, pa, b, pb = cable
    for x, px, y, py in ((a, pa, b, pb), (b, pb, a, pa)):
        link = Link(Port(x, px), Port(y, py))
        (db.add_link if add else db.delete_link)(link)


def same_routes(a, b, what: str) -> None:
    for key in ("pair_sub", "final_port", "hop_dpid", "hop_port", "hop_len"):
        if not np.array_equal(np.asarray(getattr(a, key)), np.asarray(getattr(b, key))):
            fail(f"{what}: {key} differs")
    if a.fdbs() != b.fdbs():
        fail(f"{what}: fdbs differ")


def phase_hier(device, report: dict, k: int = HIER_K, pods: int = HIER_PODS,
               n_ranks: int = HIER_RANKS, twin_k: int = HIER_TWIN_K,
               twin_ranks: int = HIER_TWIN_RANKS, ctl_k: int = HIER_CTL_K,
               ctl_ranks: int = HIER_CTL_RANKS, shards: int = N_SHARDS) -> list:
    """Config 15 through the hierarchical oracle on the card (see the
    module docstring, phase 24). Returns the launch counts of its legs."""
    import torch

    from sdnmpi_tpu_torch.oracle.hier import HierOracle, sweep_rows_host
    from sdnmpi_tpu_torch.shardplane.hier import hier_device_bytes
    from sdnmpi_tpu_torch.topogen import fattree

    what = f"config 15 (fattree({k}, pods={pods}))"
    programs: dict = {}
    legs: list = []
    summary: dict = {}

    def leg(fn, name: str, k3_min: int = 0, step_min: int = 0) -> dict:
        """One counted leg: its launches, held (no K1, no K2; K3 at least
        ``k3_min``, its step form at least ``step_min``), and the device
        programs' calls."""
        with hier_programs(programs):
            counts = path_launches(fn)
        if counts["bfs_distances"] or counts["sampler_tables"] or counts["sample_slots"]:
            fail(f"{name}: the hierarchy launched K1 or K2: {counts}")
        if counts["ring_all_gather"] < k3_min:
            fail(f"{name}: K3 launched {counts['ring_all_gather']} times, want at "
                 f"least {k3_min}")
        if counts["ring_step"] < step_min:
            fail(f"{name}: K3's step form launched {counts['ring_step']} times, "
                 f"want at least {step_min}")
        legs.append(counts)
        return counts

    def timed(fn, out: dict, key: str):
        def run():
            t0 = time.perf_counter()
            out[key + "_result"] = fn()
            torch.cuda.synchronize()
            out[key] = (time.perf_counter() - t0) * 1e3
        return run

    # (a) the primary: build, cold refresh, first and steady routes
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    spec = fattree(k, pods=pods, hosts_per_edge=1)
    db = spec.to_topology_db(device=device, hier_oracle=True, mesh_devices=shards,
                             ring_exchange=True)
    summary["db_build_s"] = time.perf_counter() - t0
    hosts = sorted(db.hosts)
    macs = hosts[::max(1, len(hosts) // n_ranks)][:n_ranks]
    si, di = alltoall_idx(len(macs))
    oracle = db._oracle_engine()

    def route(o=None):
        if o is None:
            return db.find_routes_collective(macs, si, di, policy="shortest")
        return o.routes_collective(db, macs, si, di, "shortest")

    out: dict = {}
    c = leg(timed(lambda: oracle.refresh(db), out, "refresh_ms"), "cold refresh", 1)
    state = out["refresh_ms_result"]
    # what phase 28's processes must reproduce, bit for bit
    digests = hier_state_digests(state)
    digests["border plane"] = hier_plane_digest(state)
    log(f"{what}: V={state.v:,} pods={state.n_pods} borders={state.n_borders:,} "
        f"buckets {[(len(b.pods), b.s) for b in state.buckets]}; DB built in "
        f"{summary['db_build_s']:.1f} s, cold refresh {out['refresh_ms']:.1f} ms, "
        f"launches {c}")
    leg(timed(route, out, "first_ms"), "first route")
    routes = out["first_ms_result"]
    steady = []
    for _ in range(3):
        leg(timed(route, out, "steady"), "steady route")
        steady.append(out["steady"])
    check_hier_routes(db, macs, si, di, routes, what)
    digests["first route"] = hier_route_digest(routes)
    digests["steady route"] = hier_route_digest(out["steady_result"])
    # where a steady route's time goes: the device's busy share, the host's
    # functions
    log_profile(f"{what}: steady route", *profile_device(route))
    log_host_profile(f"{what}: steady route", route)
    summary.update(refresh_ms=out["refresh_ms"], first_route_ms=out["first_ms"],
                   steady_route_ms=statistics.median(steady),
                   n_pairs=int(len(si)), v=state.v, pods=state.n_pods,
                   borders=state.n_borders)
    check_hier_ring(state, what)
    per_shard = hier_device_bytes(state, state.mesh)
    dense = state.v * state.v * 4
    if per_shard * HIER_HEADROOM_MIN >= dense:
        fail(f"{what}: {per_shard:,} B a shard is not {HIER_HEADROOM_MIN}x under the "
             f"dense plane's {dense:,} B")
    summary.update(per_shard_bytes=per_shard, dense_plane_bytes=dense,
                   headroom=dense / per_shard)
    log(f"{what}: first route {out['first_ms']:.1f} ms, steady {tail(steady)}; "
        f"{per_shard:,} device bytes a shard ({shards} shards) against the dense "
        f"plane's {dense:,} B ({dense / per_shard:.1f}x)")
    # (f) the device programs at the main path's shapes, timed here while
    # the plane holds the first route's rows
    program_rows = time_hier_programs(state, programs)

    # (b) the serving twin: warm_serving, the scalar escape hatch, a
    # border snapshot restored into a fresh oracle
    leg(timed(lambda: db.warm_serving(), out, "warm_ms"), "warm_serving")
    ws = out["warm_ms_result"]
    leg(timed(route, out, "warm_first_ms"), "first route after warm_serving")
    routes_w = out["warm_first_ms_result"]
    warm_steady = []
    for _ in range(3):
        leg(timed(route, out, "steady"), "steady route after warm_serving")
        warm_steady.append(out["steady"])
    oracle.fused = False
    scalar = []
    for _ in range(2):
        leg(timed(route, out, "scalar"), "steady route, scalar escape hatch")
        scalar.append(out["scalar"])
    routes_s = out["scalar_result"]
    oracle.fused = True
    t0 = time.perf_counter()
    snap = oracle.border_snapshot(db)
    snap_s = time.perf_counter() - t0
    fresh = HierOracle(mesh_devices=shards, ring_exchange=True, device=device)
    leg(timed(lambda: fresh.restore_border_rows(snap, db), out, "restore_ms"),
        "border restore into a fresh oracle", 1)
    leg(timed(lambda: route(fresh), out, "restored_first_ms"),
        "first route after the restore")
    routes_r = out["restored_first_ms_result"]
    same_routes(routes_w, routes_s, f"{what}: fused against the scalar escape hatch")
    same_routes(routes_w, routes_r, f"{what}: fused against the restored plane")
    same_routes(routes_w, routes, f"{what}: after warm_serving against before")
    plane_rows = {p: r for p, r in state.rows.items()}
    rng = np.random.default_rng(24)
    pods_h = rng.choice(sorted(plane_rows), HIER_ROW_SAMPLE)
    targets = np.array([int(state.pod_bstart[p]) + int(rng.integers(
        int(state.pod_bstart[p + 1] - state.pod_bstart[p]))) for p in pods_h], np.int64)
    host = sweep_rows_host(state.deg_buckets, state.n_borders, targets)
    for j, tgt in enumerate(targets):
        p = int(state.border_pod[tgt])
        row = state.rows_d[p][int(tgt - state.pod_bstart[p])].cpu().numpy()
        if not np.array_equal(row, host[j]):
            fail(f"{what}: the card's border row of border {tgt} differs from "
                 "sweep_rows_host")
    summary.update(warm_ms=out["warm_ms"], warm_compiled=ws["compiled"],
                   warm_first_ms=out["warm_first_ms"],
                   warm_steady_ms=statistics.median(warm_steady),
                   scalar_steady_ms=scalar[-1], snapshot_s=snap_s,
                   restore_ms=out["restore_ms"],
                   restored_rows=out["restore_ms_result"],
                   restored_first_ms=out["restored_first_ms"])
    log(f"{what}: warm_serving {out['warm_ms']:.1f} ms ({ws['compiled']} rungs, "
        f"{state.plane_len:,} border rows), first route after it "
        f"{out['warm_first_ms']:.1f} ms, steady {tail(warm_steady)}; scalar escape "
        f"hatch {scalar[-1]:.1f} ms; snapshot {snap_s:.1f} s, restore of "
        f"{out['restore_ms_result']:,} rows into a fresh oracle "
        f"{out['restore_ms']:.1f} ms, its first route {out['restored_first_ms']:.1f} ms; "
        f"fused == scalar == restored over {routes_w.n_pairs:,} pairs; "
        f"{HIER_ROW_SAMPLE} card rows equal to sweep_rows_host")
    del fresh, snap, routes_s, routes_r
    summary["max_memory_allocated"] = torch.cuda.max_memory_allocated()

    # (d) churn: one intra-pod and one inter-pod flap, each beside a cold
    # rebuild of the flapped fabric and back to the original routes
    pm = spec.podmap
    core = pm.n_pods - 1
    intra = intra_pod_cable(spec)
    inter = next(c for c in spec.links
                 if (pm.pod_of[c[0]] == core) != (pm.pod_of[c[2]] == core))

    def flip(cable, add: bool) -> None:
        flip_cable(db, cable, add)

    for name, cable, want in (("intra-pod", intra, [1, 1, 0]),
                              ("inter-pod", inter, [0, 1, 0])):
        v0 = hier_counters()
        flip(cable, add=False)
        leg(timed(lambda: oracle.refresh(db), out, "flap_refresh"),
            f"{name} flap refresh", 1)
        leg(timed(route, out, "flap_route"), f"{name} flap route")
        if name == "intra-pod":
            digests.update({f"{key} after the flap": value for key, value in
                            hier_state_digests(out["flap_refresh_result"]).items()})
            digests["route after the flap"] = hier_route_digest(out["flap_route_result"])
        moved = [b - a for a, b in zip(v0, hier_counters())]
        if moved != want:
            fail(f"{what}: a {name} flap moved {dict(zip(HIER_COUNTERS, moved))}, "
                 f"want {dict(zip(HIER_COUNTERS, want))}")
        cold = HierOracle(mesh_devices=shards, ring_exchange=True, device=device)
        leg(timed(lambda: cold.refresh(db), out, "cold_refresh"),
            f"{name} cold rebuild", 1)
        leg(timed(lambda: route(cold), out, "cold_route"), f"{name} cold route")
        same_routes(out["flap_route_result"], out["cold_route_result"],
                    f"{what}: {name} flap repaired against a cold rebuild")
        del cold
        flip(cable, add=True)
        leg(timed(lambda: oracle.refresh(db), out, "back_refresh"),
            f"{name} restored-link refresh", 1)
        leg(timed(route, out, "back_route"), f"{name} restored-link route")
        same_routes(out["back_route_result"], routes_w,
                    f"{what}: {name} link restored against the original routes")
        summary[f"{name}_refresh_ms"] = out["flap_refresh"]
        summary[f"{name}_cold_refresh_ms"] = out["cold_refresh"]
        summary[f"{name}_route_ms"] = out["flap_route"]
        summary[f"{name}_back_refresh_ms"] = out["back_refresh"]
        log(f"{what}: {name} flap {cable}: repair refresh {out['flap_refresh']:.1f} ms "
            f"(cold rebuild {out['cold_refresh']:.1f} ms), route "
            f"{out['flap_route']:.1f} ms, counters {dict(zip(HIER_COUNTERS, moved))}; "
            f"routes equal to the cold rebuild's; link back: refresh "
            f"{out['back_refresh']:.1f} ms, routes equal to the original")
    del db, oracle, state, routes, routes_w, plane_rows, spec
    collect("config 15")

    # (c) the refresh twin (15b): the dense sharded refresh (K3) beside
    # the full hier build with every border row, at k=56
    twin = fattree(twin_k)
    wt = f"refresh twin (fattree({twin_k}))"
    dense_db = twin.to_topology_db(device=device, mesh_devices=shards,
                                   shard_oracle=True, ring_exchange=True)
    leg(timed(lambda: dense_db._oracle_engine().refresh(dense_db), out, "dense_ms"),
        f"{wt} dense sharded refresh", step_min=1)
    hier_db = twin.to_topology_db(device=device, hier_oracle=True, mesh_devices=shards,
                                  ring_exchange=True)
    one_db = twin.to_topology_db(device=device, hier_oracle=True)

    def full_build(db):
        st = db._oracle_engine().refresh(db)
        st.ensure_rows(range(st.n_pods))
        return st

    leg(timed(lambda: full_build(hier_db), out, "hier_ms"), f"{wt} full hier build", 1)
    st_mesh = out["hier_ms_result"]
    leg(timed(lambda: full_build(one_db), out, "one_ms"),
        f"{wt} full hier build, one device")
    st_one = out["one_ms_result"]
    for p, r in st_one.rows.items():
        if not np.array_equal(st_mesh.rows[p], r):
            fail(f"{wt}: border rows of pod {p} differ between the mesh and one device")
    thosts = sorted(m for m, _, _ in twin.hosts)
    tmacs = thosts[::max(1, len(thosts) // twin_ranks)][:twin_ranks]
    tsi, tdi = alltoall_idx(len(tmacs))
    leg(timed(lambda: hier_db.find_routes_collective(tmacs, tsi, tdi, policy="shortest"),
              out, "twin_route"), f"{wt} hier route, mesh and ring")
    leg(timed(lambda: one_db.find_routes_collective(tmacs, tsi, tdi, policy="shortest"),
              out, "twin_one"), f"{wt} hier route, one device")
    check_routes(f"{wt}: hier lengths against the dense oracle", twin, dense_db, tmacs,
                 tsi, tdi, out["twin_route_result"])
    same_routes(out["twin_route_result"], out["twin_one_result"],
                f"{wt}: hier on the mesh with the ring against one device")
    summary.update(twin_dense_refresh_ms=out["dense_ms"], twin_hier_build_ms=out["hier_ms"],
                   twin_one_device_build_ms=out["one_ms"], twin_borders=st_mesh.n_borders,
                   twin_pairs=int(len(tsi)))
    log(f"{wt}: dense sharded refresh {out['dense_ms']:.1f} ms, full hier build "
        f"({st_mesh.n_borders:,} border rows) {out['hier_ms']:.1f} ms on the mesh, "
        f"{out['one_ms']:.1f} ms on one device; hier == dense lengths over "
        f"{len(tsi):,} pairs; mesh == one device")
    del dense_db, hier_db, one_db, st_mesh, st_one
    collect("refresh twin")

    # (e) the Controller and the launcher under hier_oracle, at k=8
    cspec = fattree(ctl_k)
    ranks = sorted(m for m, _, _ in cspec.hosts)[:ctl_ranks]
    installs = {}
    for hier in (False, True):
        fabric, ctl, installed = controller_stack(cspec, device, hier_oracle=hier)
        launch_ranks(fabric, ranks)
        if hier:
            leg(lambda: send_mpi(fabric, ranks, 0, 1), "hier controller block install")
        else:  # the dense controller is the yardstick: its launches count nowhere
            send_mpi(fabric, ranks, 0, 1)
        colls = list(ctl.router.collectives)
        if len(colls) != 1 or len(installed) != 1:
            fail(f"controller, hier_oracle={hier}: {len(colls)} collectives installed")
        installs[hier] = (fabric, ctl, colls[0])
    dense_ctl = installs[False][1]
    fabric, ctl, inst = installs[True]
    ref = installs[False][2]
    if (inst.n_pairs, inst.n_flows) != (ref.n_pairs, ref.n_flows):
        fail(f"hier controller: {inst.n_pairs} pairs in {inst.n_flows} flows, the dense "
             f"controller {ref.n_pairs} in {ref.n_flows}")
    check_block_paths(ctl, "hier controller", dense=dense_ctl)
    pairs = np.random.default_rng(8).integers(0, len(ranks), (200, 2))
    pairs = [(int(s), int(d)) for s, d in pairs if s != d]
    deliver_pairs(fabric, ranks, pairs, "hier controller")
    log(f"hier controller: {inst.n_pairs:,} pairs block-installed in {inst.n_flows:,} "
        f"flows, as the dense controller; {len(pairs)} pairs delivered")
    del installs, fabric, ctl, dense_ctl, inst, ref
    collect("hier controller")
    counts_l, rec = run_launcher(
        ["--topo", f"fattree:{ctl_k}", "--no-rpc", "--duration", "0.1", "--device",
         str(device), "--hier-oracle", "--demo", "--demo-ranks", str(ctl_ranks)],
        "hier launcher demo", report)
    colls = list(rec["controller"].router.collectives)
    if len(colls) != 1 or colls[0].n_pairs != ctl_ranks * (ctl_ranks - 1):
        fail(f"hier launcher demo: {[c.n_pairs for c in colls]} pairs installed")
    if not isinstance(rec["controller"].topology_manager.topologydb._oracle, HierOracle):
        fail("hier launcher demo: the launch did not build the hierarchical oracle")
    if counts_l["bfs_distances"] or counts_l["sampler_tables"] or counts_l["sample_slots"]:
        fail(f"hier launcher demo: the hierarchy launched K1 or K2: {counts_l}")
    legs.append(counts_l)
    log(f"hier launcher demo: start -> demo flows installed "
        f"{logged_at(rec, 'demo:'):.2f} s; launches {counts_l}")
    rec.clear()
    collect("hier launcher")

    # (f) the device programs' calls on every counted leg above
    for r in program_rows:
        r["launches"] = programs.get(r["name"], 0)
        log(f"hier program {r['name']} {r['shape']}: {r['ms']:.4f} ms; "
            f"{r['launches']} calls on the counted legs; bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}: {r['bytes']:,} B, {r['ops']:,} ops)")
    summary["programs"] = [{key: r[key] for key in ("name", "shape", "ms", "launches",
                                                     "bound_ms", "bound_by")}
                           for r in program_rows]
    summary["k3_launches"] = sum(c["ring_all_gather"] for c in legs)
    programs.clear()
    report["hier digests"] = digests
    log("phase 24 summary: " + json.dumps(summary))
    return legs


# -- phase 25: the remaining sharded legs (config 13, 8 shards) -------------

#: host pairs of phase 25's unicast window (past the host chase's budget)
LEGS_WINDOW = 8192
#: the card's name and power limit as nvidia-smi reads them (set by main)
CARD = "not measured"


@contextlib.contextmanager
def recording_ring(calls: list):
    """Record ``(blocks, outputs)`` of every K3 launch while the context
    is open. The wrapper's launch helper is wrapped, so the launch count
    stays the wrapper's."""
    from sdnmpi_tpu_torch.kernels import ring

    launch = ring._launch

    def record(blocks, b):
        out = launch(blocks, b)
        calls.append((blocks, out))
        return out

    ring._launch = record
    try:
        yield
    finally:
        ring._launch = launch


def check_k3_calls(calls: list, launches: int, what: str) -> None:
    """Every recorded K3 launch of one leg equal to the plain version on
    its own blocks, on every shard."""
    import torch

    from sdnmpi_tpu_torch.kernels import ring

    if len(calls) != launches:
        fail(f"{what}: {len(calls)} K3 calls recorded for {launches} launches")
    for blocks, out in calls:
        want = ring.ring_all_gather_plain(blocks)
        torch.cuda.synchronize()
        for q, (g, w) in enumerate(zip(out, want)):
            if g.shape != w.shape or not torch.equal(g, w):
                fail(f"K3 {what}: shard {q} differs from the plain version")
        log(f"K3 {what}: {len(blocks)} blocks of {tuple(blocks[0].shape)} "
            f"{blocks[0].dtype} equal to the plain version on every shard")


@contextlib.contextmanager
def recording_step(calls: list, streams: bool = False):
    """Record every launch of K3's step form while the context is open:
    ``(blocks, t, views before, views after)``, both copies taken on the
    current stream around it (the plan's, where the port launches it);
    with ``streams``, ``(blocks, t, the plan's stream handle)`` instead.
    ``StepPlan.launch`` is wrapped, so the launch count stays the
    wrapper's."""
    from sdnmpi_tpu_torch.kernels import ring

    launch = ring.StepPlan.launch

    def record(plan, t):
        if streams:
            launch(plan, t)
            calls.append((plan.blocks, t, plan.stream))
            return
        before = plan.views.clone()
        launch(plan, t)
        calls.append((plan.blocks, t, before, plan.views.clone()))

    ring.StepPlan.launch = record
    try:
        yield
    finally:
        ring.StepPlan.launch = launch


def check_step_calls(calls: list, launches: int, what: str) -> None:
    """Every recorded launch of K3's step form of one leg equal to the
    plain step on its own blocks, applied to the views as they stood
    before the launch."""
    import torch

    from sdnmpi_tpu_torch.kernels import ring

    if len(calls) != launches:
        fail(f"{what}: {len(calls)} step calls recorded for {launches} launches")
    torch.cuda.synchronize()
    for blocks, t, before, after in calls:
        ring.ring_step_plain(blocks, before, t)
        if not torch.equal(after, before):
            fail(f"step kernel {what}: step {t} differs from the plain version")
    if calls:
        blocks = calls[0][0]
        log(f"step kernel {what}: {len(calls)} steps over {len(blocks)} blocks of "
            f"{tuple(blocks[0].shape)} {blocks[0].dtype}, each equal to the plain "
            "step on the views it found")
    calls.clear()


def leg_launches(fn, what: str, want: dict, report: dict) -> tuple:
    """Run ``fn()`` with the launch counts zeroed and every K2, K3 and
    step-form call recorded; each K2 call (its set-up's tables included),
    each K3 call and each step held against its plain version, the K2
    launches of one device
    sharing one set-up, and the counts exactly ``want``. Returns (counts,
    the recorded K2 calls, the wall in ms)."""
    k2_calls: list = []
    k3_calls: list = []
    step_calls: list = []
    wall = {}

    def timed_fn():
        t0 = time.perf_counter()
        fn()
        wall["ms"] = (time.perf_counter() - t0) * 1e3

    with recording_sampler(k2_calls), recording_ring(k3_calls), \
            recording_step(step_calls):
        counts = path_launches(timed_fn)
    report["sample_slots"]["max_abs_err"] = max(
        report["sample_slots"]["max_abs_err"],
        check_k2_calls(k2_calls, counts["sample_slots"], what))
    check_k3_calls(k3_calls, counts["ring_all_gather"], what)
    check_step_calls(step_calls, counts["ring_step"], what)
    n_tables = len({id(kw["tables"]) for _, kw, _ in k2_calls})
    if k2_calls and n_tables != counts["sampler_tables"]:
        fail(f"{what}: {counts['sample_slots']} K2 launches on {n_tables} "
             f"tables for {counts['sampler_tables']} set-ups")
    if counts != want:
        fail(f"{what}: launches {counts}, want {want}")
    log(f"{what}: launches {counts} (as stated); wall {wall['ms']:.1f} ms "
        f"({CARD})")
    return counts, k2_calls, wall["ms"]




def same_window(a, b, what: str) -> None:
    for field in ("hop_dpid", "hop_port", "hop_len", "touched"):
        x, y = getattr(a, field), getattr(b, field)
        if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
            fail(f"{what}: {field} differs from the single-device TopologyDB")


def same_collective(a, b, what: str) -> None:
    for field in ("pair_sub", "final_port", "hop_dpid", "hop_port", "hop_len"):
        x, y = getattr(a, field), getattr(b, field)
        if x.shape != y.shape or not np.array_equal(x, y):
            fail(f"{what}: {field} differs from the single-device TopologyDB")
    if (a.max_congestion, a.n_detours) != (b.max_congestion, b.n_detours):
        fail(f"{what}: congestion {a.max_congestion} / {b.max_congestion}, "
             f"detours {a.n_detours} / {b.n_detours}")


def time_k3_wire(blocks: list, mesh, what: str) -> dict:
    """K3 on one leg's own blocks: the wrapper, the bare kernel, the plain
    version and ``torch.cat(blocks * s)`` (the same s copies), beside its
    bound (each block read once, each shard's copy written once)."""
    import torch

    from sdnmpi_tpu_torch.kernels import ring

    s = len(blocks)
    ms = time_ms(lambda: ring.ring_all_gather(blocks, mesh), reps=20)
    plain = time_ms(lambda: ring.ring_all_gather_plain(blocks), reps=10)
    lib = time_ms(lambda: torch.cat(blocks * s), reps=20)
    rows = log_profile(f"K3 {what}", *profile_device(
        lambda: ring.ring_all_gather(blocks, mesh)))
    r_all = sum(b.shape[0] for b in blocks)
    n_bytes = (1 + s) * r_all * blocks[0].shape[1] * blocks[0].element_size()
    bound, by = bound_ms({"bytes": n_bytes, "ops": 0})
    bare = device_ms(rows, "broadcast_gather")
    bare = f"{bare:.4f} ms" if bare > 0 else "not measured (no device time)"
    log(f"K3 time ({what}: {s} blocks of {tuple(blocks[0].shape)} "
        f"{blocks[0].dtype}): wrapper {ms:.4f} ms, bare kernel {bare}, "
        f"plain {plain:.4f} ms, "
        f"torch.cat(blocks * {s}) {lib:.4f} ms; bound {bound:.5f} ms ({by}, "
        f"{n_bytes} B) ({CARD})")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound}


def phase_shard_legs(device, report: dict, k: int = SHARD_K,
                     n_ranks: int = SHARD_RANKS, n_window: int = LEGS_WINDOW) -> list:
    """Config 13 on the remaining sharded legs: fattree(56), V padded to
    3,968, 8 shards of one card. (a) 8,192-pair unicast windows through
    find_routes_batch_dispatch on shard_oracle, ring on and off, and the
    narrowed re-route of one flapped link; (b) warm_serving; (c) the
    shortest collective at 8192 ranks through ``_next_full``; (d) UGAL on
    the mesh: config 5's adaptive batch and config 13's adaptive
    collective; (e) route_flows_sharded and multichip_route_step on
    config 13's alltoall. Every leg's launches exactly as stated, every
    K2 and K3 call held against its plain version, every fdb and route
    checked and equal to a single-device TopologyDB's. Returns the
    launch counts of each counted leg."""
    import torch

    from sdnmpi_tpu_torch.collectives import alltoall_pairs
    from sdnmpi_tpu_torch.core.topology_db import Link, Port
    from sdnmpi_tpu_torch.kernels.ring import pack_next_wire
    from sdnmpi_tpu_torch.oracle.adaptive import link_loads
    from sdnmpi_tpu_torch.oracle.congestion import route_flows_balanced
    from sdnmpi_tpu_torch.shardplane import (
        make_mesh,
        multichip_route_step,
        route_flows_sharded,
    )
    from sdnmpi_tpu_torch.topogen import fattree

    legs = []
    walls = {}
    spec = fattree(k)
    t0 = time.perf_counter()
    db = spec.to_topology_db(backend="torch", device=device, pad_multiple=SHARD_PAD,
                             mesh_devices=N_SHARDS, shard_oracle=True,
                             ring_exchange=True)
    one = spec.to_topology_db(backend="torch", device=device, pad_multiple=SHARD_PAD)
    walls["db_build_s"] = time.perf_counter() - t0
    oracle = db._oracle_engine()
    t0 = time.perf_counter()
    t = oracle.refresh(db)
    torch.cuda.synchronize()
    walls["refresh_ms"] = (time.perf_counter() - t0) * 1e3
    one._oracle_engine().refresh(one)
    mesh = oracle._shard_mesh()
    hosts = [m for m, _, _ in spec.hosts[:n_ranks]]
    log(f"phase 25: fattree-k{k} V={t.v}, {mesh.n_shards} shards on {device}; "
        f"DB builds {walls['db_build_s']:.1f} s, ring refresh "
        f"{walls['refresh_ms']:.1f} ms")

    # (a) unicast windows past the host chase's budget, ring on and off
    rng = np.random.default_rng(25)
    a = rng.integers(0, len(hosts), n_window)
    b = (a + 1 + rng.integers(0, len(hosts) - 1, n_window)) % len(hosts)
    pairs = [(hosts[i], hosts[j]) for i, j in zip(a, b)]
    ref, _, walls["window_one_steady_ms"], _ = timed_calls(
        lambda: one.find_routes_batch_dispatch(pairs).reap())
    log(f"(a) {n_window:,}-pair window on one device: steady "
        f"{walls['window_one_steady_ms']:.1f} ms ({CARD})")
    # the ring chase streams its exchange (K3's step form); the gather
    # chase gathers with one K3 launch
    chase = {True: launches_of(step=ring_steps()), False: launches_of(k3=1)}
    for ring_mode in (True, False):
        oracle.ring_exchange = ring_mode
        mode = "ring" if ring_mode else "gather"
        what = f"(a) {n_window:,}-pair window, {mode}"
        out = {}
        counts, _, walls[f"window_{mode}_ms"] = leg_launches(
            lambda: out.update(w=db.find_routes_batch_dispatch(pairs).reap()),
            what, chase[ring_mode], report)
        legs.append(counts)
        same_window(out["w"], ref, what)
        check_fdbs(db, pairs, out["w"].fdbs(), what)
        _, first, steady, times = timed_calls(
            lambda: db.find_routes_batch_dispatch(pairs).reap())
        walls[f"window_{mode}_steady_ms"] = steady
        log(f"{what}: hop budget {out['w'].hop_dpid.shape[1]}, equal to one "
            f"device; steady {', '.join(f'{x:.1f}' for x in times)} ms (median "
            f"{steady:.1f}) ({CARD})")
    wire = [pack_next_wire(x) for x in oracle._next_d]
    k3_wire = time_k3_wire(wire, mesh, "next-hop wire")
    k3_rows = time_k3_wire(list(oracle._next_d), mesh, "int32 next-hop rows")
    del wire
    # one flapped link: a full sharded refresh, then the narrowed re-route
    d1, p1 = out["w"].fdbs()[0][0]
    d2 = out["w"].fdbs()[0][1][0]
    link = Link(Port(d1, p1), Port(d2, db.links[d1][d2].dst.port_no))
    for x in (db, one):
        x.delete_link(link)
    oracle.ring_exchange = True
    t0 = time.perf_counter()
    refresh = path_launches(lambda: oracle.refresh(db))
    walls["flap_refresh_ms"] = (time.perf_counter() - t0) * 1e3
    one._oracle_engine().refresh(one)
    log(f"(a) flap {d1}->{d2}: sharded ring refresh "
        f"{walls['flap_refresh_ms']:.1f} ms, launches {refresh} ({CARD})")
    ref = one.find_routes_batch_delta_dispatch(pairs, [d1, d2]).reap()
    for ring_mode in (True, False):
        oracle.ring_exchange = ring_mode
        what = f"(a) narrowed re-route, {'ring' if ring_mode else 'gather'}"
        counts, _, walls[f"delta_{'ring' if ring_mode else 'gather'}_ms"] = leg_launches(
            lambda: out.update(w=db.find_routes_batch_delta_dispatch(
                pairs, [d1, d2]).reap()), what, chase[ring_mode], report)
        legs.append(counts)
        same_window(out["w"], ref, what)
        check_fdbs(db, pairs, out["w"].fdbs(), what)
        log(f"{what}: {int(out['w'].touched.sum()):,} of {n_window:,} pairs "
            "touched, equal to one device")
    for x in (db, one):
        x.add_link(link)
    oracle.ring_exchange = True
    oracle.refresh(db)
    one._oracle_engine().refresh(one)

    # (b) the serving warm-up of the sharded chase
    for ring_mode in (True, False):
        oracle.ring_exchange = ring_mode
        what = f"(b) warm_serving, {'ring' if ring_mode else 'gather'}"
        warm = launches_of(step=2 * ring_steps()) if ring_mode else launches_of(k3=2)
        counts, _, _ = leg_launches(lambda: out.update(w=db.warm_serving()), what,
                                    warm, report)
        legs.append(counts)
        w = out["w"]
        if w["shapes"] != [8, 256]:
            fail(f"{what}: warmed buckets {w['shapes']}")
        walls[f"warm_{'ring' if ring_mode else 'gather'}_ms"] = w["warm_s"] * 1e3
        log(f"{what}: buckets {w['shapes']}, hop budget {w['max_len']}, "
            f"{w['warm_s'] * 1e3:.1f} ms ({CARD})")
    oracle.ring_exchange = True

    # (c) the shortest collective on the row-sharded next hops
    pair_idx = alltoall_pairs(len(hosts))
    src_idx, dst_idx = pair_idx[:, 0], pair_idx[:, 1]
    del pair_idx

    def collective(x, policy):
        return lambda: out.update(r=x.find_routes_collective(
            hosts, src_idx, dst_idx, policy=policy))

    collective(one, "shortest")()
    ref = out["r"]
    for n, (when, k3) in enumerate((("first call after the refresh", 1),
                                    ("steady", 0))):
        what = f"(c) shortest collective, {when}"
        counts, _, walls[f"shortest_{n}_ms"] = leg_launches(
            collective(db, "shortest"), what, launches_of(k3=k3), report)
        legs.append(counts)
        same_collective(out["r"], ref, what)
    check_routes("(c) shortest collective", spec, db, hosts, src_idx, dst_idx,
                 out["r"])
    log(f"(c) shortest collective: {len(src_idx):,} pairs -> "
        f"{out['r'].n_subflows:,} sub-flows, equal to one device; K3 gathers "
        "the next hops once per refresh")

    # (d) UGAL on the mesh: config 5's batch, then config 13's collective
    p = dragonfly_problem(device)
    dspec, dt = p["spec"], p["t"]
    mdb = dspec.to_topology_db(backend="torch", device=device, mesh_devices=N_SHARDS)
    sdb = dspec.to_topology_db(backend="torch", device=device)
    mac_of = {dpid: mac for mac, dpid, _ in dspec.hosts}
    dmacs = [mac_of[int(d)] for d in dt.dpids]
    dpairs = [(dmacs[s], dmacs[d]) for s, d in zip(p["src"], p["dst"])]
    port = dt.host_port()
    share = max(1.0, len(dpairs) / int((dt.host_adj() > 0).sum()))
    bps = DFLY_UTIL * 10e9 / share
    link_util = {(int(dt.dpids[i]), int(port[i, j])): bps
                 for i, j in zip(*np.nonzero(p["direct"]))}
    mdb._oracle_engine().refresh(mdb)

    def adaptive_batch(x):
        return lambda: out.update(r=x.find_routes_batch_adaptive(
            dpairs, link_util=link_util, ugal_candidates=DFLY_CANDIDATES))

    adaptive_batch(sdb)()
    ref = out["r"]
    ugal = launches_of(setup=1, k2=2 * N_SHARDS)
    what = f"(d) config 5 adaptive batch on {N_SHARDS} shards"
    counts, k2_dfly, walls["dragonfly_adaptive_ms"] = leg_launches(
        adaptive_batch(mdb), what, ugal, report)
    legs.append(counts)
    if out["r"] != ref:
        fail(f"{what}: differs from the single-device TopologyDB")
    check_fdbs(mdb, dpairs, out["r"][0], what)
    log(f"{what}: {out['r'][1]:,} pairs detoured, max congestion {out['r'][2]}, "
        "equal to one device")
    # the last shard's first segment (every live flow; the second holds
    # the detours only)
    seg_args, seg_kw, _ = k2_dfly[-2]
    measure_k2(seg_args, seg_kw, f"config 5 sharded UGAL segment 1, shard "
                                 f"{N_SHARDS - 1}", dt.neigh)
    del k2_dfly, mdb, sdb, p
    collective(one, "adaptive")()
    ref = out["r"]
    # the replicated distances: one K3 gather on the first adaptive call
    # after the refresh, recorded and held against the plain version;
    # none on the steady call
    for n, (when, k3) in enumerate((("first call after the refresh", 1),
                                    ("steady", 0))):
        what = f"(d) config 13 adaptive collective on {N_SHARDS} shards, {when}"
        counts, k2_13, walls[f"collective_adaptive_{n}_ms"] = leg_launches(
            collective(db, "adaptive"), what, launches_of(setup=1, k2=2 * N_SHARDS,
                                                          k3=k3), report)
        legs.append(counts)
        same_collective(out["r"], ref, what)
    check_routes(what, spec, db, hosts, src_idx, dst_idx, out["r"])
    seg_args, seg_kw, _ = k2_13[-2]
    k2 = measure_k2(seg_args, seg_kw, f"config 13 sharded UGAL segment 1, shard "
                                      f"{N_SHARDS - 1}", t.neigh)
    log(f"K2 config 13 sharded UGAL segment 1: set-up + kernel {k2['ms']:.4f} ms, "
        f"bound {bound_ms(k2)[0]:.5f} ms ({bound_ms(k2)[1]}) ({CARD})")
    del k2_13, seg_args, seg_kw, ref
    out.clear()

    # (e) the library legs on config 13's alltoall
    sp = shard_problem(device, k, n_ranks)
    st = sp["t"]
    lmesh = make_mesh(N_SHARDS, device)
    put = lambda x: torch.as_tensor(x).to(device)  # noqa: E731
    base = torch.zeros((st.v, st.v), dtype=torch.float32, device=device)
    lib_args = (put(sp["src"]), put(sp["dst"]), put(sp["weight"]), lmesh,
                sp["levels"] + 1)
    live = sp["src"] >= 0
    results = {}
    for name, fn in (
        ("route_flows_sharded", lambda: route_flows_sharded(
            st.adj, sp["dist"], base, *lib_args, neigh=st.neigh)),
        ("multichip_route_step", lambda: multichip_route_step(
            st.adj, base, *lib_args, neigh=st.neigh)),
    ):
        what = f"(e) {name}"
        scans: list = []
        # the wall waits for the device: the legs return tensors unread
        with recording_scanner(scans):
            counts, _, walls[f"{name}_ms"] = leg_launches(
                lambda: (results.update({name: fn()}), torch.cuda.synchronize()),
                what, launches_of(scan=N_SHARDS), report)
        legs.append(counts)
        if len(scans) != N_SHARDS:
            fail(f"{what}: {len(scans)} scanner calls recorded for {N_SHARDS} shards")
        if name == "route_flows_sharded":
            # one shard's call (the last) against the plain version
            args, kw, got = scans[-1]
            shard = f"config 13 shard {N_SHARDS - 1} of route_flows_sharded"
            check_scan(args, kw, got, f"{shard}, chunk {kw['chunk']}")
            hold_scan_forms(args, kw, got, shard, "spread")
            without_sync(lambda: route_flows_balanced(*args, **kw),
                         f"S1's spread form ({shard})")
            call = functools.partial(route_flows_balanced, *args, **kw)
            ms = time_ms(call, reps=5, warm=1)
            queued = queued_ms(call, n=10)
            work = scan_work(args, kw, got)
            step_us = ms / max(1, work["steps"]) * 1e3
            log(f"S1 time (config 13 shard {N_SHARDS - 1}, spread form, "
                f"{work['flows']:,} flows, chunk {kw['chunk']}): wrapper {ms:.4f} ms for "
                f"{work['steps']:,} dependent hop steps ({step_us:.3f} us a step), "
                f"{work['moves']:,} moves; queued {queued:.4f} ms ({CARD})")
        del scans
        nodes_sh, load, maxc = results[name]
        nodes = torch.cat(nodes_sh).cpu().numpy()
        n = check_paths(nodes[live], sp["src"][live], sp["dst"][live], sp["dist_h"],
                        st.host_adj(), what)
        want = link_loads(nodes, sp["weight"], st.v)
        got = load.cpu().numpy()
        if not np.allclose(got, want, rtol=1e-6, atol=0.0):
            fail(f"{what}: summed load differs from link_loads of its paths "
                 f"(max {float(np.abs(got - want).max())})")
        if float(maxc) != float(got[st.host_adj() > 0].max()):
            fail(f"{what}: max congestion {float(maxc)} is not the load's max")
        log(f"{what}: {n:,} flows on shortest real paths, load equal to "
            f"link_loads of the paths (rtol 1e-6), max congestion {float(maxc)}")
    a_nodes, a_load, _ = results["route_flows_sharded"]
    b_nodes, b_load, _ = results["multichip_route_step"]
    if not (torch.equal(torch.cat(a_nodes), torch.cat(b_nodes))
            and torch.equal(a_load, b_load)):
        fail("(e) multichip_route_step differs from route_flows_sharded on the "
             "exact distances")
    del results, sp, db, one
    collect("phase 25")
    summary = {"walls": walls, "k3_next_hop_wire": k3_wire, "k3_next_hop_rows": k3_rows,
               "k3_launches": sum(c["ring_all_gather"] for c in legs),
               "step_launches": sum(c["ring_step"] for c in legs),
               "k2_launches": sum(c["sample_slots"] for c in legs)}
    log(f"phase 25 summary ({CARD}): " + json.dumps(summary))
    return legs


# -- phase 26: the overlapped exchange (config 13, 8 shards) ----------------

#: calls of each consumer under the delayed, poisoned exchange
OVERLAP_CALLS = 20
#: spin cycles (torch.cuda._sleep) before each step of the delayed
#: exchange, taken in turn by the calls: 0, ~0.1, ~0.5 and ~1.5 ms
OVERLAP_DELAYS = (0, 200_000, 1_000_000, 3_000_000)
#: calls timed for each wall of (d) and each point of the sweep (e)
OVERLAP_REPS = 10
#: CTA counts of the step kernel's sweep (a bulk step of config 13 has
#: 968 or 484 chunks, one CTA each at most; one bulk CTA an SM)
STEP_SWEEP_CTAS = (8, 16, 32, 48, 66, 96, 128, 132, 264)
#: the sweep's pick: the fewest CTAs whose exchange is within this share
#: of the sweep's best
STEP_SWEEP_SLACK = 0.05
#: exchange-stream priorities of the sweep (CUDA: -1 is high, 0 default)
STEP_SWEEP_PRIORITIES = (0, -1)


def wall_ms(fn, n: int = OVERLAP_REPS) -> float:
    """Median host wall of ``fn()`` in ms, the device synchronized before
    and after each call (after one call that is not timed)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def step_bytes(s: int, b: int, c: int, item: int, t: int) -> int:
    """Bytes step t of the exchange must move: each source block read
    once, each arrival written once."""
    from sdnmpi_tpu_torch.kernels.ring import step_offsets

    return (s + s * len(step_offsets(t, s))) * b * c * item


def step_copies(blocks: list, views, t: int) -> tuple:
    """Step t's (destination, source) pairs: the ``Tensor.copy_`` calls
    of the plain version."""
    from sdnmpi_tpu_torch.kernels.ring import step_offsets

    s = len(blocks)
    b = blocks[0].shape[0]
    dst, src = [], []
    for me in range(s):
        for d in step_offsets(t, s):
            q = (me + d) % s
            dst.append(views[me][q * b:(q + 1) * b])
            src.append(blocks[q])
    return dst, src


def shifted(shape: tuple, dtype, device, fill=None, elems: int = 1):
    """A contiguous tensor of ``shape`` that starts ``elems`` elements past
    an allocation's start (one: 2 or 4 bytes off its alignment);
    ``fill`` copied in, else zeros."""
    import torch

    n = math.prod(shape)
    buf = torch.zeros(n + elems, dtype=dtype, device=device)
    out = buf[elems:].view(shape)
    if fill is not None:
        out.copy_(fill)
    return out


def hold_steps(device) -> None:
    """(a) Every step of the step kernel exactly against its plain version
    (both on the card, on the same blocks), at s in {3, 8}, on the bf16,
    int16 and int32 wires, uneven and at config 13's full width, at the
    default CTA count and at 8 (many chunks or grid strides a CTA); at
    full width also with the blocks one element (2-byte words) and 8 bytes
    (8-byte words) off their alignment (the vector path), and with the
    blocks and the views both one element off (the bulk path with a head
    and a tail); the views after the last step equal to
    ring_all_gather_plain's output, and a poisoned RingExchange's trimmed
    views equal to the matrix. Logs each case's path a step; fails unless
    the aligned full-width case took the bulk path, the shifted sources
    the vector path, and both shifted the bulk path."""
    import torch

    from sdnmpi_tpu_torch.kernels import ring

    rng = np.random.default_rng(26)
    cases = [(s, r, c, dt, None) for dt in (torch.bfloat16, torch.int16, torch.int32)
             for s, r, c in ((3, 1001, 130), (8, 1001, 384), (8, SHARD_V, SHARD_V))]
    # the shifts: the source one element off, 8 bytes off, source and views
    # both one element off
    shifts = {"source": "vector", "source8": "vector", "both": "bulk"}
    cases += [(N_SHARDS, SHARD_V, SHARD_V, torch.int16, shift) for shift in shifts]
    want_path = {(N_SHARDS, SHARD_V, SHARD_V, torch.int16, shift): path
                 for shift, path in (*shifts.items(), (None, "bulk"))}
    seen = set()
    for s, r, c, dt, shift in cases:
        x = torch.as_tensor(rng.integers(-30000, 30000, (r, c))).to(device, dt)
        if shift is not None:
            x = shifted((r, c), dt, device, x, 8 // x.element_size() if shift == "source8"
                        else 1)
        b = -(-r // s)
        blocks = [x[q * b:(q + 1) * b] for q in range(s)]
        padded, b, _ = ring._padded_blocks(blocks)
        whole = ring.ring_all_gather_plain(padded)
        paths = {}
        for ctas in (None, 8):
            shape = (s, s * b, c)
            got = (shifted(shape, dt, device) if shift == "both"
                   else torch.zeros(shape, dtype=dt, device=device))
            want = torch.zeros(shape, dtype=dt, device=device)
            plan = ring.StepPlan(padded, got, ctas)
            paths[ctas or ring.STEP_CTAS] = plan.paths
            seen.update(plan.paths)
            for t in range(plan.last + 1):
                plan.launch(t)
                ring.ring_step_plain(padded, want, t)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"step kernel s={s} R={r} C={c} {dt} shift={shift} ctas={ctas}: "
                         f"step {t} ({plan.paths[t]} path) differs from the plain version")
            for me in range(s):
                if not torch.equal(got[me], whole[me]):
                    fail(f"step kernel s={s} R={r} C={c} {dt} shift={shift}: shard {me}'s "
                         "view differs from ring_all_gather_plain after the last step")
        need = want_path.get((s, r, c, dt, shift))
        if need is not None and any(p != need for ps in paths.values() for p in ps):
            fail(f"step kernel s={s} R={r} C={c} {dt} shift={shift}: paths {paths}, "
                 f"want {need} on every step")
        ring.POISON = True
        try:
            ex = ring.RingExchange(blocks)
            ex.join()
        finally:
            ring.POISON = False
        torch.cuda.synchronize()
        for me in range(s):
            if not torch.equal(ex.view(me), x):
                fail(f"RingExchange s={s} R={r} C={c} {dt} shift={shift}: shard {me} "
                     "differs")
        log(f"step kernel s={s} R={r} C={c} {dt} shift={shift}: every step equal to "
            f"the plain version (default CTAs and 8), the views to "
            f"ring_all_gather_plain; paths by CTAs {paths}")
        del x, blocks, padded, whole, got, want, ex
    if seen != {"bulk", "vector"}:
        fail(f"step kernel: the held cases took the paths {sorted(seen)}, not both")


def enqueue_ms(fn, n: int = OVERLAP_REPS) -> float:
    """Median host time of enqueueing ``fn()`` in ms: the host clock around
    the call alone, the device synchronized before each (after one call
    that is not timed)."""
    import torch

    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def time_steps(device, report: dict) -> list:
    """The step kernel at config 13's next-hop wire (8 blocks of [496,
    3968] int16) through one StepPlan: each step's bare time (queued) at
    the default CTA count beside its bound; step 1 bare on the vector path
    at the same shape, with the blocks 8 bytes (8-byte words) and one
    element (2-byte words) off their alignment; step 1's wrapper as the
    exchange launches it (``plan.launch``) and through ``ring_step``, its
    plain version, the same copies as ``Tensor.copy_`` calls and as one
    ``torch._foreach_copy_``; the whole exchange's host enqueue time (and
    its plan's alone, built and reused), device time and wall beside one
    ``torch._foreach_copy_`` of its 64 copies; then the sweep of CTA
    counts (e) and its pick beside ``STEP_CTAS``. Returns the sweep."""
    import torch

    from sdnmpi_tpu_torch.kernels import ring

    rng = np.random.default_rng(261)
    v, s = SHARD_V, N_SHARDS
    rp = v // s
    x = torch.as_tensor(rng.integers(-1, v, (v, v))).to(device, torch.int16)
    blocks = [x[q * rp:(q + 1) * rp].contiguous() for q in range(s)]
    off8 = shifted((v, v), torch.int16, device, x, 4)
    off2 = shifted((v, v), torch.int16, device, x)
    views = torch.empty((s, v, v), dtype=torch.int16, device=device)
    plan = ring.StepPlan(blocks, views)
    vector = ring.StepPlan([off8[q * rp:(q + 1) * rp] for q in range(s)], views)
    misaligned = ring.StepPlan([off2[q * rp:(q + 1) * rp] for q in range(s)], views)
    for p, want in ((plan, "bulk"), (vector, "vector"), (misaligned, "vector")):
        if set(p.paths) != {want}:
            fail(f"step kernel timing: paths {p.paths}, want {want}")
    last = plan.last
    bare, bounds = [], []
    for t in range(last + 1):
        bare.append(queued_ms(lambda: plan.launch(t)))
        bounds.append(bound_ms({"bytes": step_bytes(s, rp, v, 2, t), "ops": 0})[0])
    log(f"step kernel bare, bulk path (queued, {ring.STEP_CTAS} CTAs), steps 0-{last}: "
        + ", ".join(f"{m:.4f}" for m in bare) + " ms; bounds "
        + ", ".join(f"{m:.4f}" for m in bounds) + " ms; shares "
        + ", ".join(f"{b / m:.1%}" for m, b in zip(bare, bounds))
        + f"; the exchange {sum(bare):.4f} ms, bound {sum(bounds):.4f} ms "
        f"({sum(bounds) / sum(bare):.1%}), steps 1-{last}: {sum(bare[1:]):.4f} ms, "
        f"bound {sum(bounds[1:]):.4f} ms ({CARD})")
    vec_ms = queued_ms(lambda: vector.launch(1))
    mis_ms = queued_ms(lambda: misaligned.launch(1))
    log(f"step kernel bare step 1 at {ring.STEP_CTAS} CTAs: bulk {bare[1]:.4f} ms; "
        f"vector path with the blocks 8 bytes off their alignment (8-byte words) "
        f"{vec_ms:.4f} ms, one element off (2-byte words) {mis_ms:.4f} ms; bulk "
        f"faster than the vector path: {bare[1] < vec_ms} ({CARD})")
    dst, src = step_copies(blocks, views, 1)
    ms = time_ms(lambda: plan.launch(1), reps=20)
    step_ms = time_ms(lambda: ring.ring_step(blocks, views, 1), reps=20)
    plain = time_ms(lambda: ring.ring_step_plain(blocks, views, 1), reps=20)
    copies = time_ms(lambda: [d.copy_(b) for d, b in zip(dst, src)], reps=20)
    lib = time_ms(lambda: torch._foreach_copy_(dst, src), reps=20)
    nbytes = step_bytes(s, rp, v, 2, 1)
    log(f"step kernel, step 1 ({len(dst)} block copies, {nbytes} B): wrapper as the "
        f"exchange launches it (plan.launch) {ms:.4f} ms, through ring_step "
        f"{step_ms:.4f} ms, bare {bare[1]:.4f} ms, plain {plain:.4f} ms, Tensor.copy_ x "
        f"{len(dst)} {copies:.4f} ms, torch._foreach_copy_ {lib:.4f} ms; bound "
        f"{bounds[1]:.4f} ms; plan.launch no slower than torch._foreach_copy_: "
        f"{ms <= lib} ({CARD})")
    report["ring_step"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
                           "bytes": nbytes, "ops": 0, "library_ms": lib}
    all_dst, all_src = [], []
    for t in range(last + 1):
        d, b = step_copies(blocks, views, t)
        all_dst += d
        all_src += b

    def exchange():
        ring.RingExchange(blocks).join()

    def foreach():
        torch._foreach_copy_(all_dst, all_src)

    def planned_anew():
        ring._PLAN_CALLS.clear()
        ring.StepPlan(blocks, views)

    def exchange_planned_anew():
        ring._PLAN_CALLS.clear()
        ring.RingExchange(blocks)

    ex = {"enqueue_ms": enqueue_ms(lambda: ring.RingExchange(blocks)),
          "enqueue_planned_anew_ms": enqueue_ms(exchange_planned_anew),
          "plan_ms": enqueue_ms(lambda: ring.StepPlan(blocks, views)),
          "plan_built_ms": enqueue_ms(planned_anew),
          "device_ms": time_ms(exchange, reps=20), "wall_ms": wall_ms(exchange),
          "lib_enqueue_ms": enqueue_ms(foreach), "lib_device_ms": time_ms(foreach, reps=20),
          "lib_wall_ms": wall_ms(foreach)}
    log(f"the exchange ({last + 1} steps, {len(all_dst)} block copies): host enqueue "
        f"{ex['enqueue_ms']:.4f} ms with its calls reused ({ex['enqueue_planned_anew_ms']:.4f} "
        f"ms planned anew; its StepPlan alone {ex['plan_ms']:.4f} ms reused, "
        f"{ex['plan_built_ms']:.4f} ms built), device {ex['device_ms']:.4f} ms, wall "
        f"{ex['wall_ms']:.4f} ms; torch._foreach_copy_ of the {len(all_dst)} copies: "
        f"enqueue {ex['lib_enqueue_ms']:.4f} ms, device {ex['lib_device_ms']:.4f} ms, "
        f"wall {ex['lib_wall_ms']:.4f} ms; bound {sum(bounds):.4f} ms; the exchange's "
        f"wall no slower than torch._foreach_copy_'s: "
        f"{ex['wall_ms'] <= ex['lib_wall_ms']} ({CARD})")
    sweep = []
    for ctas in STEP_SWEEP_CTAS:
        p = ring.StepPlan(blocks, views, ctas)
        per = [queued_ms(lambda: p.launch(t)) for t in range(last + 1)]
        sweep.append((ctas, per))
        log(f"(e) step kernel at {ctas} CTAs: steps " + ", ".join(f"{m:.4f}" for m in per)
            + f" ms, the exchange {sum(per):.4f} ms ({CARD})")
    best = min(sum(per) for _, per in sweep)
    pick = min(c for c, per in sweep if sum(per) <= (1 + STEP_SWEEP_SLACK) * best)
    log(f"(e) the sweep's best exchange {best:.4f} ms; the fewest CTAs within "
        f"{STEP_SWEEP_SLACK:.0%} of it: {pick}; STEP_CTAS = {ring.STEP_CTAS} ({CARD})")
    return sweep


def sleep_cycles_per_ms() -> float:
    """``torch.cuda._sleep`` cycles in one ms of this card, by events."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    b.synchronize()
    return 20_000_000 / a.elapsed_time(b)


def overlap_segments(trace: list) -> list:
    """The consumer segments of a traced call and the steps in flight in
    each. A segment runs on the consumer's stream from a ``"ready"`` event
    (the work after a wait) or from a ``"fork"`` that is followed by its
    exchange's ``"join"`` (the work queued while the whole exchange is in
    flight) to the next ``"wait"`` or ``"join"``. A step is in flight in
    it when its exchange forked before the segment's end was enqueued and
    no wait on it came before that end. Returns ``(begin, end, [(start,
    end) of each step in flight])``, with segments that have no step in
    flight left out."""
    main = [(i, e) for i, e in enumerate(trace)
            if e[0] in ("fork", "wait", "ready", "join")]
    steps = {(e[1], e[2]): [None, None, i] for i, e in enumerate(trace)
             if e[0] == "start"}
    for kind, ex, t, ev in trace:
        if kind in ("start", "end"):
            steps[(ex, t)][kind == "end"] = ev
    forked = {e[1]: i for i, e in enumerate(trace) if e[0] == "fork"}
    covered = {}  # (ex, t) -> index of the first wait that covers step t
    for i, (kind, ex, t, _) in main:
        if kind in ("wait", "join"):
            for (x, u) in steps:
                if x == ex and u <= t and (x, u) not in covered:
                    covered[(x, u)] = i
    out = []
    for n, (i, (kind, ex, t, ev)) in enumerate(main):
        nxt = next(((j, e) for j, e in main[n + 1:] if e[0] in ("wait", "join")), None)
        if nxt is None:
            continue
        j, end = nxt
        if kind == "fork" and not (end[0] == "join" and end[1] == ex):
            continue
        if kind not in ("fork", "ready"):
            continue
        flying = [(a, b) for key, (a, b, _) in steps.items()
                  if forked[key[0]] < j and covered.get(key, len(trace)) >= j]
        if flying:
            out.append((ev, end[3], flying))
    return out


def trace_overlap(what: str, fn, cycles_per_ms: float) -> dict:
    """(c) Run ``fn()`` once with the exchange's events traced and every
    step launch's stream recorded, after a spin on the consumer's stream
    long enough (about twice ``fn``'s own wall) that the host enqueues the
    whole call before the card starts it: what runs at the same time on
    the card then shows, whatever the host's speed. Every step must
    launch on a stream other than the consumer's, and some consumer
    segment (:func:`overlap_segments`) must overlap a step in flight on
    the card: the step starts before the segment ends and ends after it
    begins. The hidden share is the part of the steps' card time that
    lies inside consumer segments. A step queued on the consumer's own
    stream lies wholly before or after each segment, and fails."""
    import torch

    from sdnmpi_tpu_torch.kernels import ring

    wall = wall_ms(fn, n=1)
    consumer = torch.cuda.current_stream()
    launched: list = []
    with recording_step(launched, streams=True):
        ring.TRACE = []
        try:
            torch.cuda.synchronize()
            torch.cuda._sleep(int(2 * wall * cycles_per_ms))
            spun = torch.cuda.Event(enable_timing=True)
            spun.record()
            fn()
            ahead = not spun.query()
            torch.cuda.synchronize()
            trace = ring.TRACE
        finally:
            ring.TRACE = None
    if not launched:
        fail(f"(c) {what}: no step launched")
    wrong = [st for *_, st in launched if st == consumer.cuda_stream]
    if wrong:
        fail(f"(c) {what}: {len(wrong)} of {len(launched)} step launches on the "
             "consumer's own stream")
    segments = [(spun.elapsed_time(b), spun.elapsed_time(e),
                 [(spun.elapsed_time(x), spun.elapsed_time(y)) for x, y in flying])
                for b, e, flying in overlap_segments(trace)]
    if not segments:
        fail(f"(c) {what}: no consumer segment with a step in flight")
    overlapped = sum(any(x < e and y > b for x, y in flying) for b, e, flying in segments)
    steps = {}
    for kind, ex, t, ev in trace:
        if kind in ("start", "end"):
            steps.setdefault((ex, t), [0.0, 0.0])[kind == "end"] = spun.elapsed_time(ev)
    step_ms = sum(y - x for x, y in steps.values())
    hidden_ms = sum(max(0.0, min(y, e) - max(x, b))
                    for x, y in steps.values() for b, e, _ in segments)
    if not overlapped or hidden_ms <= 0:
        fail(f"(c) {what}: no consumer segment overlapped a step in flight on the "
             f"card ({len(segments)} segments)")
    log(f"(c) {what}: host ahead of the card for the whole call: {ahead}; every "
        f"step launched on the exchange stream, not the consumer's; "
        f"{overlapped} of {len(segments)} consumer segment(s) with a step in flight "
        f"overlapped one on the card; {hidden_ms:.4f} of the steps' {step_ms:.4f} "
        f"ms ({hidden_ms / step_ms:.1%}) hidden inside consumer work ({CARD})")
    return {"segments": len(segments), "overlapped": overlapped,
            "hidden_ms": hidden_ms, "step_ms": step_ms, "host_ahead": ahead}


def sync_report(what: str, fn) -> list:
    """(f) ``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: the
    synchronizing calls it made, reported (not failed)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's one-time notice that it is a prototype is not a sync
    syncs = [str(w.message) for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    log(f"(f) {what}: {len(syncs)} synchronizing call(s) under sync debug mode "
        f"'warn'" + (f": {sorted(set(s[:120] for s in syncs))}" if syncs else ""))
    return syncs


def phase_ring_overlap(device, report: dict, k: int = SHARD_K,
                       n_ranks: int = SHARD_RANKS, n_window: int = LEGS_WINDOW,
                       calls: int = OVERLAP_CALLS) -> dict:
    """Config 13's overlapped exchange at full width (fattree(56), V =
    3,968, 8 shards of this card): (a) the step kernel held; (b) the
    three ring consumers (the gated chase of an 8,192-pair window, the
    refresh's column-pipelined next-hop argmin, the DAG step) bit-equal
    to their gather twins and to one device over ``calls`` calls of a
    poisoned exchange delayed before each step; (c) the overlap shown by
    the exchange's events; (d) each consumer's overlapped wall beside
    its serial equivalent (the exchange alone plus the consumer on
    landed data) and their ratio, the refresh leg's set as
    ``shard_exchange_overlap_gain``; (e) the step kernel's CTA sweep and
    the consumers' walls over CTA counts and stream priorities; (f) the
    ringed legs under sync debug mode 'warn'; (g) the ring re-route's
    first call after a refresh split into host and device time. Returns
    the summary."""
    import torch

    from sdnmpi_tpu_torch import shardplane as sp
    from sdnmpi_tpu_torch.kernels import ring
    from sdnmpi_tpu_torch.oracle import engine
    from sdnmpi_tpu_torch.oracle.dag import route_collective
    from sdnmpi_tpu_torch.oracle.paths import batch_fdb
    from sdnmpi_tpu_torch.shardplane import apsp as sp_apsp
    from sdnmpi_tpu_torch.shardplane import hier as sp_hier
    from sdnmpi_tpu_torch.shardplane import routes as sp_routes
    from sdnmpi_tpu_torch.topogen import fattree

    summary: dict = {}
    hold_steps(device)
    sweep = time_steps(device, report)

    # the consumers' arguments as the engine passes them at config 13
    spec = fattree(k)
    db = spec.to_topology_db(backend="torch", device=device, pad_multiple=SHARD_PAD,
                             mesh_devices=N_SHARDS, shard_oracle=True,
                             ring_exchange=True)
    one = spec.to_topology_db(backend="torch", device=device, pad_multiple=SHARD_PAD)
    oracle, one_oracle = db._oracle_engine(), one._oracle_engine()
    captured: dict = {}

    def spying(name):
        real = getattr(sp, name)

        def spy(*args, **kw):
            captured[name] = (args, kw)
            return real(*args, **kw)

        return real, spy

    real_nh, spy_nh = spying("apsp_next_hops_ringed")
    real_ch, spy_ch = spying("batch_fdb_ringed")
    sp.apsp_next_hops_ringed, sp.batch_fdb_ringed = spy_nh, spy_ch
    try:
        t = oracle.refresh(db)
        hosts = [m for m, _, _ in spec.hosts[:n_ranks]]
        rng = np.random.default_rng(26)
        a = rng.integers(0, len(hosts), n_window)
        b = (a + 1 + rng.integers(0, len(hosts) - 1, n_window)) % len(hosts)
        pairs = [(hosts[i], hosts[j]) for i, j in zip(a, b)]
        db.find_routes_batch_dispatch(pairs).reap()
    finally:
        sp.apsp_next_hops_ringed, sp.batch_fdb_ringed = real_nh, real_ch
    one_oracle.refresh(one)
    one_next = one_oracle._next_d
    nh_args, nh_kw = captured["apsp_next_hops_ringed"]
    ch_args, _ = captured["batch_fdb_ringed"]
    mesh = ch_args[-1]
    next_hop, port, src, dst, fport, max_len = ch_args[:6]
    p = shard_problem(device, k, n_ranks)
    rp = p["t"].v // N_SHARDS
    dist_sh = [p["dist"][q * rp:(q + 1) * rp] for q in range(N_SHARDS)]
    kw = dict(levels=p["levels"], rounds=ROUNDS, max_len=p["levels"] + 1,
              dst_nodes=p["dst_nodes"], neigh=p["t"].neigh)
    log(f"phase 26: fattree-k{k} V={t.v}, {mesh.n_shards} shards on {device}; "
        f"window {len(src):,} flows, hop budget {max_len}; next hops over "
        f"{nh_kw.get('n_occ', 0) or t.v} columns; collective {len(p['src']):,} "
        "flows")

    consumers = {
        "chase": (lambda: sp_routes.batch_fdb_ringed(*ch_args),
                  lambda: sp_routes.batch_fdb_sharded(*ch_args),
                  lambda: batch_fdb(one_next, port, src, dst, fport, max_len)),
        "next hops": (lambda: sp_apsp.apsp_next_hops_ringed(*nh_args, **nh_kw),
                      lambda: sp_apsp.apsp_next_hops_rowsharded(*nh_args, **nh_kw),
                      lambda: one_next),
        "collective": (
            lambda: sp_routes.route_collective_sharded(
                *p["args"], mesh, dist=dist_sh, ring_exchange=True, **kw),
            lambda: sp_routes.route_collective_sharded(
                *p["args"], mesh, dist=dist_sh, ring_exchange=False, **kw),
            lambda: route_collective(*p["args"], dist=p["dist"], **kw)),
    }

    def flat(r):
        """A consumer's result as tensors to compare: the per-shard lists
        joined; the collective's max congestion apart."""
        if isinstance(r, tuple) and len(r) == 2 and not isinstance(r[0], list):
            return [r[0]], r[1]
        if isinstance(r, tuple) and len(r) == 2:
            return [torch.cat(r[0])], r[1]
        if isinstance(r, tuple):
            return [torch.cat(x) if isinstance(x, list) else x for x in r], None
        return [torch.cat(r) if isinstance(r, list) else r], None

    # (b) bit-equal to the gather twin and one device, delayed and poisoned
    for name, (ringed, twin, single) in consumers.items():
        want, want_c = flat(twin())
        one_r, one_c = flat(single())
        for w, o in zip(want, one_r):
            if not torch.equal(w.to(o.dtype), o):
                fail(f"(b) {name}: the gather twin differs from one device")
        if want_c is not None and abs(float(want_c) - float(one_c)) > 1e-5 * abs(
                float(one_c)):
            fail(f"(b) {name}: max congestion {float(want_c)} against "
                 f"{float(one_c)} on one device")
        delays = []
        ring.POISON = True
        try:
            for i in range(calls):
                cycles = OVERLAP_DELAYS[i % len(OVERLAP_DELAYS)]
                ring.BEFORE_STEP = (lambda _t, c=cycles: torch.cuda._sleep(c)) if cycles else None
                got, got_c = flat(ringed())
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    if g.shape != w.shape or not torch.equal(g, w):
                        fail(f"(b) {name}: call {i} (delay {cycles} cycles a step) "
                             "differs from the gather twin")
                if got_c is not None and float(got_c) != float(want_c):
                    fail(f"(b) {name}: call {i}: max congestion {float(got_c)} "
                         f"against {float(want_c)}")
                delays.append(cycles)
        finally:
            ring.POISON = False
            ring.BEFORE_STEP = None
        log(f"(b) {name}: {calls} calls of a poisoned exchange delayed by "
            f"{sorted(set(delays))} cycles a step, each bit-equal to the gather "
            "twin and to one device")

    # (c) the overlap, from the exchange's events
    per_ms = sleep_cycles_per_ms()
    summary["trace"] = {name: trace_overlap(name, fns[0], per_ms)
                        for name, fns in consumers.items()}

    # (d) overlapped walls against the serial equivalent
    blocks_ch = sp_routes._row_blocks(next_hop, mesh)
    v_ch = blocks_ch[0].shape[1]
    wire16 = v_ch <= ring.NEXT_WIRE_MAX_V

    def chase_exchange():
        return ring.RingExchange(
            [ring.pack_next_wire(x) if wire16 else x for x in blocks_ch])

    landed_ch = chase_exchange()
    landed_ch.join()
    adj, dist_nh, _, max_degree = nh_args[:4]
    n_occ = nh_kw.get("n_occ", 0)
    v_nh = adj.shape[0]
    n_cols = v_nh if n_occ <= 0 else min(v_nh, n_occ)
    block = sp_apsp._column_block(n_cols, v_nh // N_SHARDS, max_degree, v_nh, True)
    starts = range(0, n_cols, block)

    def column_exchanges():
        start = sp_apsp.column_exchanges(dist_nh, n_cols, block)
        exs = {c: start(c) for c in starts}
        for ex in exs.values():
            ex.join()
        return exs

    landed_nh = column_exchanges()

    def consume_columns():
        rpn, tables = sp_apsp._tables(adj, mesh, max_degree)
        return sp_apsp.next_hops_from_columns(
            tables, dist_nh, rpn, n_cols, block,
            lambda c: [ring.unpack_dist_wire(landed_nh[c].view(q))
                       for q in range(N_SHARDS)])

    d_rep = p["dist"]
    parts = {
        "chase": (
            lambda: chase_exchange().join(),
            lambda: sp_routes.chase_exchange(lambda: landed_ch, port, src, dst, fport,
                                             max_len, mesh, v_ch)),
        "next hops": (column_exchanges, consume_columns),
        "collective": (
            lambda: ring.finish_distance_exchange(ring.start_distance_exchange(dist_sh)),
            lambda: sp_routes.route_collective_sharded(
                *p["args"], mesh, dist=d_rep, ring_exchange=False, **kw)),
    }
    got_c, _ = flat(parts["chase"][1]())
    want_c, _ = flat(consumers["chase"][1]())
    if not all(torch.equal(g, w) for g, w in zip(got_c, want_c)):
        fail("(d) the chase on a landed exchange differs from the gather twin")
    walls = {}
    for name, (ringed, _, _) in consumers.items():
        exch, cons = parts[name]
        # in turns (overlapped, exchange, consumer; then reversed), the
        # median of each over both rounds: the host's clock drifts
        runs = {"overlapped_ms": [], "exchange_ms": [], "consumer_ms": []}
        built, launched = ring.StepPlan.builds, ring.ring_step.launches
        for order in ((ringed, exch, cons), (cons, exch, ringed)):
            for fn in order:
                key = ("overlapped_ms" if fn is ringed else
                       "exchange_ms" if fn is exch else "consumer_ms")
                runs[key].append(wall_ms(fn))
        w = {key: statistics.mean(x) for key, x in runs.items()}
        # the exchanges of these runs, and the plans among them that built
        # their calls rather than reuse them
        w["exchanges"] = (ring.ring_step.launches - launched) // (max(ring.ring_legs(
            N_SHARDS)) + 1)
        w["plans_built"] = ring.StepPlan.builds - built
        w["serial_ms"] = w["exchange_ms"] + w["consumer_ms"]
        w["overlap_gain"] = w["serial_ms"] / w["overlapped_ms"]
        walls[name] = w
        # what explains the ratio: the call's device busy share
        wall, busy, rows = profile_device(ringed)
        log_profile(f"(d) {name}, overlapped", wall, busy, rows, top=4)
        w["profiled_wall_ms"], w["device_busy_ms"] = wall, busy
        log(f"(d) {name}: overlapped {w['overlapped_ms']:.3f} ms; serial "
            f"{w['serial_ms']:.3f} ms (the exchange alone {w['exchange_ms']:.3f} + "
            f"the consumer on landed data {w['consumer_ms']:.3f}); overlap_gain "
            f"{w['overlap_gain']:.3f}; {w['plans_built']} of {w['exchanges']} "
            f"exchanges built their step calls, the rest reused them ({CARD})")
    nh = walls["next hops"]
    gain = engine.note_exchange_overlap(nh["serial_ms"] / 1e3, nh["overlapped_ms"] / 1e3)
    sp_hier._m_exchange_s.observe(nh["exchange_ms"] / 1e3)
    if engine._m_shard_overlap.value != gain or sp_hier._m_exchange_s.count < 1:
        fail("(d) shard_exchange_overlap_gain / shard_exchange_seconds not set")
    log(f"(d) shard_exchange_overlap_gain = {engine._m_shard_overlap.value:.3f} "
        f"(the refresh leg); shard_exchange_seconds observed "
        f"{sp_hier._m_exchange_s.count} time(s), sum {sp_hier._m_exchange_s.sum:.6f} s")
    summary["walls"] = walls

    # (e) the consumers' walls over CTA counts and stream priorities: the
    # step launches take the sweep's CTA count, and the exchange forks
    # onto a stream of the sweep's priority
    grid = {}
    plan_init, stream_of = ring.StepPlan.__init__, ring.exchange_stream
    try:
        for prio in STEP_SWEEP_PRIORITIES:
            st = torch.cuda.Stream(device, priority=prio)
            ring.exchange_stream = lambda _dev, st=st: st
            for ctas in (16, 32, 64, 128):
                ring.StepPlan.__init__ = (
                    lambda self, b, v, _c=None, ctas=ctas, **kw: plan_init(
                        self, b, v, ctas, **kw))
                row = {name: wall_ms(consumers[name][0], n=5)
                       for name in ("chase", "next hops")}
                grid[f"{ctas}/{prio}"] = row
                log(f"(e) {ctas} CTAs, exchange priority {prio}: chase "
                    f"{row['chase']:.3f} ms, next hops {row['next hops']:.3f} ms "
                    f"({CARD})")
    finally:
        ring.StepPlan.__init__, ring.exchange_stream = plan_init, stream_of
    summary["sweep"] = {"steps": sweep, "walls": grid}

    # (f) host syncs inside the ringed legs
    summary["syncs"] = {name: len(sync_report(name, fns[0]))
                        for name, fns in consumers.items()}

    # (g) the ring re-route's first call after a refresh, split
    d1, d2 = int(t.dpids[0]), int(t.dpids[1])

    def reroute():
        return db.find_routes_batch_delta_dispatch(pairs, [d1, d2]).reap()

    def once(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    split = {}
    for when in ("first", "steady"):
        if when == "first":
            db._version += 1
            oracle.refresh(db)
        what = f"(g) ring re-route, {when} call after a refresh"
        wall, busy, rows = profile_device(
            lambda: log_host_profile(what, reroute, top=10))
        split[when] = {"wall_ms": wall, "device_busy_ms": busy}
        log_profile(what, wall, busy, rows)
    for mode in (True, False):
        oracle.ring_exchange = mode
        db._version += 1
        oracle.refresh(db)
        name = "ring" if mode else "gather"
        split[f"{name}_first_ms"] = once(reroute)
        split[f"{name}_second_ms"] = once(reroute)
    oracle.ring_exchange = True
    db._version += 1
    oracle.refresh(db)
    split["host_twin_ms"] = once(lambda: oracle._dist)
    split["first_after_twin_ms"] = once(reroute)
    log(f"(g) re-route after a refresh, unprofiled: ring first "
        f"{split['ring_first_ms']:.1f} ms, second {split['ring_second_ms']:.1f} ms; "
        f"gather first {split['gather_first_ms']:.1f} ms, second "
        f"{split['gather_second_ms']:.1f} ms; "
        f"after another refresh the host distance twin alone "
        f"{split['host_twin_ms']:.1f} ms, then the first re-route "
        f"{split['first_after_twin_ms']:.1f} ms ({CARD})")
    summary["reroute"] = split
    del db, one, oracle, one_oracle, p, landed_ch, landed_nh, consumers, parts
    collect("phase 26")
    log(f"phase 26 summary ({CARD}): " + json.dumps(summary, default=str))
    return summary


#: phase 27: the processes of the mesh, the seconds each has to answer
#: (also its group's timeout), the calls each time takes, and the calls
#: of the ordering hold with their delays (torch.cuda._sleep cycles)
MP_PROCESSES = 2
MP_TIMEOUT_S = 300.0
MP_REPS = 10
MP_HOLD_CALLS = 8
MP_DELAYS = (0, 200_000, 1_000_000, 3_000_000)


def digest(*arrays) -> str:
    """sha256 of arrays' shapes, dtypes and bytes: equal digests are
    bit-equal arrays."""
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.shape}{a.dtype}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def mp_path(device, k: int, n_ranks: int, n_window: int) -> tuple:
    """Phase 27's path on config 13, as each process of a mesh (or one
    process alone) runs it through the port's entry points: the sharded
    refresh in ring mode and again in gather mode, an ``n_window``-pair
    window in each mode, and ``route_collective_sharded`` on the edge
    flows in each mode (cached row-sharded distances, the destination
    set); then the routing legs: ``route_flows_sharded`` on the edge
    flows from the row-sharded distances, ``multichip_route_step``,
    ``find_routes_batch_adaptive`` on the window's pairs (the sharded
    UGAL program through the engine) and the mesh-only refresh of a
    ``TopologyDB(mesh_devices=8)`` without ``shard_oracle``. Returns (the
    digest of every host result, walls in ms)."""
    import torch

    from sdnmpi_tpu_torch.oracle.congestion import scan_form
    from sdnmpi_tpu_torch.shardplane import (
        multichip_route_step,
        route_collective_sharded,
        route_flows_sharded,
    )
    from sdnmpi_tpu_torch.shardplane.mesh import gather_host
    from sdnmpi_tpu_torch.topogen import fattree

    spec = fattree(k)
    db = spec.to_topology_db(backend="torch", device=device, pad_multiple=SHARD_PAD,
                             mesh_devices=N_SHARDS, shard_oracle=True,
                             ring_exchange=True)
    oracle = db._oracle_engine()
    got, walls = {}, {}

    def timed(what, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[what] = (time.perf_counter() - t0) * 1e3
        return out

    for ring_mode in (True, False):
        mode = "ring" if ring_mode else "gather"
        oracle.ring_exchange = ring_mode
        oracle._version = None  # a full refresh in this mode
        t = timed(f"refresh {mode}", lambda: oracle.refresh(db))
        got[f"distances ({mode} refresh)"] = digest(oracle._dist)
        got[f"next hops ({mode} refresh)"] = digest(oracle._next)
    hosts = [m for m, _, _ in spec.hosts[:n_ranks]]
    rng = np.random.default_rng(25)
    a = rng.integers(0, len(hosts), n_window)
    b = (a + 1 + rng.integers(0, len(hosts) - 1, n_window)) % len(hosts)
    pairs = [(hosts[i], hosts[j]) for i, j in zip(a, b)]
    flows = edge_flows(spec, t, n_ranks, oracle.device)
    levels = int(oracle._dist[np.isfinite(oracle._dist)].max())
    mesh = oracle._shard_mesh()
    for ring_mode in (True, False):
        mode = "ring" if ring_mode else "gather"
        oracle.ring_exchange = ring_mode
        w = timed(f"window {mode}", lambda: db.find_routes_batch_dispatch(pairs).reap())
        got[f"window ({mode})"] = digest(w.hop_dpid, w.hop_port, w.hop_len)
        slots, maxc = timed(f"collective {mode}", lambda: route_collective_sharded(
            *flows["args"], mesh, levels=levels, rounds=ROUNDS, max_len=levels + 1,
            dist=oracle._dist_d, dst_nodes=flows["dst_nodes"], ring_exchange=ring_mode,
            neigh=t.neigh))
        got[f"collective slots ({mode})"] = digest(gather_host(slots, mesh),
                                                   np.float32(maxc.item()))
    # the routing legs: the greedy balancer per shard (S1), its loads
    # summed over the processes by K3
    put = lambda a: torch.as_tensor(a).to(oracle.device)  # noqa: E731
    base = torch.zeros((t.v, t.v), dtype=torch.float32, device=oracle.device)
    flow_args = (put(flows["src"]), put(flows["dst"]), put(flows["weight"]), mesh,
                 levels + 1)
    for name, fn in (
        ("route_flows_sharded", lambda: route_flows_sharded(
            t.adj, oracle._dist_d, base, *flow_args, neigh=t.neigh)),
        ("multichip_route_step", lambda: multichip_route_step(
            t.adj, base, *flow_args, neigh=t.neigh)),
    ):
        nodes, load, maxc = timed(name, fn)
        got[name] = digest(gather_host(nodes, mesh), load.cpu().numpy(),
                           np.float32(maxc.item()))
    # the form each process's shards take (the spread form's cooperative
    # launch synchronises one process's grid only)
    got["S1 form of a shard"] = scan_form(t.v, t.neigh.shape[1], 1024,
                                          len(flows["src"]) // N_SHARDS)
    fdbs, detours, cong = timed("adaptive batch", lambda: db.find_routes_batch_adaptive(
        pairs))
    got["adaptive batch (shard_oracle)"] = digest(
        np.frombuffer(json.dumps([fdbs, detours, cong]).encode(), np.uint8))
    del db, oracle
    mesh_only = spec.to_topology_db(backend="torch", device=device,
                                    pad_multiple=SHARD_PAD, mesh_devices=N_SHARDS)
    plain = mesh_only._oracle_engine()
    timed("mesh-only refresh", lambda: plain.refresh(mesh_only))
    got["mesh-only refresh"] = digest(plain._dist, plain._next)
    return got, walls


def time_calls(fn, reps: int = MP_REPS) -> dict:
    """``fn()`` ``reps`` times after one warm call: the host's enqueue and
    wall (to a synchronize) and the device span between CUDA events
    around the calls, each per call in ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"enqueue_ms": enqueue * 1e3 / reps, "wall_ms": wall * 1e3 / reps,
            "device_ms": start.elapsed_time(end) / reps}


def mp_hold_ring(mesh) -> dict:
    """K3 and its step form across the processes of ``mesh`` at config
    13's shapes (``[V/8, V]`` int32 next-hop rows, their int16 wire, f32
    and bf16 rows), each process launching for its own sources and
    storing into every shard's output or view: every output and view of
    this process equal to the plain versions on all eight blocks (the
    views start poisoned). Then both timed per call beside the same call
    on a mesh of this process alone (rank 0 only, the others waiting),
    with the host's enqueue apart. Returns the times."""
    import torch
    import torch.distributed as dist

    from sdnmpi_tpu_torch.kernels import ring
    from sdnmpi_tpu_torch.shardplane import make_mesh
    from sdnmpi_tpu_torch.shardplane.mesh import all_gather_cpu

    dev = mesh.device
    s, b = mesh.n_shards, SHARD_V // mesh.n_shards
    gen = torch.Generator(device=dev).manual_seed(27)  # the same in every process
    times = {}
    for dtype in (torch.int32, torch.int16, torch.float32, torch.bfloat16):
        full = torch.randint(-2 ** 15, 2 ** 15, (s * b, SHARD_V), generator=gen,
                             device=dev, dtype=torch.int32).to(dtype)
        every = list(full.split(b))
        blocks = [x if q in mesh.local else None for q, x in enumerate(every)]
        want = ring.ring_all_gather_plain(every)
        got = ring.ring_all_gather(blocks, mesh)
        views = torch.empty((s, s * b, SHARD_V), dtype=dtype, device=dev)
        for t in range(max(ring.ring_legs(s)) + 1):
            ring.ring_step_plain(every, views, t)
        ring.POISON = True
        try:
            ex = ring.RingExchange(blocks, mesh)
            ex.join()
        finally:
            ring.POISON = False
        torch.cuda.synchronize()
        for k, q in enumerate(mesh.local):
            if not torch.equal(got[q], want[q]):
                fail(f"K3 across processes ({dtype}): shard {q} differs from the plain version")
            if not torch.equal(ex.views[k], views[q]):
                fail(f"step form across processes ({dtype}): shard {q}'s view differs "
                     "from the plain steps")
        log(f"process {mesh.rank}: K3 and its step form across {mesh.n_processes} "
            f"processes, {s} blocks of ({b}, {SHARD_V}) {dtype}: shards {mesh.local} "
            "equal to the plain versions")
        if dtype == torch.int16:  # the exchange's wire at config 13
            del got, ex
            times["K3 across processes"] = time_calls(
                lambda: ring.ring_all_gather(blocks, mesh))
            times["exchange across processes"] = time_calls(
                lambda: ring.RingExchange(blocks, mesh).join())
            # the host's part: the handshake's all_gather (an exchange's
            # payload: what the blocks agree on, a buffer and six event
            # handles) and the barrier
            payload = torch.zeros(32 + 7 * ring.IPC_HANDLE, dtype=torch.uint8)
            times["gloo all_gather of 480 B"] = time_calls(
                lambda: all_gather_cpu(payload, mesh))
            times["gloo barrier"] = time_calls(dist.barrier)
            if mesh.rank == 0:
                one = make_mesh(s, dev)
                times["K3 in one process"] = time_calls(
                    lambda: ring.ring_all_gather(every, one))
                times["exchange in one process"] = time_calls(
                    lambda: ring.RingExchange(every).join())
            dist.barrier()
    mp_hold_order(mesh)
    return times


def mp_hold_order(mesh) -> None:
    """The order across processes under delays: ``MP_HOLD_CALLS`` calls
    of K3 and of the exchange (views poisoned) on int32 blocks that
    change every call, with process 1's stores delayed
    (``torch.cuda._sleep`` before K3 and before each step) and process
    0's reads of each result delayed and then copied after its memory
    is handed out again to the next call. Every copy must equal the
    plain version of its own call: a read before the other process's
    stores landed, or a store into a buffer whose last readers had not
    finished, shows."""
    import torch

    from sdnmpi_tpu_torch.kernels import ring

    dev = mesh.device
    s, b = mesh.n_shards, SHARD_V // mesh.n_shards
    base = torch.arange(s * b * SHARD_V, device=dev, dtype=torch.int32).view(s * b, SHARD_V)
    copies = []
    ring.POISON = True
    try:
        for i in range(MP_HOLD_CALLS):
            cycles = MP_DELAYS[i % len(MP_DELAYS)]
            every = list((base + i).split(b))
            blocks = [x if q in mesh.local else None for q, x in enumerate(every)]
            late = mesh.rank == 1 and cycles
            ring.BEFORE_STEP = (lambda _t, c=cycles: torch.cuda._sleep(c)) if late else None
            if late:
                torch.cuda._sleep(cycles)
            got = ring.ring_all_gather(blocks, mesh)
            ex = ring.RingExchange(blocks, mesh)
            ex.join()
            if mesh.rank == 0 and cycles:
                torch.cuda._sleep(cycles)  # a slow reader of both results
            copies.append((i, [got[q] for q in mesh.local], ex.views))
            # the copies are taken once the next calls own this memory
            if len(copies) > 1:
                j, outs, views = copies[-2]
                copies[-2] = (j, [x.clone() for x in outs], views.clone())
            del got, ex
    finally:
        ring.POISON = False
        ring.BEFORE_STEP = None
    j, outs, views = copies[-1]
    copies[-1] = (j, [x.clone() for x in outs], views.clone())
    torch.cuda.synchronize()
    for i, outs, views in copies:
        every = list((base + i).split(b))
        want = ring.ring_all_gather_plain(every)
        want_views = torch.empty((s, s * b, SHARD_V), dtype=torch.int32, device=dev)
        for t in range(max(ring.ring_legs(s)) + 1):
            ring.ring_step_plain(every, want_views, t)
        for k, q in enumerate(mesh.local):
            if not torch.equal(outs[k], want[q]) or not torch.equal(views[k], want_views[q]):
                fail(f"process {mesh.rank}: call {i} of the delayed hold differs from "
                     f"the plain versions at shard {q}")
    log(f"process {mesh.rank}: {MP_HOLD_CALLS} delayed calls of K3 and the exchange "
        f"across processes (delays {MP_DELAYS} cycles), each equal to the plain "
        "versions of its own call")


def mp_hold_psum(mesh) -> dict:
    """The psum of the greedy balancer and the UGAL program across the
    processes of ``mesh`` at config 13's shapes: eight ``[V, V]`` parts
    (f32 loads; f64 traffic, on the wire as int32 pairs), made alike in
    every process, this process holding its shards' parts. K3's gather of
    every process's parts (``routes._parts_over_processes``, one copy a
    process) equal bit for bit to the parts and to the plain version on
    the processes' blocks, and the sum equal to the shard-order sum of
    the parts. Then the psum timed per call beside the same sum on a mesh
    of this process alone (rank 0 only, the others waiting), with its
    receive bytes; the pooled receive buffers must not grow over the
    timed calls. Returns the times."""
    import torch
    import torch.distributed as dist

    from sdnmpi_tpu_torch.kernels import ring
    from sdnmpi_tpu_torch.shardplane import make_mesh, routes

    dev = mesh.device
    s, v = mesh.n_shards, SHARD_V
    gen = torch.Generator(device=dev).manual_seed(28)  # the same in every process
    times = {}
    for dtype in (torch.float32, torch.float64):
        every = [torch.randint(0, 64, (v, v), generator=gen, device=dev).to(dtype) / 8
                 for _ in range(s)]
        parts = [x if q in mesh.local else None for q, x in enumerate(every)]
        got = routes._parts_over_processes(parts, mesh)
        per = len(mesh.local)
        wire = [torch.stack([x.reshape(-1) for x in every[p * per:(p + 1) * per]])
                for p in range(mesh.n_processes)]
        if dtype == torch.float64:
            wire = [w.view(torch.int32) for w in wire]
        plain = ring.ring_all_gather_plain(wire)[mesh.rank]
        total = routes._sum_over_shards(parts, mesh)
        want = every[0]
        for x in every[1:]:
            want = want + x
        torch.cuda.synchronize()
        if not all(torch.equal(g, x) for g, x in zip(got, every)):
            fail(f"psum across processes ({dtype}): a part differs after K3")
        back = torch.stack(got).reshape(plain.shape[0], -1).view(plain.dtype)
        if not torch.equal(back, plain):
            fail(f"psum across processes ({dtype}): K3 differs from the plain version")
        if not torch.equal(total, want):
            fail(f"psum across processes ({dtype}): the sum differs from the shard-order sum")
        nbytes = s * v * v * every[0].element_size()
        what = f"psum of {s} [{v}, {v}] {dtype} parts"
        log(f"process {mesh.rank}: {what} across {mesh.n_processes} processes: K3 "
            f"equal to the plain version and to the parts, the sum to the shard-order "
            f"sum; {nbytes:,} B received a process")
        del got, total, back
        pooled = len(ring._ALLOCATED)
        times[f"{what} ({nbytes:,} B received a process)"] = time_calls(
            lambda: routes._sum_over_shards(parts, mesh))
        if len(ring._ALLOCATED) != pooled:
            fail(f"process {mesh.rank}: {what}: the receive buffers grew from {pooled} "
                 f"to {len(ring._ALLOCATED)} over {MP_REPS + 1} calls")
        if mesh.rank == 0:
            one = make_mesh(s, dev)
            times[f"{what} in one process"] = time_calls(
                lambda: routes._sum_over_shards(every, one))
        dist.barrier()
        del every, parts, wire, plain
    torch.cuda.empty_cache()
    return times


def mp_worker(rank: int, world: int, port: int, device: str, kw: dict, out_q) -> None:
    """One process of phase 27: join the group, put its shards on
    ``device`` (``"cuda"``: the card of its rank), hold the ring kernels
    across processes, run :func:`mp_path` with the launch counts zeroed
    just before and read just after, and put ``(rank, "ok", result)`` or
    ``(rank, "error", traceback)`` on ``out_q``."""
    import traceback

    try:
        import torch

        from sdnmpi_tpu_torch.kernels import _build, ring
        from sdnmpi_tpu_torch.shardplane import make_multihost_mesh
        from sdnmpi_tpu_torch.shardplane.mesh import init_multihost

        init_multihost(f"127.0.0.1:{port}", world, rank, timeout_s=MP_TIMEOUT_S)
        _build.load_all()  # built by the parent
        mesh = make_multihost_mesh(N_SHARDS, device=device)
        times = mp_hold_ring(mesh)
        times.update(mp_hold_psum(mesh))
        zero_launches()
        digests, walls = mp_path(mesh.device, **kw)
        torch.cuda.synchronize()
        counts = read_launches()
        ring.close_exchanges()
        out_q.put((rank, "ok", dict(digests=digests, walls=walls, times=times,
                                    launches=counts, local=mesh.local,
                                    device=str(mesh.device))))
    except BaseException:
        out_q.put((rank, "error", traceback.format_exc()))
        raise


def run_workers(target, device, kw: dict, what: str) -> dict:
    """Spawn ``MP_PROCESSES`` processes running ``target(rank, world,
    port, device type, kw, queue)`` as one gloo group on a free local
    port, and return each one's result by rank; a process that fails or
    gives no answer within ``MP_TIMEOUT_S`` fails the run, and every
    process is ended before this returns."""
    import multiprocessing
    import queue
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, MP_PROCESSES, port, device.type, kw,
                                              out_q))
             for r in range(MP_PROCESSES)]
    for p in procs:
        p.start()
    answers, error = {}, None
    deadline = time.monotonic() + MP_TIMEOUT_S
    try:
        while len(answers) < MP_PROCESSES and error is None:
            try:
                rank, status, out = out_q.get(timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                error = f"no answer within {MP_TIMEOUT_S:.0f} s"
                break
            if status != "ok":
                error = f"process {rank} failed:\n{out}"
            answers[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30 if error is None else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if error is not None:
        fail(f"{what}: {error}")
    return answers


def phase_multiprocess(device, report: dict, k: int = SHARD_K, n_ranks: int = SHARD_RANKS,
                       n_window: int = LEGS_WINDOW) -> list:
    """Config 13 (fattree(56), V = 3,968, 8 shards) uncut on a mesh over
    two processes of this card, 4 shards each (``make_multihost_mesh``
    over a gloo group): both spawned processes hold K3 and its step form
    with stores into the other process's buffers against their plain
    versions and time them beside one process; then run :func:`mp_path`,
    every digest of which must equal this process's single-process run.
    Returns the workers' launch counts of the path."""
    import torch

    kw = dict(k=k, n_ranks=n_ranks, n_window=n_window)
    t0 = time.perf_counter()
    want, walls = mp_path(device, **kw)
    log(f"phase 27: one process's path, walls {fmt_walls(walls)} ({CARD})")
    gc.collect()
    torch.cuda.empty_cache()
    answers = run_workers(mp_worker, device, kw, "phase 27")
    counts = []
    for rank in range(MP_PROCESSES):
        got = answers[rank]
        for key, value in want.items():
            if got["digests"].get(key) != value:
                fail(f"phase 27: process {rank}'s {key} differs from one process's")
        log(f"phase 27, process {rank} (shards {got['local']} on {got['device']}): "
            f"{len(want)} results bit-equal to one process ({', '.join(want)}); "
            f"walls {fmt_walls(got['walls'])}")
        require_launched(got["launches"], ("ring_all_gather", "ring_step", "sampler_tables",
                                           "sample_slots", "route_flows_balanced"),
                         f"phase 27 process {rank}")
        log(f"phase 27, process {rank}: times a call: K3 and the exchange on 8 blocks of "
            f"({SHARD_V // N_SHARDS}, {SHARD_V}) int16, the psums on 8 parts "
            f"({CARD}; two processes time-sliced on one card, not an NVLink time):")
        for what, tm in got["times"].items():
            log(f"  {what}: enqueue {tm['enqueue_ms']:.4f} ms, wall {tm['wall_ms']:.4f} "
                f"ms, device span {tm['device_ms']:.4f} ms")
        counts.append(got["launches"])
    log(f"phase 27: {time.perf_counter() - t0:.1f} s")
    return counts


# -- phase 28: the hier oracle on a mesh over two processes (config 15) -----


def hier_mp_path(device, k: int, pods: int, n_ranks: int) -> tuple:
    """Phase 28's path on config 15, as each process of a mesh over
    processes runs it: the DB build, the cold refresh (pod blocks and
    level 2), the border plane as the ring exchanges it, the first and a
    steady route of phase 24's alltoall, one intra-pod flap's repair
    refresh and the route after it. Returns (the digest of every result,
    in phase 24's names, and walls in ms)."""
    import torch

    from sdnmpi_tpu_torch.topogen import fattree

    walls = {}

    def timed(what, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[what] = (time.perf_counter() - t0) * 1e3
        return out

    spec = fattree(k, pods=pods, hosts_per_edge=1)
    db = timed("DB build", lambda: spec.to_topology_db(
        device=device, hier_oracle=True, mesh_devices=N_SHARDS, ring_exchange=True))
    hosts = sorted(db.hosts)
    macs = hosts[::max(1, len(hosts) // n_ranks)][:n_ranks]
    si, di = alltoall_idx(len(macs))
    oracle = db._oracle_engine()
    state = timed("cold refresh", lambda: oracle.refresh(db))
    got = hier_state_digests(state)
    got["border plane"] = timed("border plane", lambda: hier_plane_digest(state))

    def route():
        return db.find_routes_collective(macs, si, di, policy="shortest")

    got["first route"] = hier_route_digest(timed("first route", route))
    got["steady route"] = hier_route_digest(timed("steady route", route))
    flip_cable(db, intra_pod_cable(spec), add=False)
    state = timed("intra-pod flap refresh", lambda: oracle.refresh(db))
    got.update({f"{key} after the flap": value
                for key, value in hier_state_digests(state).items()})
    got["route after the flap"] = hier_route_digest(timed("route after the flap", route))
    return got, walls


def mp_hier_worker(rank: int, world: int, port: int, device: str, kw: dict,
                   out_q) -> None:
    """One process of phase 28: join the group, run :func:`hier_mp_path`
    with the launch counts zeroed just before and read just after, and
    put ``(rank, "ok", result)`` or ``(rank, "error", traceback)`` on
    ``out_q``."""
    import traceback

    try:
        import torch

        from sdnmpi_tpu_torch.kernels import _build, ring
        from sdnmpi_tpu_torch.shardplane.mesh import init_multihost

        init_multihost(f"127.0.0.1:{port}", world, rank, timeout_s=MP_TIMEOUT_S)
        _build.load_all()  # built by the parent
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        digests, walls = hier_mp_path(device, **kw)
        torch.cuda.synchronize()
        counts = read_launches()
        ring.close_exchanges()
        out_q.put((rank, "ok", dict(digests=digests, walls=walls, launches=counts,
                                    peak=torch.cuda.max_memory_allocated())))
    except BaseException:
        out_q.put((rank, "error", traceback.format_exc()))
        raise


def phase_hier_multiprocess(device, report: dict, k: int = HIER_K, pods: int = HIER_PODS,
                            n_ranks: int = HIER_RANKS) -> list:
    """Config 15 (fattree(64, pods=1008), 65,536 switches) uncut through
    the hierarchical oracle on a mesh over two processes of this card,
    4 of 8 shards each, the ring on: both spawned processes run
    :func:`hier_mp_path`, every digest of which must equal phase 24's
    single-process result. Returns the workers' launch counts."""
    want = report.get("hier digests")
    if not want:
        fail("phase 28: phase 24 left no digests to hold the processes against")
    t0 = time.perf_counter()
    answers = run_workers(mp_hier_worker, device,
                          dict(k=k, pods=pods, n_ranks=n_ranks), "phase 28")
    counts = []
    for rank in range(MP_PROCESSES):
        got = answers[rank]
        for key, value in want.items():
            if got["digests"].get(key) != value:
                fail(f"phase 28: process {rank}'s {key} differs from phase 24's")
        log(f"phase 28, process {rank}: {len(want)} results bit-equal to phase 24's one "
            f"process ({', '.join(want)}); walls {fmt_walls(got['walls'])}; peak "
            f"{got['peak']:,} B allocated ({CARD}; two processes time-sliced on one "
            "card, not an NVLink time)")
        require_launched(got["launches"], ("ring_all_gather",), f"phase 28 process {rank}")
        for name in ("bfs_distances", "sampler_tables", "sample_slots"):
            if got["launches"][name]:
                fail(f"phase 28 process {rank}: the hierarchy launched {name}")
        counts.append(got["launches"])
    log(f"phase 28: {time.perf_counter() - t0:.1f} s")
    return counts


def fmt_walls(walls: dict) -> str:
    return ", ".join(f"{k} {v:.1f} ms" for k, v in walls.items())


def walled(fn):
    """``fn`` with the wall of each call logged: the phases' budget."""
    @functools.wraps(fn)
    def run(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            log(f"wall of {fn.__name__}: {time.perf_counter() - t0:.1f} s")

    return run


def main() -> int:
    import torch

    t_main = time.perf_counter()

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
    global CARD
    CARD = smi

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
    walled(phase_bfs)(device, report)
    walled(phase_kernels)(p, device, report)

    # phases 4 and 5: the two main paths, each with its launch counts
    slice_counts = walled(phase_slice)(FATTREE_K, N_RANKS, V_PAD, device, report)
    program_counts = walled(phase_program)(p, device)
    del p

    # phases 7 to 9: K3, then the sharded entry point and one program
    walled(phase_ring)(device, report)
    entry_counts, entry_err = walled(phase_sharded_entry)(device)
    shard_counts, shard_err = walled(phase_sharded_program)(device)
    report["sample_slots"]["max_abs_err"] = max(
        report["sample_slots"]["max_abs_err"], entry_err, shard_err)

    # phases 10 to 12: the UGAL program, the pair batches, the collective
    # policies
    ugal_counts = walled(phase_ugal_program)(device, report)
    batch_counts = walled(phase_pair_batches)(device, report)
    policy_counts = walled(phase_collective_policies)(device, report)

    # phases 13 and 14: the controller, from packet-in to FlowMods
    ctl_counts = walled(phase_controller_collective)(device, report)
    packet_in_counts = walled(phase_controller_packet_in)(device, report)
    collect("controller packet-in")

    # phases 15 to 17: the command line, the TCP southbound, serving;
    # the launcher's INFO lines go to stderr, the rest of its stack's
    # only from WARNING up
    logging.basicConfig(level=logging.WARNING,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    launcher_counts = walled(phase_launcher)(device, report)
    southbound_counts = walled(phase_southbound)(device, report)
    serving_counts = walled(phase_serving)(device, report)

    # phases 18 to 20: churn, the utilization plane, phased collectives
    churn_counts = walled(phase_churn)(device, report)
    collect("churn")
    plane_counts = walled(phase_utilplane)(device, report)
    collect("utilization plane")
    sched_counts = walled(phase_sched)(device, report)
    collect("phased collectives")

    # phases 21 to 23: the audit, the traffic plane and its sentinel;
    # the flight recorder, timeline, telemetry, traceview and SLOs
    # through the command line; chaos and the controller pair
    audit_counts = walled(phase_audit)(device, report)
    collect("audit")
    traffic_counts = walled(phase_traffic)(device, report)
    obs_counts = walled(phase_observability)(device, report)
    obs_counts += walled(serving_flight_cost)(device, report)
    chaos_counts = walled(phase_chaos)(device, report)
    pair_counts = walled(phase_pair)(device, report)
    collect("chaos and the pair")

    # phase 24: the hierarchical oracle at config 15
    hier_counts = walled(phase_hier)(device, report)
    collect("hier")

    # phase 25: the remaining sharded legs at config 13
    legs_counts = walled(phase_shard_legs)(device, report)
    collect("sharded legs")

    # phase 26: the overlapped exchange at config 13
    walled(phase_ring_overlap)(device, report)
    collect("overlapped exchange")

    # phase 27: config 13 on a mesh over two processes of this card
    mp_counts = walled(phase_multiprocess)(device, report)
    collect("processes")

    # phase 28: config 15's hier oracle on a mesh over two processes
    mp_counts += walled(phase_hier_multiprocess)(device, report)
    paths = (slice_counts, program_counts, entry_counts, shard_counts, ugal_counts,
             *batch_counts, *policy_counts, *ctl_counts, *packet_in_counts,
             *launcher_counts, *southbound_counts, *serving_counts,
             *churn_counts, *plane_counts, *sched_counts, *audit_counts,
             *traffic_counts, *obs_counts, *chaos_counts, *pair_counts,
             *hier_counts, *legs_counts, *mp_counts)
    launches = {n: sum(c[n] for c in paths) for n in slice_counts}

    # phase 6: report
    meta = {
        "bfs_distances": ("csrc/bfs.cu", "sdnmpi_tpu/kernels/bfs.py:130"),
        # K2's set-up: the XLA prep inside sample_slots_pallas
        "sampler_tables": ("csrc/sampler.cu", "sdnmpi_tpu/kernels/sampler.py:270"),
        "sample_slots": ("csrc/sampler.cu", "sdnmpi_tpu/kernels/sampler.py:245"),
        "ring_all_gather": ("csrc/ring.cu", "sdnmpi_tpu/kernels/ring.py:365"),
        # K3's step form: one step of the Pallas body (ring_stream's
        # ppermutes, ring.py:166-195, in the JAX twin)
        "ring_step": ("csrc/ring.cu", "sdnmpi_tpu/kernels/ring.py:251"),
        # S1 and S2 replace jitted lax.scan programs, not Pallas kernels
        "route_flows_balanced": ("csrc/scan.cu", "sdnmpi_tpu/oracle/congestion.py:56"),
        "pack_greedy": ("csrc/pack.cu", "sdnmpi_tpu/sched/phases.py:126"),
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
    log(f"all phases: {time.perf_counter() - t_main:.1f} s")
    # the card's name and power limit again, beside the numbers they qualify
    log(smi)
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

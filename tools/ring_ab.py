"""Time K3's step-form exchange and phase 25's warm_serving calls of the
port in one checkout, so that two checkouts can be compared on one card.

    python3 tools/ring_ab.py [ROOT] [--passes N] [--split]

ROOT (default: the checkout that holds this script) is the directory with
the ``sdnmpi_tpu_torch`` package and the ``chip_smoke.py`` to measure.
The script builds ROOT's kernels, then:

- times one ``RingExchange`` of config 13's next-hop wire (8 blocks of
  [496, 3968] int16): its host enqueue (median of 20 calls, the device
  synchronized before each), its device time (CUDA events) and its wall
  (enqueue to synchronize), beside one ``torch._foreach_copy_`` of the
  same 64 block copies;
- runs ROOT's phase 25 (``chip_smoke.phase_shard_legs``) N times (2 by
  default) in this process and records the wall of every
  ``warm_serving`` call; with ``--split`` each such call also runs under
  cProfile (its top Python functions by own time) and torch.profiler
  (the device's busy time), and the time spent in gc collections is
  summed.

It prints the card's name and power limit, then one JSON line. To compare
a parent with a change, unpack the parent into a git-ignored directory
and run the script for parent, change, change, parent in one call on the
card. It needs one CUDA card.
"""

from __future__ import annotations

import argparse
import cProfile
import gc
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: config 13's next-hop wire: 8 shards of 496 rows, V = 3968, int16
SHARDS, ROWS, V = 8, 496, 3968


def exchange_times(ring, torch) -> dict:
    """The exchange's enqueue, device time and wall beside
    ``torch._foreach_copy_`` of its copies, in ms."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(16)
    x = torch.randint(-1, V, (V, V), generator=gen, device=dev, dtype=torch.int32)
    blocks = [x[q * ROWS:(q + 1) * ROWS].to(torch.int16).contiguous()
              for q in range(SHARDS)]
    views = torch.empty((SHARDS, SHARDS * ROWS, V), dtype=torch.int16, device=dev)
    dst, src = [], []
    for t in range(max(ring.ring_legs(SHARDS)) + 1):
        for me in range(SHARDS):
            for q, step in enumerate(ring.arrival_steps(me, SHARDS)):
                if step == t:
                    dst.append(views[me][q * ROWS:(q + 1) * ROWS])
                    src.append(blocks[q])

    def enqueue(fn, n=20):
        fn()
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(out)

    def device(fn, n=20):
        fn()
        out = []
        for _ in range(n):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)

    def wall(fn, n=20):
        fn()
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    def exchange():
        ring.RingExchange(blocks).join()

    def foreach():
        torch._foreach_copy_(dst, src)

    return {"copies": len(dst),
            "enqueue_ms": enqueue(lambda: ring.RingExchange(blocks)),
            "device_ms": device(exchange), "wall_ms": wall(exchange),
            "lib_enqueue_ms": enqueue(foreach), "lib_device_ms": device(foreach),
            "lib_wall_ms": wall(foreach)}


def split_call(fn, torch) -> tuple:
    """``fn()`` under cProfile and torch.profiler: (its result, wall ms,
    device busy ms, gc ms, the top 12 Python functions by own time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gc_ms, began = [0.0], [0.0]

    def on_gc(phase, _info):
        if phase == "start":
            began[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - began[0]) * 1e3

    prof = cProfile.Profile()
    gc.callbacks.append(on_gc)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
            t0 = time.perf_counter()
            prof.enable()
            out = fn()
            prof.disable()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        gc.callbacks.remove(on_gc)
    busy = sum(e.time_range.elapsed_us() / 1e3 for e in tp.events()
               if e.device_type == DeviceType.CUDA)
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:12]
    top = [{"own_ms": own * 1e3, "cum_ms": cum * 1e3, "calls": n,
            "where": f"{os.path.basename(path)}:{line} {name}"}
           for (path, line, name), (_, n, own, cum, _) in rows]
    return out, wall, busy, gc_ms[0], top


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=HERE)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ring_ab: no CUDA card", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    from sdnmpi_tpu_torch.core.topology_db import TopologyDB
    from sdnmpi_tpu_torch.kernels import _build, ring

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    chip_smoke.CARD = card
    result = {"root": root, "card": card, "build_s": _build.build()}
    result["exchange"] = exchange_times(ring, torch)

    warm = []
    plain = TopologyDB.warm_serving

    def recorded(self, *a, **kw):
        mode = "ring" if self._oracle_engine().ring_exchange else "gather"
        row = {"pass": len(warm) // 2, "mode": mode}
        if args.split:
            out, row["wall_ms"], row["device_busy_ms"], row["gc_ms"], row["top"] = (
                split_call(lambda: plain(self, *a, **kw), torch))
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = plain(self, *a, **kw)
            torch.cuda.synchronize()
            row["wall_ms"] = (time.perf_counter() - t0) * 1e3
        row["warm_s"] = out["warm_s"]
        warm.append(row)
        return out

    TopologyDB.warm_serving = recorded
    try:
        for _ in range(args.passes):
            chip_smoke.phase_shard_legs(torch.device("cuda", 0),
                                        {"sample_slots": {"max_abs_err": 0.0}})
    finally:
        TopologyDB.warm_serving = plain
    result["warm"] = warm
    print(card, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

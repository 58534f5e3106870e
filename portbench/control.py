"""The control of the correctness check: routes that break one guarantee
the configurations state, put in the program's place.

The guarantee is minimal paths. The control routes every pair of a
collective up to a switch of the fabric's top layer and back down (for a
fat-tree: through a core switch, picked by a hash of the pair's edge
switches), each half a shortest path by lowest-row steps, every hop a
real link with its real port, and reports its congestion truthfully. It
is the shortcut a faster router might take: a fixed up-down route table
in place of the balanced shortest-path DAG. Pairs whose shortest path
does not reach the top layer (the same edge switch, the same pod) come
out longer than shortest, so the check must read not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

runs the control at the cell's own size, on the cell's own jobs from
each seed, and prints what the reference reads for each job. It imports
nothing of the program.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Routes:
    """The program's collective form, as the reference reads it."""

    pair_sub: np.ndarray
    final_port: np.ndarray
    hop_dpid: np.ndarray
    hop_port: np.ndarray
    hop_len: np.ndarray
    max_congestion: float = 0.0


def _descend(fab, cur: np.ndarray, target: np.ndarray, steps: int) -> list:
    """Rows of a shortest walk from each ``cur`` to its ``target``,
    always to the lowest-row neighbour one hop nearer; a walk that has
    arrived stays put."""
    nbr = [np.nonzero(row >= 0)[0] for row in fab.port]
    width = max(len(n) for n in nbr)
    table = np.full((len(nbr), width), -1, np.int64)
    for i, n in enumerate(nbr):
        table[i, :len(n)] = n
    walk = [cur]
    for _ in range(steps):
        cand = table[cur]
        near = fab.dist[np.maximum(cand, 0), target[:, None]]
        good = (cand >= 0) & (near == fab.dist[cur, target][:, None] - 1)
        step = cand[np.arange(len(cur)), np.argmax(good, axis=1)]
        cur = np.where(cur == target, cur, step)
        walk.append(cur)
    return walk


def detour_routes(fab, hosts: np.ndarray, src: np.ndarray, dst: np.ndarray) -> Routes:
    """Every pair ``src -> dst`` (indices into ``hosts``, each endpoint's
    host) routed through the top layer (see the module's text)."""
    from portbench.reference import Pairs, judge_phase

    v = len(fab.dpids)
    s_sw = fab.host_sw[hosts][src]
    d_sw = fab.host_sw[hosts][dst]
    key = s_sw * v + d_sw
    seen = np.zeros(v * v, bool)
    seen[key] = True
    groups = np.nonzero(seen)[0]
    lookup = np.zeros(v * v, np.int64)
    lookup[groups] = np.arange(len(groups))
    gs, gd = groups // v, groups % v
    top = fab.top[(gs * 7919 + gd * 104729) % len(fab.top)]
    up = fab.dist[gs, top]
    down = fab.dist[top, gd]
    a = _descend(fab, gs, top, int(up.max()))
    b = _descend(fab, top, gd, int(down.max()))
    length = up + down + 1
    width = int(length.max())
    rows = np.full((len(groups), width), -1, np.int64)
    g = np.arange(len(groups))
    for h in range(width):
        in_up = h <= up
        from_up = np.stack(a)[np.minimum(h, len(a) - 1)]
        j = np.clip(h - up, 0, len(b) - 1)
        from_down = np.stack(b)[j, g]
        rows[:, h] = np.where(h < length, np.where(in_up, from_up, from_down), -1)
    hop_port = np.full(rows.shape, -1, np.int64)
    nxt = rows[:, 1:]
    live = nxt >= 0
    hop_port[:, :-1][live] = fab.port[rows[:, :-1][live], nxt[live]]
    routes = Routes(
        pair_sub=lookup[key].astype(np.int32),
        final_port=fab.host_port[hosts][dst].astype(np.int32),
        hop_dpid=np.where(rows >= 0, fab.dpids[np.maximum(rows, 0)], -1),
        hop_port=hop_port.astype(np.int32),
        hop_len=length.astype(np.int32),
    )
    _, load = judge_phase(fab, routes, Pairs.of(fab, hosts, src, dst))
    routes.max_congestion = float(load)
    return routes


def control_readings(root: pathlib.Path, workload: str, seed: int) -> list[dict]:
    """What the reference reads of the control's routes for each job of
    the cell at ``seed``."""
    from portbench import reference, traffic

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / entry["file"]).read_text())
    fabrics = importlib.import_module(f"portbench.fabrics.{cfg['fabric']['kind']}")
    fab = fabrics.reference_fabric(cfg["fabric"])
    jobs = traffic.make_jobs(traffic.load(root, cell["traffic"]), int(cfg["ranks"]),
                             fab, fabrics.placement(cfg["fabric"]),
                             float(cfg["link_capacity_bps"]), seed)
    out = []
    for job in jobs:
        routes = detour_routes(fab, job.hosts, job.src_idx, job.dst_idx)
        counts, load = reference.judge(
            fab, [(0, None, routes)], None,
            reference.Pairs.of(fab, job.hosts, job.src_idx, job.dst_idx))
        out.append({**counts, "max_link_load": load})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description="the control at a cell's own size")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from portbench.reference import LIMITS

    for seed in (int(s) for s in args.seeds.split(",")):
        readings = control_readings(ROOT, args.workload, seed)
        worst = {k: max(r[k] for r in readings) for k in LIMITS}
        fails = [k for k in LIMITS if worst[k] > LIMITS[k]]
        print(json.dumps({"workload": args.workload, "seed": seed, "jobs": len(readings),
                          "least_per_job": {k: min(r[k] for r in readings) for k in LIMITS},
                          "worst_per_job": worst, "fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

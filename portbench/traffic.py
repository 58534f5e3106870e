"""The one traffic generator: it reads a mix's parameters from
``portbench/traffic/<name>.json`` and makes a cell's jobs from the seed.

A mix names:

- ``pairs``: the collective's rank pairs. ``"every_ordered"`` is every
  ordered pair i != j, source-major (MPI_Alltoall). An object
  ``{"partner": "xor" | "add", "steps": "pow2" | [s, ...]}`` is
  one round per step s, round-major, each round pairing every rank i with
  ``i xor s`` or ``(i + s) mod N``: recursive doubling is xor over the
  powers of two, a ring is add over [1], a dissemination barrier add over
  the powers of two.
- ``jobs``: how many MPI jobs the cell cycles through.
- ``loop``: how requests are offered, the module ``portbench/loops/
  <loop>.py`` that runs the window (``"closed"``: one caller, the next
  request after the previous routes are on the host).
- ``placement``: ``{"kind": "block", "align": [...]}``. Job j puts rank r
  on host ``(offset_j + r) mod n_hosts``, a contiguous block as batch
  schedulers allocate. ``offset_j`` is a pod drawn from the seed times
  the hosts of a pod, plus ``align`` times the hosts of an edge switch.
- ``util``: ``{"max_share": x, "seed": s}``. Each job carries its own
  link utilization snapshot, the Monitor's ``(dpid, port) -> bps`` form:
  a draw from ``[0, x * capacity)`` on every directed switch link.

The jobs are the same for every seed, moved and reordered: job i of the
mix has the i-th align (dealt in turn) and a snapshot drawn from ``s``,
both as if placed at pod 0; the seed deals them out in another order and
moves each by whole pods, its snapshot with it (the fabric's symmetry,
``Placement.rows``). So a seed changes where and when the work lands,
not the work: the problems differ by a relabeling of the fabric.

The ranks come from the configuration (its ``ranks``): a mix is a
pattern, a deployment says how large its jobs are.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np


@dataclasses.dataclass
class Job:
    """One MPI job: its ranks' hosts and MACs, the collective's pairs as
    indices into them, and the link utilization routed against."""

    index: int
    shape: float  # the job's align: jobs of one align route alike
    hosts: np.ndarray  # [N] int64 host index of each rank
    macs: list  # [N] str
    src_idx: np.ndarray  # [F] int32, the job's own copy
    dst_idx: np.ndarray  # [F] int32, the job's own copy
    util: dict  # (dpid, port) -> bps


def load(root: pathlib.Path, name: str) -> dict:
    with open(root / "portbench" / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def rank_pairs(rule, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The collective's rank pairs ``(src, dst)``, each [F] int32."""
    if rule == "every_ordered":
        src, dst = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        keep = src != dst
        return src[keep].astype(np.int32), dst[keep].astype(np.int32)
    steps = rule["steps"]
    if steps == "pow2":
        if n & (n - 1):
            raise ValueError(f"pow2 steps need a power-of-two rank count, got {n}")
        steps = [1 << b for b in range(n.bit_length() - 1)]
    ranks = np.arange(n, dtype=np.int64)
    if rule["partner"] == "xor":
        if max(steps) >= n or n & (n - 1):
            raise ValueError("xor partners need a power-of-two rank count")
        part = [ranks ^ s for s in steps]
    elif rule["partner"] == "add":
        part = [(ranks + s) % n for s in steps]
    else:
        raise ValueError(f"unknown partner rule {rule['partner']!r}")
    src = np.tile(ranks, len(steps)).astype(np.int32)
    return src, np.concatenate(part).astype(np.int32)


def make_jobs(mix: dict, ranks: int, fab, place, capacity_bps: float,
              seed: int) -> list[Job]:
    """The cell's jobs: the mix's, dealt out and moved by the seed.
    ``place`` is the fabric's ``Placement``."""
    rng = np.random.default_rng(seed % (1 << 64))
    n_jobs = int(mix["jobs"])
    if mix["placement"]["kind"] != "block":
        raise ValueError(f"unknown placement {mix['placement']['kind']!r}")
    n_hosts = fab.n_hosts
    if ranks > n_hosts:
        raise ValueError(f"{ranks} ranks on {n_hosts} hosts")
    align = mix["placement"]["align"]
    aligns = [float(align[i % len(align)]) for i in range(n_jobs)]
    li, lj = fab.links()
    top = float(mix["util"]["max_share"]) * capacity_bps
    draws = np.random.default_rng(int(mix["util"]["seed"])).uniform(
        0.0, top, (n_jobs, len(li)))
    order = rng.permutation(n_jobs)
    pods = rng.integers(0, n_hosts // place.pod_hosts, n_jobs)
    src, dst = rank_pairs(mix["pairs"], ranks)
    jobs = []
    for j, (i, pod) in enumerate(zip(order.tolist(), pods.tolist())):
        offset = pod * place.pod_hosts + int(round(aligns[i] * place.edge_hosts))
        hosts = (offset + np.arange(ranks, dtype=np.int64)) % n_hosts
        rows = place.rows(pod)
        keys = zip(fab.dpids[rows[li]].tolist(), fab.port[rows[li], rows[lj]].tolist())
        jobs.append(Job(j, aligns[i], hosts, [fab.host_mac[h] for h in hosts],
                        src.copy(), dst.copy(), dict(zip(keys, draws[i].tolist()))))
    return jobs

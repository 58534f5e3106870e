"""Pod structure annotations for hierarchical routing.

Datacenter fabrics are *regular*: a fat-tree is pods of edge+aggregation
switches under a core layer, a dragonfly is groups of routers joined by
global links (Throughput-Optimized Networks at Scale, arxiv 2605.27963,
is the scale argument; FatPaths, arxiv 1906.10885, expresses the
inter-group layer as compact rules instead of stored rows). The
hierarchical oracle (oracle/hier.py) exploits exactly this structure —
dense kernels per pod block, a compressed border-skeleton layer between
pods — and a :class:`PodMap` is how a topology declares it:

- ``pod_of`` assigns every switch to exactly one pod (the topogen
  generators emit it natively; :func:`partition_pods` recovers one for
  arbitrary graphs);
- border sets and the inter-pod link table are *derived* from the live
  link set (:func:`border_sets` / :func:`inter_pod_links`) so they track
  topology churn instead of going stale — the PodMap's own invariants
  (every switch exactly one pod, border sets consistent with the
  inter-pod link table) are pinned by tests/test_topogen.py.

The map is an annotation, not a constraint: a ``TopologyDB`` without one
routes through the dense oracle unchanged, and the hierarchical oracle
falls back to :func:`partition_pods` when a fabric arrives unannotated
(wire-mode discovery, hand-built graphs).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional


@dataclasses.dataclass
class PodMap:
    """Pod assignment of a fabric's switches.

    ``pod_of`` maps every switch dpid to exactly one pod id in
    ``[0, n_pods)``. Everything else the hierarchical oracle needs —
    border sets, the inter-pod link table, per-pod member lists — is
    derived against the live link set, so the annotation cannot drift
    from the fabric it describes.
    """

    pod_of: dict[int, int]
    n_pods: int
    #: generator-certified structural fact: an intra-pod link ADD whose
    #: endpoints are both *interior* (non-border) provably never changes
    #: the pod's border-to-border distances. True for the fat-tree
    #: (pods are edge<->agg bipartite: any two aggs are already at
    #: distance 2 through every edge switch, and an interior add can
    #: only offer longer detours) and the dragonfly (groups are complete
    #: graphs: every router pair is already at distance 1). The route
    #: cache's narrowed link-add invalidation (core/topology_db.py
    #: ``narrowed_dirty_set``) keys on this; the partitioner fallback
    #: leaves it False — adds clear the cache, the always-sound default.
    intra_add_narrows: bool = False
    name: str = ""

    def members(self) -> list[list[int]]:
        """Per-pod sorted member dpids (every switch exactly once)."""
        out: list[list[int]] = [[] for _ in range(self.n_pods)]
        for dpid in sorted(self.pod_of):
            out[self.pod_of[dpid]].append(dpid)
        return out

    def covers(self, dpids: Iterable[int]) -> bool:
        """True when every dpid has a pod assignment."""
        return all(d in self.pod_of for d in dpids)

    def to_dict(self) -> dict:
        return {
            "pod_of": {str(k): v for k, v in self.pod_of.items()},
            "n_pods": self.n_pods,
            "intra_add_narrows": self.intra_add_narrows,
            "name": self.name,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PodMap":
        return cls(
            pod_of={int(k): int(v) for k, v in d["pod_of"].items()},
            n_pods=int(d["n_pods"]),
            intra_add_narrows=bool(d.get("intra_add_narrows", False)),
            name=d.get("name", ""),
        )


def border_sets(
    pod_of: dict[int, int], links: Iterable[tuple[int, int]], n_pods: int
) -> list[set[int]]:
    """Per-pod border sets derived from a directed (src, dst) dpid link
    iterable: a switch is a border of its pod iff it terminates at least
    one link whose far end lives in a different pod (or outside the
    map — an unpodded neighbor is conservatively 'another pod')."""
    borders: list[set[int]] = [set() for _ in range(n_pods)]
    for a, b in links:
        pa, pb = pod_of.get(a), pod_of.get(b)
        if pa == pb and pa is not None:
            continue
        if pa is not None:
            borders[pa].add(a)
        if pb is not None:
            borders[pb].add(b)
    return borders


def inter_pod_links(
    pod_of: dict[int, int],
    links: Iterable[tuple[int, int, int, int]],
) -> list[tuple[int, int, int, int]]:
    """The inter-pod link table: every directed (src_dpid, src_port,
    dst_dpid, dst_port) entry whose endpoints lie in different pods
    (entries touching an unpodded dpid are excluded — they are not
    routable through the hierarchy until the map covers them)."""
    out = []
    for a, pa, b, pb in links:
        qa, qb = pod_of.get(a), pod_of.get(b)
        if qa is None or qb is None or qa == qb:
            continue
        out.append((a, pa, b, pb))
    return out


def default_pod_target(n_switches: int) -> int:
    """Auto pod size of the partitioner fallback: ~sqrt(V) balances the
    dense per-pod blocks against the border-skeleton layer (both scale
    as O(pods * pod_size^2) when pod_size ~ sqrt(V)), floored so tiny
    test fabrics become one pod plus change instead of confetti."""
    return max(4, int(round(math.sqrt(max(1, n_switches)))))


def partition_pods(
    dpids: Iterable[int],
    neighbors: dict[int, Iterable[int]],
    target_size: int = 0,
    name: str = "partitioned",
) -> PodMap:
    """Recover a :class:`PodMap` for an arbitrary graph — the fallback
    the hierarchical oracle uses when a fabric arrives unannotated.

    Deterministic greedy BFS growth: seed each pod at the smallest
    unassigned dpid, grow breadth-first over sorted neighbors until the
    pod reaches ``target_size`` (0 = :func:`default_pod_target`), then
    seed the next pod. Connected regions produce contiguous pods (the
    property that keeps intra-pod paths short); disconnected leftovers
    each seed their own pod. Every switch lands in exactly one pod.
    """
    universe = set(dpids)
    order = sorted(universe)
    if target_size <= 0:
        target_size = default_pod_target(len(order))
    pod_of: dict[int, int] = {}
    pod = 0
    for seed in order:
        if seed in pod_of:
            continue
        frontier = [seed]
        size = 0
        while frontier and size < target_size:
            nxt: list[int] = []
            for node in frontier:
                if node in pod_of:
                    continue
                pod_of[node] = pod
                size += 1
                if size >= target_size:
                    break
                for nb in sorted(neighbors.get(node, ())):
                    # the neighbor map may mention dpids outside the
                    # universe (a caller's raw adjacency); never grow
                    # a pod past the switch set itself
                    if nb in universe and nb not in pod_of:
                        nxt.append(nb)
            frontier = nxt
        pod += 1
    return PodMap(pod_of=pod_of, n_pods=pod, name=name)


def podmap_for_db(db, target_size: int = 0) -> Optional[PodMap]:
    """The PodMap the hierarchical oracle should route ``db`` with: the
    annotation the topology carries when it covers every live switch
    dpid, else a deterministic :func:`partition_pods` fallback over the
    current graph (annotation staleness — e.g. a discovered switch the
    generator never knew — falls back whole rather than guessing)."""
    dpid_set = set(db.switches)
    for src, dst_map in db.links.items():
        dpid_set.add(src)
        dpid_set.update(dst_map)
    for host in db.hosts.values():
        dpid_set.add(host.port.dpid)
    if not dpid_set:
        return None
    annotated = getattr(db, "podmap", None)
    if annotated is not None and annotated.covers(dpid_set):
        return annotated
    neighbors: dict[int, list[int]] = {}
    for src, dst_map in db.links.items():
        neighbors.setdefault(src, []).extend(dst_map)
        for dst in dst_map:
            neighbors.setdefault(dst, []).append(src)
    return partition_pods(dpid_set, neighbors, target_size)

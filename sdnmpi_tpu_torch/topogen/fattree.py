"""Three-level fat-tree generator (the north-star benchmark topology).

Standard k-ary fat-tree: k pods, each with k/2 edge and k/2 aggregation
switches; (k/2)^2 core switches; every edge switch serves k/2 hosts.
Totals: 5k^2/4 switches, k^3/4 hosts, full bisection bandwidth.
k=16 -> 320 switches / 1024 hosts; k=28 -> 980 switches / 5488 hosts
(the "1024-switch fat-tree" bench config, padded to 1024 in the oracle).

``pods`` stretches the Clos past the port-count identity: the pod count
decouples from k, so ``fattree(64, pods=1008)`` is the 65,536-switch /
~million-host datacenter shape the hierarchical oracle benchmark routes
— each agg still uplinks to its k/2-core group, the groups
are just shared by more pods (a legal folded Clos with thinner
per-pod core bandwidth, exactly how real deployments oversubscribe).

Every fat-tree emits its :class:`~sdnmpi_tpu_torch.topogen.podmap.PodMap`
natively: pod ``i`` holds pod i's aggs+edges, the core layer is one
extra pod. Aggs are each pod's borders; the pod interior is the
edge<->agg bipartite graph, where any two aggs are already at distance
2 through every edge switch — an interior link add can only offer
longer detours, so ``intra_add_narrows`` is certified True (the route
cache's narrowed link-add invalidation rides on it).
"""

from __future__ import annotations

from sdnmpi_tpu_torch.topogen.podmap import PodMap
from sdnmpi_tpu_torch.topogen.spec import PortAllocator, TopoSpec, host_mac


def fattree(
    k: int, hosts_per_edge: int | None = None, pods: int | None = None
) -> TopoSpec:
    if k % 2:
        raise ValueError("fat-tree arity k must be even")
    half = k // 2
    if hosts_per_edge is None:
        hosts_per_edge = half
    if pods is None:
        pods = k

    # dpid layout: cores first, then per pod: aggs, then edges
    n_core = half * half
    core = [1 + i for i in range(n_core)]

    def agg(pod: int, a: int) -> int:
        return 1 + n_core + pod * k + a

    def edge(pod: int, e: int) -> int:
        return 1 + n_core + pod * k + half + e

    switches = list(core)
    pod_of: dict[int, int] = {c: pods for c in core}  # core layer: last pod
    for pod in range(pods):
        switches.extend(agg(pod, a) for a in range(half))
        switches.extend(edge(pod, e) for e in range(half))
        for a in range(half):
            pod_of[agg(pod, a)] = pod
        for e in range(half):
            pod_of[edge(pod, e)] = pod

    ports = PortAllocator()
    links = []
    hosts = []
    host_id = 0

    for pod in range(pods):
        for e in range(half):
            e_dpid = edge(pod, e)
            # hosts first so host ports are the low numbers
            for _ in range(hosts_per_edge):
                hosts.append((host_mac(host_id), e_dpid, ports.take(e_dpid)))
                host_id += 1
            # edge <-> every agg in the pod
            for a in range(half):
                a_dpid = agg(pod, a)
                links.append((e_dpid, ports.take(e_dpid), a_dpid, ports.take(a_dpid)))
        # agg a <-> cores [a*half, (a+1)*half)
        for a in range(half):
            a_dpid = agg(pod, a)
            for j in range(half):
                c_dpid = core[a * half + j]
                links.append((a_dpid, ports.take(a_dpid), c_dpid, ports.take(c_dpid)))

    name = f"fattree-k{k}" if pods == k else f"fattree-k{k}p{pods}"
    return TopoSpec(
        name, switches, links, hosts,
        podmap=PodMap(
            pod_of=pod_of, n_pods=pods + 1, intra_add_narrows=True,
            name=name,
        ),
    )

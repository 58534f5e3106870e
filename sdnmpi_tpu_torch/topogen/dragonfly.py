"""Dragonfly generator (bench config 5: 8 groups x 32 routers).

Canonical dragonfly(g, a, p, h): g groups of a routers; within a group the
routers form a complete graph; each router serves p hosts and owns h
global-link endpoints. Global links are distributed over group pairs
round-robin: each unordered group pair gets floor(a*h/(g-1)) parallel
links, attached to routers in slot order so the per-router global-degree
bound h is respected.
"""

from __future__ import annotations

from sdnmpi_tpu_torch.topogen.podmap import PodMap
from sdnmpi_tpu_torch.topogen.spec import PortAllocator, TopoSpec, host_mac


def dragonfly(
    groups: int, routers_per_group: int, hosts_per_router: int = 1, global_links: int = 2
) -> TopoSpec:
    g, a, p, h = groups, routers_per_group, hosts_per_router, global_links
    if g < 2:
        raise ValueError("dragonfly needs at least 2 groups")

    def dpid(group: int, r: int) -> int:
        return 1 + group * a + r

    switches = [dpid(x, r) for x in range(g) for r in range(a)]
    ports = PortAllocator()
    links = []
    hosts = []
    host_id = 0

    # hosts and intra-group complete graph
    for x in range(g):
        for r in range(a):
            d = dpid(x, r)
            for _ in range(p):
                hosts.append((host_mac(host_id), d, ports.take(d)))
                host_id += 1
        for r in range(a):
            for s in range(r + 1, a):
                links.append(
                    (dpid(x, r), ports.take(dpid(x, r)), dpid(x, s), ports.take(dpid(x, s)))
                )

    # global links: per unordered group pair, w parallel links
    w = (a * h) // (g - 1)
    if w == 0:
        raise ValueError(
            f"too few global endpoints: a*h={a*h} must be >= groups-1={g-1}"
        )
    slot = [0] * g  # next global endpoint slot per group (router round-robin)

    def next_router(x: int) -> int:
        r = slot[x] % a
        slot[x] += 1
        return dpid(x, r)

    for x in range(g):
        for y in range(x + 1, g):
            for _ in range(w):
                rx, ry = next_router(x), next_router(y)
                links.append((rx, ports.take(rx), ry, ports.take(ry)))

    name = f"dragonfly-g{g}a{a}h{h}"
    # pods = groups (the canonical dragonfly hierarchy); routers with
    # global-link endpoints are the borders. A group is a complete
    # graph — every router pair already at distance 1 — so an interior
    # link add can never change border-to-border distances:
    # intra_add_narrows is certified True (see topogen/podmap.py).
    return TopoSpec(
        name, switches, links, hosts,
        podmap=PodMap(
            pod_of={dpid(x, r): x for x in range(g) for r in range(a)},
            n_pods=g, intra_add_narrows=True, name=name,
        ),
    )

"""N-dimensional torus generator (TPU-pod-style networks).

The reference's ecosystem (Mininet fat-trees) never exercised torus
fabrics, but they are the canonical interconnect of the hardware this
framework targets (TPU pods are 2D/3D tori), and they stress the oracle
differently from fat-trees: constant degree 2*ndims, large diameter
(sum of halved dimension sizes), and massive equal-cost path diversity
along dimension-ordered DAGs — exactly the regime where load-aware ECMP
and UGAL adaptive routing pay off.

``torus((4, 4, 4))`` builds a 64-switch 3D torus with wraparound in
every dimension; each switch serves ``hosts_per_switch`` hosts. dpids
are 1-based row-major over the grid.
"""

from __future__ import annotations

import itertools

from sdnmpi_tpu_torch.topogen.spec import PortAllocator, TopoSpec, host_mac


def torus(dims: tuple[int, ...], hosts_per_switch: int = 1) -> TopoSpec:
    if not dims or any(s < 1 for s in dims):
        raise ValueError("torus dimensions must be positive")

    strides = []
    acc = 1
    for s in reversed(dims):
        strides.append(acc)
        acc *= s
    strides = tuple(reversed(strides))

    def dpid(coord: tuple[int, ...]) -> int:
        return 1 + sum(c * st for c, st in zip(coord, strides))

    coords = list(itertools.product(*(range(s) for s in dims)))
    switches = [dpid(c) for c in coords]
    ports = PortAllocator()
    links = []
    hosts = []
    host_id = 0

    for c in coords:
        d = dpid(c)
        for _ in range(hosts_per_switch):
            hosts.append((host_mac(host_id), d, ports.take(d)))
            host_id += 1

    for c in coords:
        a = dpid(c)
        for axis, size in enumerate(dims):
            if size == 1:
                # degenerate axis: the only neighbor is the switch itself
                # (torus2d(1, n)'s historical contract — no links emitted)
                continue
            nb = list(c)
            nb[axis] = (c[axis] + 1) % size
            b = dpid(tuple(nb))
            # size-2 rings: +1 and -1 reach the same neighbor, so the
            # pair would be emitted from both ends — keep one cable
            if size == 2 and a > b:
                continue
            links.append((a, ports.take(a), b, ports.take(b)))

    name = "torus-" + "x".join(str(s) for s in dims)
    return TopoSpec(name, switches, links, hosts)

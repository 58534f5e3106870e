"""Basic topology generators: linear, ring, 2D torus, random regular."""

from __future__ import annotations

import random

from sdnmpi_tpu_torch.topogen.spec import PortAllocator, TopoSpec, host_mac


def linear(n_switches: int, hosts_per_switch: int = 1) -> TopoSpec:
    """Switches 1..n in a chain (bench config 1's 4-switch linear topo)."""
    ports = PortAllocator()
    switches = list(range(1, n_switches + 1))
    hosts = []
    host_id = 0
    for dpid in switches:
        for _ in range(hosts_per_switch):
            hosts.append((host_mac(host_id), dpid, ports.take(dpid)))
            host_id += 1
    links = []
    for a in range(1, n_switches):
        links.append((a, ports.take(a), a + 1, ports.take(a + 1)))
    return TopoSpec(f"linear-{n_switches}", switches, links, hosts)


def ring(n_switches: int, hosts_per_switch: int = 1) -> TopoSpec:
    spec = linear(n_switches, hosts_per_switch)
    spec.name = f"ring-{n_switches}"
    if n_switches <= 2:
        return spec  # the "wrap" link would duplicate the existing cable
    ports = PortAllocator()
    # continue numbering beyond already-used ports
    used = {}
    for a, pa, b, pb in spec.links:
        used[a] = max(used.get(a, 0), pa)
        used[b] = max(used.get(b, 0), pb)
    for mac, dpid, p in spec.hosts:
        used[dpid] = max(used.get(dpid, 0), p)
    ports._next = {d: p + 1 for d, p in used.items()}
    spec.links.append((n_switches, ports.take(n_switches), 1, ports.take(1)))
    return spec


def torus2d(nx: int, ny: int, hosts_per_switch: int = 1) -> TopoSpec:
    """2D torus — the (y, x)-coordinate special case of
    :func:`sdnmpi_tpu_torch.topogen.torus.torus` (same dpid numbering:
    ``1 + y*nx + x``), kept as the stable 2-argument CLI/API form.
    One generator owns the wraparound/size-2 dedup logic."""
    import dataclasses

    from sdnmpi_tpu_torch.topogen.torus import torus

    spec = torus((ny, nx), hosts_per_switch)
    return dataclasses.replace(spec, name=f"torus-{nx}x{ny}")


def random_regular(
    n_switches: int, degree: int, hosts_per_switch: int = 1, seed: int = 0
) -> TopoSpec:
    """Random connected-ish graph: a ring plus random extra edges up to the
    target degree. Used for differential/fuzz testing, not benchmarks."""
    rng = random.Random(seed)
    spec = ring(n_switches, hosts_per_switch)
    have = {(a, b) for a, _, b, _ in spec.links} | {
        (b, a) for a, _, b, _ in spec.links
    }
    ports = PortAllocator()
    ports._next = {d: 100 for d in spec.switches}  # link ports from 100 up
    deg = {d: 2 for d in spec.switches}
    attempts = n_switches * degree * 4
    for _ in range(attempts):
        a, b = rng.sample(spec.switches, 2)
        if (a, b) in have or deg[a] >= degree or deg[b] >= degree:
            continue
        have.add((a, b))
        have.add((b, a))
        deg[a] += 1
        deg[b] += 1
        spec.links.append((a, ports.take(a), b, ports.take(b)))
    spec.name = f"random-{n_switches}x{degree}"
    return spec

"""Dragonflies (Kim, Dally, Scott and Abts, ISCA 2008), as a configuration
names them: ``{"kind": "dragonfly", "groups": 8, "routers": 32,
"hosts_per_router": 4, "global_links": 2}``.

``groups`` groups of ``routers`` routers; the routers of a group form a
complete graph; each router serves ``hosts_per_router`` hosts and owns up
to ``global_links`` global-link ends. Every pair of groups gets
``routers * global_links // (groups - 1)`` parallel global links, laid in
group-pair order (x < y, then y), each taking the next router of either
group in turn. The numbering is the port's: dpid ``1 + group * routers +
r``; every router takes its hosts' ports first, then one port for each
intra-group cable in the order (r, s), r < s, group by group, then its
global cables in the order they are laid. Ports count from 1 on every
router in the order the cables are laid.

:func:`reference_fabric` lays this out again as plain arrays for the
reference. :func:`program_db` builds the program's TopologyDB from the
port's own generator (``topogen.dragonfly``), through its normal
mutators. Routes the program computes over a fabric that differs from
this one fail the reference's checks.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference import Fabric, mac_of


def _shape(spec: dict) -> tuple[int, int, int, int]:
    g, a = int(spec["groups"]), int(spec["routers"])
    p, h = int(spec.get("hosts_per_router", 1)), int(spec.get("global_links", 2))
    if g < 2 or a * h < g - 1:
        raise ValueError(f"no dragonfly of {g} groups with {a * h} global ends a group")
    return g, a, p, h


def reference_fabric(spec: dict) -> Fabric:
    g, a, p, h = _shape(spec)
    n_sw = g * a
    # dpids are 1 .. n_sw in this layout, so row = dpid - 1 = group * a + r
    next_port = np.ones(n_sw, np.int64)
    port = np.full((n_sw, n_sw), -1, np.int32)

    def take(row: int) -> int:
        q = int(next_port[row])
        next_port[row] += 1
        return q

    def cable(x: int, y: int) -> None:
        port[x, y] = take(x)
        port[y, x] = take(y)

    host_sw, host_port = [], []
    for grp in range(g):
        rows = range(grp * a, (grp + 1) * a)
        for r in rows:
            for _ in range(p):
                host_sw.append(r)
                host_port.append(take(r))
        for r in rows:
            for s in range(r + 1, (grp + 1) * a):
                cable(r, s)
    slot = [0] * g  # each group's next global end, router by router
    border = set()
    for x in range(g):
        for y in range(x + 1, g):
            for _ in range(a * h // (g - 1)):
                rx, ry = x * a + slot[x] % a, y * a + slot[y] % a
                slot[x] += 1
                slot[y] += 1
                cable(rx, ry)
                border.update((rx, ry))
    return Fabric(
        dpids=np.arange(1, n_sw + 1, dtype=np.int64),
        port=port,
        host_mac=[mac_of(i) for i in range(len(host_sw))],
        host_sw=np.asarray(host_sw, np.int64),
        host_port=np.asarray(host_port, np.int32),
        top=np.asarray(sorted(border), np.int64),  # the routers with global links
    )


@dataclasses.dataclass(frozen=True)
class Placement:
    """The block a job is placed in and the symmetry that moves it. The
    global links are laid router by router in group-pair order, so no
    rotation of the groups maps the wiring onto itself: the block is the
    whole machine, which a job moves through only by the identity, and
    the align is by a router's hosts."""

    n_hosts: int
    hosts_per_router: int

    @property
    def pod_hosts(self) -> int:
        return self.n_hosts

    @property
    def edge_hosts(self) -> int:
        return self.hosts_per_router

    def rows(self, pods: int) -> np.ndarray:
        """Each router row's row once the job moves ``pods`` whole
        machines on: itself."""
        n_sw = self.n_hosts // self.hosts_per_router
        return np.arange(n_sw)


def placement(spec: dict) -> Placement:
    g, a, p, _ = _shape(spec)
    return Placement(g * a * p, p)


def program_db(spec: dict, db_kwargs: dict, device):
    """The program's TopologyDB of this fabric, on ``device``."""
    from sdnmpi_tpu_torch.topogen import dragonfly

    g, a, p, h = _shape(spec)
    return dragonfly(g, a, hosts_per_router=p, global_links=h).to_topology_db(
        backend="torch", device=device, **db_kwargs)

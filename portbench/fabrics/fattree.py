"""Three-level k-ary fat-trees (Al-Fares, Loukissas and Vahdat, SIGCOMM
2008), as a configuration names them: ``{"kind": "fattree", "k": 16}``.

k pods, each of k/2 aggregation and k/2 edge switches; (k/2)**2 cores;
k/2 hosts on every edge switch. The numbering is the port's: dpids run
over the cores, then pod by pod over its aggregation switches and then
its edge switches; each edge switch takes its hosts' ports first, then
one uplink to every aggregation switch of its pod; aggregation switch a
of a pod uplinks to cores a*k/2 .. a*k/2 + k/2 - 1. Ports count from 1 on
every switch in the order the cables are laid.

:func:`reference_fabric` lays this out again as plain arrays for the
reference. :func:`program_db` builds the program's TopologyDB from the
port's own generator (``topogen.fattree``), through its normal mutators.
Routes the program computes over a fabric that differs from this one
fail the reference's checks.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference import Fabric, mac_of


def reference_fabric(spec: dict) -> Fabric:
    k = int(spec["k"])
    if k % 2:
        raise ValueError(f"a fat-tree needs an even k, got {k}")
    half = k // 2
    n_core = half * half
    n_sw = n_core + k * k
    # dpids are 1 .. n_sw in this layout, so row = dpid - 1
    core = np.arange(n_core)
    next_port = np.ones(n_sw, np.int64)
    port = np.full((n_sw, n_sw), -1, np.int32)

    def take(row: int) -> int:
        p = int(next_port[row])
        next_port[row] += 1
        return p

    host_sw, host_port = [], []
    for pod in range(k):
        agg0 = n_core + pod * k
        edge0 = agg0 + half
        for e in range(half):
            er = edge0 + e
            for _ in range(half):
                host_sw.append(er)
                host_port.append(take(er))
            for a in range(half):
                ar = agg0 + a
                port[er, ar] = take(er)
                port[ar, er] = take(ar)
        for a in range(half):
            ar = agg0 + a
            for j in range(half):
                cr = int(core[a * half + j])
                port[ar, cr] = take(ar)
                port[cr, ar] = take(cr)
    return Fabric(
        dpids=np.arange(1, n_sw + 1, dtype=np.int64),
        port=port,
        host_mac=[mac_of(i) for i in range(len(host_sw))],
        host_sw=np.asarray(host_sw, np.int64),
        host_port=np.asarray(host_port, np.int32),
        top=core.astype(np.int64),
    )


@dataclasses.dataclass(frozen=True)
class Placement:
    """The blocks a batch scheduler's contiguous allocation lines up with
    (a pod's hosts, an edge switch's), and the fabric's symmetry that
    moves a block by whole pods."""

    k: int

    @property
    def pod_hosts(self) -> int:
        return (self.k // 2) ** 2

    @property
    def edge_hosts(self) -> int:
        return self.k // 2

    def rows(self, pods: int) -> np.ndarray:
        """Each switch row's row once every pod moves ``pods`` pods on
        (mod k). Cores stay; a core's port to pod q is port q + 1, so
        every link lands on a link, and host h on host h + pods x
        ``pod_hosts``: a job moved by whole pods, with its links, is the
        same problem."""
        k, n_core = self.k, (self.k // 2) ** 2
        row = np.arange(n_core + k * k)
        pod, within = np.divmod(row[n_core:] - n_core, k)
        row[n_core:] = n_core + ((pod + pods) % k) * k + within
        return row


def placement(spec: dict) -> Placement:
    return Placement(int(spec["k"]))


def program_db(spec: dict, db_kwargs: dict, device):
    """The program's TopologyDB of this fabric, on ``device``."""
    from sdnmpi_tpu_torch.topogen import fattree

    return fattree(int(spec["k"])).to_topology_db(
        backend="torch", device=device, **db_kwargs)

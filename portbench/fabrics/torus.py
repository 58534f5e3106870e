"""Tori with wraparound on every axis, as a configuration names them:
``{"kind": "torus", "dims": [8, 4, 4, 4, 2], "hosts_per_switch": 1}``
(a Blue Gene/Q rack: Chen et al., SC 2011, doi:10.1145/2063384.2063419).

One switch a grid point, each serving ``hosts_per_switch`` hosts. The
numbering is the port's: dpid ``1 +`` the point's row-major index, the
first axis slowest; every switch takes its hosts' ports first (all
switches' hosts before any cable), then the cables are laid point by
point in row-major order, and at each point axis by axis to the next
point along the axis (``+1`` mod the axis's size), each end taking its
switch's next port. An axis of size 2 is one cable (its two directions
reach the same neighbour), an axis of size 1 none.

:func:`reference_fabric` lays this out again as plain arrays for the
reference. :func:`program_db` builds the program's TopologyDB from the
port's own generator (``topogen.torus``), through its normal mutators.
Routes the program computes over a fabric that differs from this one
fail the reference's checks.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from portbench.reference import Fabric, mac_of


def _shape(spec: dict) -> tuple[tuple[int, ...], int]:
    dims = tuple(int(s) for s in spec["dims"])
    if not dims or any(s < 1 for s in dims):
        raise ValueError(f"a torus needs positive dimensions, got {dims}")
    return dims, int(spec.get("hosts_per_switch", 1))


def reference_fabric(spec: dict) -> Fabric:
    dims, hps = _shape(spec)
    strides = [int(np.prod(dims[i + 1:])) for i in range(len(dims))]
    n_sw = int(np.prod(dims))
    # dpids are 1 .. n_sw in this layout, so row = dpid - 1 = row-major index
    next_port = np.ones(n_sw, np.int64)
    port = np.full((n_sw, n_sw), -1, np.int32)

    def take(row: int) -> int:
        q = int(next_port[row])
        next_port[row] += 1
        return q

    host_sw, host_port = [], []
    for row in range(n_sw):
        for _ in range(hps):
            host_sw.append(row)
            host_port.append(take(row))
    for coord in itertools.product(*(range(s) for s in dims)):
        a = int(np.dot(coord, strides))
        for axis, size in enumerate(dims):
            if size == 1:
                continue
            b = a + (((coord[axis] + 1) % size) - coord[axis]) * strides[axis]
            if size == 2 and a > b:  # the ring's one cable, laid from its lower end
                continue
            port[a, b] = take(a)
            port[b, a] = take(b)
    return Fabric(
        dpids=np.arange(1, n_sw + 1, dtype=np.int64),
        port=port,
        host_mac=[mac_of(i) for i in range(len(host_sw))],
        host_sw=np.asarray(host_sw, np.int64),
        host_port=np.asarray(host_port, np.int32),
        # no top layer: the control's detours go through any switch
        top=np.arange(n_sw, dtype=np.int64),
    )


@dataclasses.dataclass(frozen=True)
class Placement:
    """The block a job is placed in and the symmetry that moves it: a
    slab of the first axis (one coordinate of it, every other), moved by
    whole slabs along that axis. A translation maps the torus onto
    itself, links onto links, so a job moved with its snapshot is the
    same problem."""

    dims: tuple
    hosts_per_switch: int

    @property
    def pod_hosts(self) -> int:
        return int(np.prod(self.dims[1:])) * self.hosts_per_switch

    @property
    def edge_hosts(self) -> int:
        return self.hosts_per_switch

    def rows(self, pods: int) -> np.ndarray:
        """Each switch row's row once the job moves ``pods`` slabs on
        along the first axis (mod its size): host h lands on host h +
        pods x ``pod_hosts`` (mod the hosts)."""
        n_sw = int(np.prod(self.dims))
        slab = n_sw // self.dims[0]
        return (np.arange(n_sw, dtype=np.int64) + pods * slab) % n_sw


def placement(spec: dict) -> Placement:
    dims, hps = _shape(spec)
    return Placement(dims, hps)


def program_db(spec: dict, db_kwargs: dict, device):
    """The program's TopologyDB of this fabric, on ``device``."""
    from sdnmpi_tpu_torch.topogen import torus

    dims, hps = _shape(spec)
    return torus(dims, hosts_per_switch=hps).to_topology_db(
        backend="torch", device=device, **db_kwargs)

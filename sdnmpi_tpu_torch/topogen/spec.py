"""Topology specifications and materialization.

The reference has no topology generators — its networks came from
hand-built Mininet setups. The bench configs (BASELINE.md: linear,
fat-tree k=8/k=16, 1024-switch fat-tree, dragonfly 8x32) need them, so a
``TopoSpec`` describes a network abstractly and materializes either as a
``TopologyDB`` (for direct oracle work) or as a live simulated ``Fabric``
(for control-plane integration).
"""

from __future__ import annotations

import dataclasses

from sdnmpi_tpu_torch.core.topology_db import Host, Link, Port, Switch, TopologyDB
from sdnmpi_tpu_torch.utils.mac import int_to_mac


def host_mac(i: int) -> str:
    """MAC of host/rank ``i``: 04:00:xx:xx:xx:xx (globally administered —
    the 0x02 bit must stay clear or the router treats the address as an
    SDN-MPI virtual MAC, reference: router.py:162-164)."""
    return int_to_mac((0x04 << 40) | int(i))  # int() guards numpy scalars


@dataclasses.dataclass
class TopoSpec:
    name: str
    #: switch dpids
    switches: list[int]
    #: directed-pair links as (dpid_a, port_a, dpid_b, port_b); each entry
    #: stands for the bidirectional cable, like Fabric.add_link
    links: list[tuple[int, int, int, int]]
    #: (mac, dpid, port_no)
    hosts: list[tuple[str, int, int]]
    #: pod structure annotation (topogen/podmap.py): emitted
    #: natively by the fattree/dragonfly generators; None means the
    #: hierarchical oracle (when selected) recovers one through the
    #: partitioner fallback. Carried onto the TopologyDB by
    #: :meth:`to_topology_db`.
    podmap: "object | None" = None

    @property
    def n_switches(self) -> int:
        return len(self.switches)

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    def to_topology_db(self, **db_kwargs) -> TopologyDB:
        """Materialize as a port :class:`TopologyDB`; ``db_kwargs``
        (``backend=``, ``device=``, ``pad_multiple=``, ...) go to its
        constructor."""
        db = TopologyDB(**db_kwargs)
        db.podmap = self.podmap
        for dpid in self.switches:
            db.add_switch(Switch.make(dpid))
        for a, pa, b, pb in self.links:
            db.add_link(Link(Port(a, pa), Port(b, pb)))
            db.add_link(Link(Port(b, pb), Port(a, pa)))
        for mac, dpid, port_no in self.hosts:
            db.add_host(Host(mac, Port(dpid, port_no)))
        return db

    def to_fabric(self, **fabric_kw):
        """Materialize as a simulated :class:`~sdnmpi_tpu_torch.control.
        fabric.Fabric`; ``fabric_kw`` (``wire=``, ...) go to its
        constructor."""
        from sdnmpi_tpu_torch.control.fabric import Fabric

        fabric = Fabric(**fabric_kw)
        for dpid in self.switches:
            fabric.add_switch(dpid)
        for a, pa, b, pb in self.links:
            fabric.add_link(a, pa, b, pb)
        for mac, dpid, port_no in self.hosts:
            fabric.add_host(mac, dpid, port_no)
        return fabric


class PortAllocator:
    """Sequential port numbers per switch, starting at 1."""

    def __init__(self) -> None:
        self._next: dict[int, int] = {}

    def take(self, dpid: int) -> int:
        port = self._next.get(dpid, 1)
        self._next[dpid] = port + 1
        return port

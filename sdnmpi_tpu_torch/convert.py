"""State carried across from the JAX package.

The port keeps no copy of the JAX package's objects: a topology crosses
as the plain dict ``TopologyDB.to_dict()`` returns, tensors cross as
numpy arrays. Tests use both so that the two packages route the same
fabric. A row-sharded tensor crosses as the numpy ``[R, C]`` array that
:func:`shard_rows` cuts into the port's per-shard blocks and
:func:`gather_rows` reassembles.
"""

from __future__ import annotations

import numpy as np
import torch

from sdnmpi_tpu_torch.core.topology_db import Host, Link, Port, Switch, TopologyDB
from sdnmpi_tpu_torch.oracle.engine import TopoTensors, resolve_device


def _port(d: dict) -> Port:
    return Port(int(d["dpid"]), int(d["port_no"]))


def topology_from_dict(
    d: dict, backend: str = "torch", device="cuda", pad_multiple: int = 8,
    **db_kwargs,
) -> TopologyDB:
    """A port :class:`TopologyDB` holding the switches, links and hosts
    of a ``TopologyDB.to_dict()`` snapshot (``{"switches": [{"dpid",
    "ports"}], "links": [{"src", "dst"}], "hosts": [{"mac", "port"}]}``);
    ``db_kwargs`` (``mesh_devices=``, ``shard_oracle=``, ...) go to its
    constructor."""
    db = TopologyDB(
        backend=backend, device=device, pad_multiple=pad_multiple, **db_kwargs
    )
    for s in d["switches"]:
        db.add_switch(Switch.make(int(s["dpid"]), [_port(p) for p in s.get("ports", [])]))
    for link in d["links"]:
        db.add_link(Link(_port(link["src"]), _port(link["dst"])))
    for h in d["hosts"]:
        db.add_host(Host(h["mac"], _port(h["port"])))
    return db


def tensors_from_numpy(dpids, adj, port, device="cuda") -> TopoTensors:
    """The port's :class:`TopoTensors` from the host arrays of a JAX
    package ``TopoTensors`` (``dpids`` [n] sorted, ``adj`` [V, V] 0/1,
    ``port`` [V, V] int32 with -1 where no link)."""
    dev = resolve_device(device)
    dpids = np.asarray(dpids, np.int64)
    adj = np.array(adj, dtype=np.float32)
    port = np.array(port, dtype=np.int32)
    out_degree = int((adj > 0).sum(axis=1).max()) if len(dpids) else 0
    return TopoTensors(
        dpids=dpids,
        index={int(x): i for i, x in enumerate(dpids)},
        adj=torch.tensor(adj, device=dev),
        port=torch.tensor(port, device=dev),
        n_real=len(dpids),
        max_degree=max(8, ((out_degree + 7) // 8) * 8),
        adj_host=adj,
        port_host=port,
        n_links=int((adj > 0).sum()),
    )


def shard_rows(arr, mesh) -> list:
    """The port's row-sharded form of a numpy ``[R, C]`` array: shard q
    of ``mesh`` holds rows ``[q*b, (q+1)*b)``, ``b = ceil(R / s)`` (the
    final blocks may be short or empty), on its device (``None`` at the
    shards another process holds)."""
    arr = np.asarray(arr)
    s = mesh.n_shards
    b = -(-arr.shape[0] // s)
    return [
        torch.tensor(arr[q * b:(q + 1) * b]).to(dev) if q in mesh.local else None
        for q, dev in enumerate(mesh.devices)
    ]


def gather_rows(shards) -> np.ndarray:
    """The numpy ``[R, C]`` array of per-shard row blocks, each copied
    to the host (no on-card exchange)."""
    return np.concatenate([x.cpu().numpy() for x in shards], axis=0)

"""The sharded path oracle on the port's shard mesh.

Counterpart of ``sdnmpi_tpu/shardplane``: the ``[V, V]`` distance and
next-hop tensors row-shard over a :class:`~.mesh.ShardMesh` of logical
shards, and a whole collective routes with its destinations and flows
split across them, every all-gather going through the ring kernel K3
(``kernels/ring.py``). Selected by ``TopologyDB(mesh_devices=n,
shard_oracle=True[, ring_exchange=True])``.

- :mod:`~.mesh` — the mesh and its axis facts
- :mod:`~.apsp` — row-sharded distances and next hops
- :mod:`~.routes` — flow-sharded routing: the chase, the balancer, the
  UGAL program and the collective, with packed per-shard readback
"""

from sdnmpi_tpu_torch.shardplane.apsp import (  # noqa: F401
    apsp_distances_rowsharded,
    apsp_distances_sharded,
    apsp_next_hops_ringed,
    apsp_next_hops_rowsharded,
)
from sdnmpi_tpu_torch.shardplane.mesh import (  # noqa: F401
    ShardMesh,
    device_ring_order,
    host_shard_devices,
    init_multihost,
    make_mesh,
    make_multihost_mesh,
    mesh_axes,
    mesh_processes,
    mesh_shards,
)
from sdnmpi_tpu_torch.shardplane.routes import (  # noqa: F401
    batch_fdb_ringed,
    batch_fdb_sharded,
    multichip_route_step,
    route_adaptive_sharded,
    route_collective_sharded,
    route_flows_sharded,
    window_readback_nbytes,
)

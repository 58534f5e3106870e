"""Compat shim, as in the reference: the multi-device oracle lives in
:mod:`sdnmpi_tpu_torch.shardplane`, and its public names re-export here."""

from sdnmpi_tpu_torch.shardplane.apsp import apsp_distances_sharded  # noqa: F401
from sdnmpi_tpu_torch.shardplane.mesh import make_mesh  # noqa: F401
from sdnmpi_tpu_torch.shardplane.routes import (  # noqa: F401
    multichip_route_step,
    route_adaptive_sharded,
    route_collective_sharded,
    route_flows_sharded,
)

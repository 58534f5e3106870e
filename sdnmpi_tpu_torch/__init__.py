"""sdnmpi_tpu_torch: the SDN-MPI controller and route oracle in PyTorch,
for NVIDIA Hopper.

A port of ``sdnmpi_tpu`` (the JAX package beside it, which stays the
reference) that imports neither JAX nor the JAX package. It holds the
command line (``python -m sdnmpi_tpu_torch``), the control plane (event
bus, topology manager, router, process manager, monitor, LLDP
discovery, the simulated fabric, the OpenFlow 1.0 TCP southbound, the
recovery plane and the serving plane: route cache, admission, load
generator), the observability and HA planes (fabric audit, measured
traffic matrix and route sentinel, flight recorder, metrics timeline,
telemetry, SLOs, fault injection, the controller pair), the WebSocket
mirror and checkpoints, on the route oracle: the topology store, the
tensorized fabric,
all-pairs distances and next hops, whole collectives and pair batches
routed by the shortest, balanced (DAG balancer or greedy scanner) and
adaptive (UGAL) policies with the per-flow path sampler, and the
balanced collective sharded over a mesh of logical shards, with three
hand-written CUDA kernels (BFS distances, path sampling and the ring
all-gather) beside their plain PyTorch versions.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"`` (``Config.device`` for the controller); asking for
CUDA without a card raises.

Package map:
  launch.py     the command line (__main__.py runs it)
  config.py     Config: every knob, one dataclass
  api/          WebSocket JSON-RPC mirror, its wire ABI, checkpoints,
                Prometheus text, Perfetto export
  control/      event bus and events, controller, topology manager,
                router, process manager, monitor, discovery, admission,
                load generator, recovery plane, simulated fabric,
                OpenFlow TCP southbound, audit, sentinel, SLOs, fault
                injection, ownership and the controller pair
  core/         TopologyDB (backends "torch" and "py"), SwitchFDB,
                RankAllocationDB, CollectiveTable
  oracle/       APSP, path chase, DAG balancer, greedy scanner, UGAL,
                route oracle, route cache, result arrays, utilization
                plane, measured traffic matrix
  kernels/      CUDA kernels K1 (BFS), K2 (path sampler), K3 (ring
                all-gather), csrc/ sources
  shardplane/   the sharded oracle: shard mesh, row-sharded APSP, sharded
                collective (parallel/ re-exports it)
  topogen/      topology generators (linear, ring, fat-tree, dragonfly,
                torus)
  collectives/  MPI collective rank-pair generators
  protocol/     OpenFlow constants, flow batches and wire codec, virtual
                MAC codec, LLDP and announcement codecs
  utils/        MAC helpers, metrics registry, tracing, event log,
                device-memory telemetry, flight recorder, metrics timeline
  native.py     host codecs (C++ over native/, numpy fallbacks)
  convert.py    topology and tensors carried across from sdnmpi_tpu
"""

__version__ = "0.1.0"
from sdnmpi_tpu_torch.config import Config  # noqa: F401
from sdnmpi_tpu_torch.control.fabric import Fabric  # noqa: F401
from sdnmpi_tpu_torch.control.controller import Controller  # noqa: F401

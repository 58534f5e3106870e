"""sdnmpi_tpu_torch: the SDN-MPI route oracle in PyTorch, for NVIDIA Hopper.

A port of ``sdnmpi_tpu`` (the JAX package beside it, which stays the
reference) that imports neither JAX nor the JAX package. This package
holds the route oracle: the topology store, the tensorized fabric,
all-pairs distances and next hops, whole collectives and pair batches
routed by the shortest, balanced (DAG balancer or greedy scanner) and
adaptive (UGAL) policies with the per-flow path sampler, and the
balanced collective sharded over a mesh of logical shards, with three
hand-written CUDA kernels (BFS distances, path sampling and the ring
all-gather) beside their plain PyTorch versions.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; asking for CUDA without a card raises.

Package map:
  core/         TopologyDB (backends "torch" and "py")
  oracle/       APSP, path chase, DAG balancer, greedy scanner, UGAL,
                route oracle, result arrays
  kernels/      CUDA kernels K1 (BFS), K2 (path sampler), K3 (ring
                all-gather), csrc/ sources
  shardplane/   the sharded oracle: shard mesh, row-sharded APSP, sharded
                collective (parallel/ re-exports it)
  topogen/      topology generators (linear, ring, fat-tree, dragonfly,
                torus)
  collectives/  MPI collective rank-pair generators
  protocol/     OpenFlow constants and flow batches, virtual MAC codec
  utils/        MAC helpers, metrics registry
  native.py     host codecs (C++ over native/, numpy fallbacks)
  convert.py    topology and tensors carried across from sdnmpi_tpu
"""

__version__ = "0.1.0"

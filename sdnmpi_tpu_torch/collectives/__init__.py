from sdnmpi_tpu_torch.collectives.patterns import (  # noqa: F401
    collective_pairs,
    alltoall_pairs,
    allreduce_ring_pairs,
    allreduce_recursive_doubling_pairs,
    bcast_binomial_pairs,
    allgather_ring_pairs,
    reduce_binomial_pairs,
    gather_pairs,
    scatter_pairs,
    barrier_dissemination_pairs,
)

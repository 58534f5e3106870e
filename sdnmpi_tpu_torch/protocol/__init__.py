from sdnmpi_tpu_torch.protocol.vmac import VirtualMac, is_sdn_mpi_addr  # noqa: F401

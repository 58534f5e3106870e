from sdnmpi_tpu_torch.oracle.engine import RouteOracle, TopoTensors, tensorize  # noqa: F401

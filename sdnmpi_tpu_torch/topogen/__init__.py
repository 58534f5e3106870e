from sdnmpi_tpu_torch.topogen.spec import TopoSpec, host_mac  # noqa: F401
from sdnmpi_tpu_torch.topogen.basic import linear, ring, torus2d, random_regular  # noqa: F401
from sdnmpi_tpu_torch.topogen.fattree import fattree  # noqa: F401
from sdnmpi_tpu_torch.topogen.torus import torus  # noqa: F401
from sdnmpi_tpu_torch.topogen.podmap import (  # noqa: F401
    PodMap,
    border_sets,
    inter_pod_links,
    partition_pods,
    podmap_for_db,
)

from sdnmpi_tpu_torch.core.topology_db import (  # noqa: F401
    TopologyDB,
    Switch,
    Link,
    Host,
    Port,
)

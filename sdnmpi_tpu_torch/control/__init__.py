from sdnmpi_tpu_torch.control.bus import EventBus  # noqa: F401
from sdnmpi_tpu_torch.control.fabric import Fabric, SimHost, SimSwitch  # noqa: F401
from sdnmpi_tpu_torch.control.router import Router  # noqa: F401
from sdnmpi_tpu_torch.control.topology_manager import TopologyManager  # noqa: F401
from sdnmpi_tpu_torch.control.process_manager import ProcessManager  # noqa: F401
from sdnmpi_tpu_torch.control.monitor import Monitor  # noqa: F401
from sdnmpi_tpu_torch.control.controller import Controller  # noqa: F401

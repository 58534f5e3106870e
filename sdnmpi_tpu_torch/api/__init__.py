from sdnmpi_tpu_torch.api.rpc import RPCInterface  # noqa: F401
from sdnmpi_tpu_torch.api.snapshot import (  # noqa: F401
    snapshot_controller,
    restore_controller,
    save_checkpoint,
    load_checkpoint,
)

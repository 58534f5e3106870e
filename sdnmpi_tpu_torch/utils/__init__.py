from sdnmpi_tpu_torch.utils.mac import (  # noqa: F401
    mac_to_int,
    int_to_mac,
    mac_to_bytes,
    bytes_to_mac,
    BROADCAST_MAC,
)

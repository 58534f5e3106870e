"""Device-side path reconstruction.

Counterpart of ``sdnmpi_tpu/oracle/paths.py``: turns the next-hop
matrix into concrete hop sequences for whole batches of flows at once
(the tensor form of the reference's ``_route_to_fdb``,
sdnmpi/util/topology_db.py:127-138). The hop chase is a loop of
``max_len`` tensor gathers over the flow batch, with no host sync inside
it; output is padded to ``max_len`` with -1.
"""

from __future__ import annotations

import torch


def batch_paths(
    next_hop: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, max_len: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reconstruct switch-index paths for a batch of flows.

    next_hop: ``[V, V]`` int32 (see oracle/apsp.py); src, dst: ``[F]``
    int32. Returns ``(nodes [F, max_len] int32 padded with -1, length
    [F] int32)``; length 0 marks an unreachable pair.

    ``max_len`` (>= 1) must be >= the longest path in the batch (hop
    count + 1); a flow whose path exceeds it is indistinguishable from
    unreachable.
    """
    dst = dst.long()
    node = src.long()
    emitted = []
    for _ in range(max_len):
        emitted.append(node)
        nxt = next_hop[node.clamp(min=0), dst].long()
        node = torch.where((node == dst) | (node < 0), -1, nxt)
    nodes = torch.stack(emitted, dim=1)
    # a flow is valid iff the chase actually reached dst
    length = (nodes >= 0).sum(dim=1)
    last = nodes.gather(1, (length - 1).clamp(min=0)[:, None])[:, 0]
    reached = (length > 0) & (last == dst)
    return (
        torch.where(reached[:, None], nodes, -1).to(torch.int32),
        torch.where(reached, length, 0).to(torch.int32),
    )


def batch_fdb(
    next_hop: torch.Tensor,
    port: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    final_port: torch.Tensor,
    max_len: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full fdb extraction for a flow batch.

    port: ``[V, V]`` int32 out-port from i toward j (-1 when no link).
    final_port: ``[F]`` int32 port of the destination host on its edge
    switch. Returns ``(hop_nodes [F, max_len], hop_ports [F, max_len],
    length [F])``: ``hop_ports[f, k]`` is the out-port at switch
    ``hop_nodes[f, k]``, and the last valid hop's port is
    ``final_port[f]`` (edge switch -> host), the reference's fdb layout
    (topology_db.py:127-138).
    """
    nodes, length = batch_paths(next_hop, src, dst, max_len)
    return nodes, fdb_ports(port, nodes, length, final_port), length


def fdb_ports(
    port: torch.Tensor,
    nodes: torch.Tensor,
    length: torch.Tensor,
    final_port: torch.Tensor,
) -> torch.Tensor:
    """Out-port rows for chased node rows: the port half of the fdb
    layout, with the final host-facing port spliced in at each row's last
    valid hop."""
    safe = nodes.long().clamp(min=0)
    nxt = torch.cat([safe[:, 1:], safe[:, -1:]], dim=1)
    ports = port[safe, nxt].to(torch.int32)
    last = (length.long() - 1).clamp(min=0)
    ports[torch.arange(nodes.shape[0], device=nodes.device), last] = (
        final_port.to(torch.int32))
    return torch.where(nodes >= 0, ports, -1)

"""Load-aware routing helpers: pair aggregation and the utilization
matrix.

Counterpart of the host-side parts of ``sdnmpi_tpu/oracle/congestion.py``.
The greedy balanced scanner (``route_flows_balanced``) is not ported yet
(ROADMAP A8); the collective path balances with the DAG engine
(``oracle/dag.py``).
"""

from __future__ import annotations

import numpy as np


def aggregate_pairs(
    src_sw: np.ndarray, dst_sw: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collapse per-rank flows to unique (src_switch, dst_switch) pairs
    with multiplicity weights. A 4096-rank alltoall has 16.7M rank pairs
    but only #edge-switches^2 distinct switch pairs — the load they add is
    identical per pair, so the device routes each distinct pair once."""
    v = int(max(src_sw.max(), dst_sw.max())) + 1
    key = src_sw.astype(np.int64) * v + dst_sw.astype(np.int64)
    uniq, counts = np.unique(key, return_counts=True)
    return (
        (uniq // v).astype(np.int32),
        (uniq % v).astype(np.int32),
        counts.astype(np.float32),
    )


def utilization_matrix(
    tensors, link_util: dict[tuple[int, int], float]
) -> np.ndarray:
    """Map the Monitor's (dpid, port_no) -> bps samples onto the [V, V]
    directed-link cost matrix using the topology's port map.

    Samples and link endpoints meet in a sorted ``searchsorted`` join
    over ``row * K + port_no`` keys. Zero/absent samples leave 0
    entries; unmapped samples (unknown dpid, or a port no link rides)
    are ignored.
    """
    port = tensors.host_port()
    util = np.zeros(port.shape, np.float32)
    if not link_util:
        return util
    index = tensors.index
    samples = [
        (i, int(port_no), float(bps))
        for (dpid, port_no), bps in link_util.items()
        if bps and (i := index.get(dpid)) is not None
    ]
    if not samples:
        return util
    rows, cols = np.nonzero(port >= 0)
    if not len(rows):
        return util
    s_rows, s_ports, s_bps = (np.asarray(x) for x in zip(*samples))
    link_ports = port[rows, cols].astype(np.int64)
    k = int(max(int(s_ports.max()), int(link_ports.max()))) + 1
    link_key = rows.astype(np.int64) * k + link_ports
    s_key = s_rows.astype(np.int64) * k + s_ports.astype(np.int64)
    order = np.argsort(s_key)  # dict keys are unique: no stable need
    s_key = s_key[order]
    s_val = s_bps.astype(np.float32)[order]
    pos = np.searchsorted(s_key, link_key)
    pos_c = np.minimum(pos, len(s_key) - 1)
    hit = s_key[pos_c] == link_key
    util[rows[hit], cols[hit]] = s_val[pos_c[hit]]
    return util

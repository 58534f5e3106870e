"""Installed-flow bookkeeping.

Equivalent of the reference's ``SwitchFDB`` (reference:
sdnmpi/util/switch_fdb.py:1-32): a dpid -> (src, dst) -> out_port map used
to de-duplicate FlowMod installs (reference: sdnmpi/router.py:86) and to
snapshot state for the RPC mirror (reference: sdnmpi/rpc_interface.py:36).

Additions over the reference: ``remove``/``remove_switch`` so the router can
clean up flows when links or switches die (the reference never deletes
installed flows — a stale-route hazard its own OFPFF_SEND_FLOW_REM flag
never cashes in), and ``entries()`` iteration for route invalidation.
"""

from __future__ import annotations

from typing import Iterator


class SwitchFDB:
    def __init__(self) -> None:
        # dpid -> (src_mac, dst_mac) -> out_port
        self.fdb: dict[int, dict[tuple[str, str], int]] = {}

    def update(self, dpid: int, src: str, dst: str, port: int) -> None:
        self.fdb.setdefault(dpid, {})[(src, dst)] = port

    def exists(self, dpid: int, src: str, dst: str) -> bool:
        return (src, dst) in self.fdb.get(dpid, {})

    def remove(self, dpid: int, src: str, dst: str) -> bool:
        table = self.fdb.get(dpid)
        if table is None or (src, dst) not in table:
            return False
        del table[(src, dst)]
        if not table:
            del self.fdb[dpid]
        return True

    def remove_switch(self, dpid: int) -> None:
        self.fdb.pop(dpid, None)

    def exists_anywhere(self, src: str, dst: str) -> bool:
        """True if any switch has a flow for this (src, dst) pair."""
        return any((src, dst) in table for table in self.fdb.values())

    def pairs(self) -> set[tuple[str, str]]:
        """All (src, dst) pairs with at least one installed flow."""
        out: set[tuple[str, str]] = set()
        for table in self.fdb.values():
            out.update(table)
        return out

    def entries(self) -> Iterator[tuple[int, str, str, int]]:
        for dpid, table in self.fdb.items():
            for (src, dst), port in table.items():
                yield dpid, src, dst, port

    def to_dict(self) -> dict:
        """JSON-serializable snapshot in this framework's INTERNAL
        layout (``{dpid: {"src dst": port}}``) — used by
        checkpoint/resume (api/snapshot.py). NOT the reference's
        visualizer layout: the reference sends a list of
        ``{"dpid", "fdb": [{"src","dst","out_port"}]}``
        (sdnmpi/util/switch_fdb.py:17-32), which the RPC boundary
        produces via :func:`sdnmpi_tpu_torch.api.wire.fdb`."""
        return {
            str(dpid): {f"{src} {dst}": port for (src, dst), port in table.items()}
            for dpid, table in self.fdb.items()
        }

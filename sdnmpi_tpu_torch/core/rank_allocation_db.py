"""MPI rank -> host MAC registry.

Equivalent of the reference's ``RankAllocationDB``
(reference: sdnmpi/util/rank_allocation_db.py:1-17). The reference's
``delete_prcess`` typo is fixed here; an alias keeps the old spelling
callable for drop-in compatibility.
"""

from __future__ import annotations

from typing import Optional


class RankAllocationDB:
    def __init__(self) -> None:
        # rank -> MAC address
        self.processes: dict[int, str] = {}

    def add_process(self, rank: int, mac: str) -> None:
        self.processes[rank] = mac

    def delete_process(self, rank: int) -> None:
        self.processes.pop(rank, None)

    # Reference API spelling (sdnmpi/util/rank_allocation_db.py:9)
    delete_prcess = delete_process

    def get_mac(self, rank: int) -> Optional[str]:
        return self.processes.get(rank)

    def ranks(self) -> list[int]:
        return sorted(self.processes)

    def __len__(self) -> int:
        return len(self.processes)

    def to_dict(self) -> dict:
        return {str(rank): mac for rank, mac in self.processes.items()}

"""Switch-ownership partition + epoch fencing for the controller pair.

An active/active controller pair must agree — without talking
— on WHICH controller programs WHICH switch, and a failed-over shard
must be able to prove, on the wire, which regime installed a row. Both
problems resolve into this module:

- :class:`OwnershipMap` — a deterministic partition of the switch space
  across ``count`` replicas. The shard function is pure arithmetic
  (``dpid % count``) so every replica computes the same answer with no
  coordination, mirroring how the mesh orders processes by
  ``(process_index, id)`` (shardplane/mesh.device_ring_order): replica
  order IS mesh order, so the partition is stable across restarts of
  the same job. Adoption (failover) flips a shard's *assignment* — the
  shard function never changes, only who serves it.
- **Epoch cookies** — every FlowMod a replica sends to an owned switch
  is stamped with a cookie encoding ``(shard, epoch)`` under a reserved
  tag byte. The epoch bumps on every adoption, so at quiesce the chaos
  acceptance can assert *no dual-owner installs*: a row stamped with a
  stale epoch was installed by the pre-failover regime and must have
  been re-stamped (OF 1.0 ADD replaces by match+priority) by the
  adopter's reconcile, or it is a fencing bug. The tag byte keeps the
  space disjoint from the block plane's small sequential collective
  cookies and the router's cookie-0 unicast rows.

Pure bookkeeping — no bus, no I/O; control/replica.py drives it.

Counterpart of ``sdnmpi_tpu/control/ownership.py``; only
:func:`mesh_replica_index` differs (its rank source).
"""

from __future__ import annotations

#: reserved tag byte (bits 56..63) marking a cookie as an ownership
#: token; collective cookies are small sequential ints and unicast rows
#: default to cookie 0, so the tag can never collide with either
OWNER_COOKIE_TAG = 0x5D

_TAG_SHIFT = 56
_SHARD_SHIFT = 24
_SHARD_MASK = 0xFFFF
_EPOCH_MASK = (1 << _SHARD_SHIFT) - 1


def cookie_token(shard: int, epoch: int) -> int:
    """The 64-bit cookie fencing one (shard, epoch) regime."""
    return (
        (OWNER_COOKIE_TAG << _TAG_SHIFT)
        | ((shard & _SHARD_MASK) << _SHARD_SHIFT)
        | (epoch & _EPOCH_MASK)
    )


def is_owner_cookie(cookie: int) -> bool:
    """True when ``cookie`` carries the ownership tag byte."""
    return (cookie >> _TAG_SHIFT) == OWNER_COOKIE_TAG


def decode_cookie(cookie: int) -> tuple[int, int]:
    """An owner cookie's ``(shard, epoch)``."""
    return (cookie >> _SHARD_SHIFT) & _SHARD_MASK, cookie & _EPOCH_MASK


def mesh_replica_index(count: int) -> int:
    """This replica's index: the ``torch.distributed`` rank when a
    process group is initialized, modulo ``count`` (the reference reads
    ``jax.process_index()``, the same process order its mesh rings
    devices by). 0 when no process group is initialized, so a
    single-host launch without ``--ownership`` is replica 0 of 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank()) % max(1, count)
    return 0


class OwnershipMap:
    """Who serves each shard of the switch space, and at which epoch.

    ``shard_of`` is the fixed partition; ``assignment`` maps shard ->
    serving replica index and starts as the identity (shard i is served
    by replica i). :meth:`adopt` reassigns a dead peer's shard to this
    replica and bumps the shard's epoch — the fencing token every
    subsequent FlowMod to that shard carries."""

    def __init__(self, count: int = 2, index: int = 0) -> None:
        if not 0 <= index < max(1, count):
            raise ValueError(f"replica index {index} outside 0..{count - 1}")
        self.count = max(1, count)
        self.index = index
        self.assignment: dict[int, int] = {
            s: s for s in range(self.count)
        }
        self.epoch: dict[int, int] = {s: 0 for s in range(self.count)}

    def shard_of(self, dpid: int) -> int:
        return int(dpid) % self.count

    def owner_of(self, dpid: int) -> int:
        return self.assignment[self.shard_of(dpid)]

    def owns(self, dpid: int) -> bool:
        return self.owner_of(dpid) == self.index

    def shards_of(self, replica: int) -> list[int]:
        """The shards ``replica`` currently serves."""
        return sorted(
            s for s, owner in self.assignment.items() if owner == replica
        )

    def adopt(self, shard: int) -> int:
        """Take over ``shard`` (its previous owner's lease expired):
        reassign it here and bump its epoch. Returns the new epoch —
        the fencing token of the post-failover regime."""
        self.assignment[shard] = self.index
        self.epoch[shard] = self.epoch.get(shard, 0) + 1
        return self.epoch[shard]

    def cookie_token(self, dpid: int) -> int:
        """The cookie fencing this switch's current regime."""
        shard = self.shard_of(dpid)
        return cookie_token(shard, self.epoch.get(shard, 0))

    def to_dict(self) -> dict:
        """Status payload for heartbeats / the replica_status pull."""
        return {
            "count": self.count,
            "index": self.index,
            "assignment": dict(self.assignment),
            "epoch": dict(self.epoch),
        }

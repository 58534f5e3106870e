"""The shard mesh of the sharded oracle.

Counterpart of ``sdnmpi_tpu/shardplane/mesh.py``. The reference shards
over a ``jax.sharding.Mesh`` of chips; the port's mesh is a plain
:class:`ShardMesh` of logical shards, each placed on a torch device.
``make_mesh(n, device=...)`` puts all n shards on that one device: the
CPU in the tests, one card on the H100. A sharded tensor is a list of
per-shard tensors, one row block each, each on its shard's device; a
replicated one is a single tensor every shard reads. The axis facts are
the reference's: axes ``("flow", "v")``, n/2 x 2 for an even n >= 4, else
n x 1, flattened row-major into the ring order.

Placing shards on several cards, and meshes over several hosts
(``torch.distributed``), are later work (ROADMAP A12): they raise here.
"""

from __future__ import annotations

import dataclasses

import torch

from sdnmpi_tpu_torch.kernels.ring import MAX_SHARDS

_LATER = "ROADMAP A12: shards across cards and multi-host meshes come later"


@dataclasses.dataclass(frozen=True)
class Shard:
    """One logical shard: its flat ring index and its device. Carries
    the ``process_index``/``id`` pair :func:`device_ring_order` sorts by."""

    id: int
    device: torch.device
    process_index: int = 0


class ShardMesh:
    """A mesh of ``n_shards`` logical shards on torch devices."""

    axis_names = ("flow", "v")

    def __init__(self, devices: list) -> None:
        devs = [_canonical(torch.device(d)) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one shard")
        if len(set(devs)) > 1:
            raise NotImplementedError(
                f"a mesh over {len(set(devs))} devices: {_LATER}"
            )
        n = len(devs)
        flow, v = (n // 2, 2) if n >= 4 and n % 2 == 0 else (n, 1)
        self.shape = {"flow": flow, "v": v}
        self.shards = tuple(Shard(i, d) for i, d in enumerate(devs))
        #: flattened ring order (row-major over ("flow", "v"))
        self.ring = tuple(range(n))

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def devices(self) -> tuple:
        """One torch device per shard, in ring order."""
        return tuple(s.device for s in self.shards)

    def __repr__(self) -> str:
        return (f"ShardMesh({self.n_shards} shards, {self.shape}, "
                f"on {self.shards[0].device})")


def _canonical(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int, device="cuda") -> ShardMesh:
    """A mesh of ``n_devices`` logical shards, all on ``device``; raises
    when the device is a card that is not there, or when the ring kernel
    cannot play that many shards."""
    from sdnmpi_tpu_torch.oracle.engine import resolve_device

    if n_devices < 1:
        raise ValueError(f"need at least one shard, got {n_devices}")
    if n_devices > MAX_SHARDS:
        raise ValueError(f"{n_devices} shards: the ring kernel plays at most "
                         f"{MAX_SHARDS}")
    return ShardMesh([resolve_device(device)] * n_devices)


def mesh_axes(mesh: ShardMesh) -> tuple[str, ...]:
    """The axis names a sharded tensor splits over (all of them)."""
    return tuple(mesh.axis_names)


def mesh_shards(mesh: ShardMesh) -> int:
    """Total shard count: the divisor of every sharded axis."""
    return mesh.n_shards


def host_shard_devices(requested: int = 0) -> int:
    """How many logical shards one mesh can hold: ``requested`` clamped
    to what the ring kernel plays in one launch, or that bound for 0."""
    return min(requested, MAX_SHARDS) if requested > 0 else MAX_SHARDS


def device_ring_order(devices) -> list:
    """Shards (anything with ``process_index`` and ``id``) in ring order:
    grouped by process, ordered by (process_index, id), independent of
    the enumeration order."""
    return sorted(devices, key=lambda d: (d.process_index, d.id))


def init_multihost(coordinator: str, num_processes: int, process_id: int):
    raise NotImplementedError(f"multi-host meshes: {_LATER}")


def make_multihost_mesh(n_devices: int = 0, devices=None):
    raise NotImplementedError(f"multi-host meshes: {_LATER}")


def mesh_processes(mesh) -> int:
    raise NotImplementedError(f"multi-host meshes: {_LATER}")

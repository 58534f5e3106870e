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

A mesh can span several processes (:func:`init_multihost`,
:func:`make_multihost_mesh`): a ``torch.distributed`` group over
``gloo``, each process owning one contiguous arc of the ring, all its
shards on one device (``cuda:(rank % device_count)``, or the CPU when
the caller asks). Every process runs the same program on the same
inputs; a sharded list then holds this process's blocks and ``None``
at the other processes' shards (:attr:`ShardMesh.local`). Exchanges go
through kernel K3 and its step form with stores through peer pointers
(``kernels/ring.py``); host results are gathered over the group
(:func:`gather_host`). When one process raises, the others fail at
their next collective, at the latest when the group's timeout ends.
Shards on several devices of one process raise (ROADMAP A4 item 1).
"""

from __future__ import annotations

import dataclasses
import datetime

import numpy as np
import torch

from sdnmpi_tpu_torch.kernels.ring import MAX_SHARDS

_ONE_PROCESS_CARDS = ("ROADMAP A4 item 1: shards on several devices of one "
                      "process come later")

#: seconds a collective of the process group waits for its peers
#: before every process fails
GROUP_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Shard:
    """One logical shard: its flat ring index, its device (None where
    another process holds it) and the process that holds it: the
    ``process_index``/``id`` pair :func:`device_ring_order` sorts by."""

    id: int
    device: torch.device | None
    process_index: int = 0


class ShardMesh:
    """A mesh of logical shards on torch devices, in ring order.

    ``devices`` gives one device per shard; with ``processes`` (the
    process index of each shard, non-decreasing) the mesh spans the
    processes of the default ``torch.distributed`` group, and
    ``devices`` is read only at the shards of ``rank``, this process."""

    axis_names = ("flow", "v")

    def __init__(self, devices: list, processes=None, rank: int = 0) -> None:
        n = len(devices)
        if not n:
            raise ValueError("a mesh needs at least one shard")
        procs = tuple(processes) if processes is not None else (0,) * n
        if len(procs) != n or list(procs) != sorted(procs):
            raise ValueError("a process's shards must form one arc of the ring")
        #: this process's shards, in ring order
        self.local = tuple(q for q in range(n) if procs[q] == rank)
        if not self.local:
            raise ValueError(f"process {rank} holds no shard of the mesh")
        devs = [_canonical(torch.device(devices[q])) if procs[q] == rank else None
                for q in range(n)]
        if len({devs[q] for q in self.local}) > 1:
            raise NotImplementedError(
                f"a mesh over {len({devs[q] for q in self.local})} devices: "
                f"{_ONE_PROCESS_CARDS}"
            )
        counts = {p: procs.count(p) for p in procs}
        if len(set(counts.values())) > 1:
            raise ValueError(f"processes hold unequal shard counts: {counts}")
        flow, v = (n // 2, 2) if n >= 4 and n % 2 == 0 else (n, 1)
        self.shape = {"flow": flow, "v": v}
        self.shards = tuple(Shard(q, devs[q], procs[q]) for q in range(n))
        #: flattened ring order (row-major over ("flow", "v"))
        self.ring = tuple(range(n))
        self.rank = rank
        #: processes of the mesh, each holding one arc in process order
        self.n_processes = len(counts)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def devices(self) -> tuple:
        """One torch device per shard, in ring order (None where another
        process holds the shard)."""
        return tuple(s.device for s in self.shards)

    @property
    def device(self) -> torch.device:
        """The device of this process's shards."""
        return self.shards[self.local[0]].device

    @property
    def multiprocess(self) -> bool:
        return self.n_processes > 1

    def __repr__(self) -> str:
        where = (f", {self.n_processes} processes" if self.multiprocess else "")
        return (f"ShardMesh({self.n_shards} shards, {self.shape}, "
                f"on {self.device}{where})")


def _canonical(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int, device="cuda") -> ShardMesh:
    """A mesh of ``n_devices`` logical shards, all on ``device``; raises
    when the device is a card that is not there, or when the ring kernel
    cannot play that many shards."""
    from sdnmpi_tpu_torch.oracle.engine import resolve_device

    _check_count(n_devices)
    return ShardMesh([resolve_device(device)] * n_devices)


def _check_count(n: int) -> None:
    if n < 1:
        raise ValueError(f"need at least one shard, got {n}")
    if n > MAX_SHARDS:
        raise ValueError(f"{n} shards: the ring kernel plays at most {MAX_SHARDS}")


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


# -- meshes over several processes ---------------------------------------


def _group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def world() -> tuple[int, int]:
    """``(processes, this process's rank)`` of the default process group;
    ``(1, 0)`` when none is up."""
    if not _group_up():
        return 1, 0
    import torch.distributed as dist

    return dist.get_world_size(), dist.get_rank()


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   timeout_s: float = GROUP_TIMEOUT_S) -> bool:
    """Bring up the ``torch.distributed`` group every process of a
    multi-process mesh joins: ``gloo`` over a TCP store at
    ``coordinator`` (``HOST:PORT``, process 0 listens there), with
    ``timeout_s`` for the rendezvous and for every collective after it.
    Returns True when a group is up; a single-process request is a no-op
    (False), and a second call does nothing. Runs before any mesh is
    built (the launcher calls it first thing in ``amain``)."""
    if num_processes <= 1:
        return False
    if _group_up():
        return True
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def process_device(device, rank: int) -> torch.device:
    """Where process ``rank`` puts its shards: ``cuda:(rank %
    device_count)`` for a CUDA ``device`` without an index, the device
    as given otherwise; raises when a card is asked for and none is
    there."""
    from sdnmpi_tpu_torch.oracle.engine import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_multihost_mesh(n_devices: int = 0, devices=None, device="cuda") -> ShardMesh:
    """Mesh over every process's shards in ring order.

    ``devices`` defaults to ``n_devices / processes`` shards for each
    process of the default group (one each for 0), numbered in process
    order and placed on :func:`process_device`; given, it is any list of
    objects with ``process_index``, ``id`` and ``device``. The shards are
    put in :func:`device_ring_order`, so each process's shards form one
    arc, and ``n_devices`` > 0 takes the first N (0 = all). The axes are
    :func:`make_mesh`'s. Without a process group this is a
    single-process mesh of ``n_devices`` shards."""
    n_proc, rank = world()
    if devices is None:
        if n_devices % n_proc:
            raise ValueError(f"{n_devices} shards do not split over {n_proc} processes")
        per = n_devices // n_proc if n_devices else 1
        dev = process_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        devices = [Shard(p * per + i, dev if p == rank else None, p)
                   for p in range(n_proc) for i in range(per)]
    ring = device_ring_order(devices)
    if n_devices > 0:
        ring = ring[:n_devices]
    _check_count(len(ring))
    return ShardMesh([s.device for s in ring], processes=[s.process_index for s in ring],
                     rank=rank)


def mesh_processes(mesh: ShardMesh) -> int:
    """How many processes the mesh spans: 1 for :func:`make_mesh`."""
    return len({s.process_index for s in mesh.shards})


def later(what: str, mesh: ShardMesh) -> None:
    """Raise for a leg that does not run on a multi-process mesh yet."""
    if mesh.multiprocess:
        raise NotImplementedError(
            f"{what} on a mesh over {mesh.n_processes} processes: ROADMAP A4 "
            "queues it; it does not run on part of the shards"
        )


def all_gather_cpu(x: torch.Tensor, mesh: ShardMesh) -> list:
    """Every process's ``x`` (a CPU tensor of one shape and dtype in all
    of them), in process order, over the ``gloo`` group; moved as bytes,
    so any dtype goes."""
    import torch.distributed as dist

    flat = x.contiguous().reshape(-1).view(torch.uint8)
    got = [torch.empty_like(flat) for _ in range(mesh.n_processes)]
    dist.all_gather(got, flat)
    return [g.view(x.dtype).reshape(x.shape) for g in got]


def gather_host(parts: list, mesh: ShardMesh) -> np.ndarray:
    """The numpy concatenation, in ring order, of every shard's block of
    a sharded list (this process's entries are read, the others' come
    over the group): each process's host gets the whole array."""
    mine = torch.cat([parts[q].cpu() for q in mesh.local])
    if not mesh.multiprocess:
        return mine.numpy()
    return torch.cat(all_gather_cpu(mine, mesh)).numpy()


def max_over_processes(value: float, mesh: ShardMesh) -> float:
    """The largest of every process's ``value``."""
    if not mesh.multiprocess:
        return value
    got = all_gather_cpu(torch.tensor([value], dtype=torch.float64), mesh)
    return max(float(g[0]) for g in got)

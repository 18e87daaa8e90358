"""The replica mesh: how the sharded placement splits R replicas over
devices.

Port of the replica half of ``repro/sharding/rules.py``. A mesh is a tuple
of ``torch.device``s, one per shard; shard s holds the contiguous block
``replica_block(R, len(mesh), s)`` of the replica dim. A mesh may name one
device more than once: ``("cpu",) * 4`` is four logical shards on the CPU
(the counterpart of the reference's forced host device count), and
``("cuda:0",) * 4`` four shards on one card, each with its own stream.
"""
from __future__ import annotations

import numpy as np
import torch

#: name of the replica mesh's one axis (``core.algorithms.replica_axis_name``)
REPLICA_AXIS = "replica"


def replica_mesh_size(n_replicas: int, n_devices: int) -> int:
    """Largest device count <= ``n_devices`` that divides ``n_replicas``:
    every shard owns the same number of replicas, so the merge is a plain
    sum of equal-size partials."""
    return next(d for d in range(min(n_replicas, n_devices), 0, -1)
                if n_replicas % d == 0)


def mesh_devices(devices=None) -> tuple:
    """``devices`` as a tuple of ``torch.device``s (a bare ``"cuda"`` gets
    the current card's index); ``None`` means every visible CUDA device,
    and raises where there is none: the CPU runs only when named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass CPU devices to run the sharded "
                "placement on the CPU"
            )
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("a replica mesh needs at least one device")
    return tuple(out)


def global_replica_devices(multihost=None) -> list:
    """The fleet's devices as ``(process, device)`` pairs, ordered by
    (process, local index): each process's devices form one contiguous
    block and every process derives the same list (the reference's order
    of ``jax.devices()`` across ``jax.distributed`` processes). Slot block
    p of the replica dim lands on process p's devices.

    ``multihost`` — a ``launch.multihost.MultihostContext``: its local
    devices (every visible card when it names none) are gathered from every
    process. Without one, this process's visible cards."""
    if multihost is None:
        return [(0, d) for d in mesh_devices(None)]
    local = mesh_devices(multihost.local_devices)
    # one leaf (an array of names): every process's tree has one shape
    gathered = multihost.allgather("devices", np.asarray([str(d) for d in local]))
    return [(pid, torch.device(str(name))) for pid in sorted(gathered)
            for name in gathered[pid]]


def replica_mesh(n_replicas: int, devices=None) -> tuple:
    """The mesh for ``n_replicas``: the first ``replica_mesh_size`` of
    ``devices`` (``mesh_devices``'s rule for ``None``)."""
    devices = mesh_devices(devices)
    return devices[: replica_mesh_size(n_replicas, len(devices))]


def replica_block(n_replicas: int, n_shards: int, shard: int) -> slice:
    """The rows of the replica dim that ``shard`` holds: a contiguous block
    of ``n_replicas // n_shards`` (the reference's ``replica_spec``)."""
    if n_replicas % n_shards:
        raise ValueError(f"{n_replicas} replicas do not split over {n_shards} shards")
    rows = n_replicas // n_shards
    return slice(shard * rows, (shard + 1) * rows)


class ReplicaMeshPool:
    """The devices of an elastic population, and one mesh per shard count.

    A resize may need a mesh of another shard count (4 replicas over 4
    devices shrinking to 2 over 2). ``mesh_for`` picks the count by
    ``replica_mesh_size`` and returns the same tuple object every time a
    count recurs, so the trainer's executors, cached per count, are reused.
    """

    def __init__(self, devices=None):
        self.devices = mesh_devices(devices)
        self._meshes: dict[int, tuple] = {}

    def mesh_for(self, n_replicas: int) -> tuple:
        n = replica_mesh_size(n_replicas, len(self.devices))
        mesh = self._meshes.get(n)
        if mesh is None:
            mesh = self.devices[:n]
            self._meshes[n] = mesh
        return mesh

    def adopt(self, mesh) -> None:
        """Seed the pool with a mesh built outside it (the trainer's
        ``mesh=``), so its shard count reuses it as it is."""
        mesh = mesh if isinstance(mesh, tuple) else mesh_devices(mesh)
        self._meshes[len(mesh)] = mesh

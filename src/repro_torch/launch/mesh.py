"""Replica mesh construction for the launcher.

Port of ``make_replica_mesh`` from ``repro/launch/mesh.py``. A function, so
importing this module touches no device.
"""
from __future__ import annotations

from repro_torch.sharding.rules import replica_mesh


def make_replica_mesh(n_replicas: int, devices=None, multihost=None) -> tuple:
    """The replica mesh for ``--placement sharded``: the largest prefix of
    ``devices`` whose size divides ``n_replicas`` (``sharding.rules.
    replica_mesh``). ``None`` spans every visible card and raises where
    there is none; ``["cpu"]`` is the size-1 CPU mesh.

    ``multihost`` — a bootstrapped ``launch.multihost.MultihostContext``:
    with no ``devices`` given, the mesh is drawn from the process's own
    devices (``local_devices``, else every visible card) under either span.
    Each process meshes only its own block of the replica dim; the host
    span's file exchange or the device span's process group completes the
    reductions across processes, so ``n_replicas`` is this process's count
    (``MultihostContext.local_count``).
    """
    if multihost is not None and devices is None:
        devices = multihost.local_devices
    return replica_mesh(n_replicas, devices)

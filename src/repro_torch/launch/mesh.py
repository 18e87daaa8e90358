"""Replica mesh construction for the launcher.

Port of ``make_replica_mesh`` from ``repro/launch/mesh.py`` (the
multi-process argument comes with multi-process training). A function, so
importing this module touches no device.
"""
from __future__ import annotations

from repro_torch.sharding.rules import replica_mesh


def make_replica_mesh(n_replicas: int, devices=None) -> tuple:
    """The replica mesh for ``--placement sharded``: the largest prefix of
    ``devices`` whose size divides ``n_replicas`` (``sharding.rules.
    replica_mesh``). ``None`` spans every visible card and raises where
    there is none; ``["cpu"]`` is the size-1 CPU mesh."""
    return replica_mesh(n_replicas, devices)

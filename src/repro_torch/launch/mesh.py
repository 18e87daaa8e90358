"""Mesh construction: the replica mesh of the sharded placement, and the
production meshes of the partitioned program.

Port of ``repro/launch/mesh.py``. Functions, so importing this module
touches no device and starts no process group.

Target hardware of the partitioned program: NVIDIA H100 80GB HBM3 (SXM5,
700 W), 256 cards a pod in a 16 x 16 mesh (data, model); 2 pods =>
(pod, data, model) = (2, 16, 16), the reference's shapes, so the specs and
the per-device terms compare with the reference's leaf for leaf. A
``DeviceMesh`` needs a process group of its size: the dry run stands one up
with torch's ``fake`` backend (``init_fake_process_group``), whose
collectives move nothing, and traces under ``FakeTensorMode``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.sharding.rules import replica_mesh

# H100 SXM5 data-sheet constants (per card; used by the dry run's fit check
# and the roofline terms)
PEAK_FLOPS_BF16 = 989e12     # dense bf16 FLOP/s
HBM_BW = 3.35e12             # bytes/s of HBM3
NVLINK_BW = 450e9            # bytes/s per direction
HBM_PER_CHIP = 80e9          # bytes

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


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


def _device_mesh(device_type: str, shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.arange(math.prod(shape)).view(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str):
    """The (16, 16) ``("data", "model")`` mesh, or with ``multi_pod`` the
    (2, 16, 16) ``("pod", "data", "model")`` one, over ranks 0.. of the
    default process group, which must have that many ranks (the dry run's
    fake group: ``init_fake_process_group``)."""
    if multi_pod:
        return _device_mesh(device_type, MULTI_POD_SHAPE, MULTI_POD_AXES)
    return _device_mesh(device_type, PRODUCTION_SHAPE, PRODUCTION_AXES)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, multi_pod: bool = False, *,
                    device_type: str):
    """A small mesh of the same axes (tests, the card's numerics check):
    ``(n_data, n_model)`` or ``(2, n_data, n_model)``."""
    if multi_pod:
        return _device_mesh(device_type, (2, n_data, n_model), MULTI_POD_AXES)
    return _device_mesh(device_type, (n_data, n_model), PRODUCTION_AXES)


def init_fake_process_group(world_size: int, rank: int = 0) -> None:
    """Make the default process group a ``fake`` one of ``world_size``
    ranks, this process being ``rank``: collectives return at once and
    move nothing (torch's own test backend). Replaces a fake group of
    another size; refuses to replace a real one."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialized; the dry run needs "
                               "a process of its own")
        if dist.get_world_size() == world_size and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)

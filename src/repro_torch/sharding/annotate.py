"""Logical-axis sharding annotations.

Port of ``repro/sharding/annotate.py``. Model code annotates activations
with *logical* axis names; a sharding context (installed by the
partitioned steps and the dry run) maps them to mesh axes. Without a
context everything is a no-op, so the same model code runs on one device
and over a ``DeviceMesh``.

Logical axes used across the zoo:
  replica   — elastic worker dim (paper's per-GPU model replicas)
  batch     — per-replica sample dim
  seq       — sequence dim
  embed     — d_model
  heads/kv_heads — attention heads
  ff        — MLP hidden
  vocab     — embedding/vocab rows
  experts   — MoE expert dim

Where the reference's ``shard`` is ``with_sharding_constraint`` on a traced
array, here it redistributes a ``DTensor`` to the spec's placements over
the context's mesh (``sharding.rules.to_placements``); a plain tensor is
returned as it is. The context's mesh is the whole production mesh (a
``DeviceMesh`` or a mapping of axis sizes), whose sizes
``logical_axis_size`` reads. The partitioned steps (``launch.steps``)
split the replica dim by hand and hold each replica's leaves as DTensors
over the mesh dims the replica dim does not use, so ``shard`` drops the
axes a DTensor's own mesh does not have.

The sharded placement (``sharding.executor``) installs no context: its
shards are whole replicas, so ``shard`` stays the identity there, and a
resize has no context to invalidate.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.sharding.rules import REPLICA_AXIS, Spec, mesh_shape, to_placements

_CTX: dict = {"mesh": None, "rules": {}}


def set_context(mesh, rules: Optional[dict]) -> None:
    _CTX["mesh"] = mesh
    _CTX["rules"] = dict(rules or {})


@contextlib.contextmanager
def sharding_context(mesh, rules: dict):
    old = (_CTX["mesh"], _CTX["rules"])
    set_context(mesh, rules)
    try:
        yield
    finally:
        set_context(*old)


def replica_rules() -> dict:
    """Logical-axis mapping for a replica-only (1-D) mesh: the elastic
    replica dim shards over REPLICA_AXIS, everything else is replicated."""
    return {"replica": REPLICA_AXIS, "batch": None, "heads": None,
            "ff": None, "experts": None}


def logical_to_spec(axes: tuple, rules: Optional[dict] = None) -> Spec:
    rules = _CTX["rules"] if rules is None else rules
    # each entry None, a mesh axis name, or a tuple of them
    return Spec(*(None if a is None else rules.get(a) for a in axes))


def logical_axis_size(name: str) -> int:
    """Mesh extent of the logical axis ``name`` under the current context
    (1 when no mesh / unmapped). Used by shard-local MoE dispatch to pick
    its group count."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return 1
    ax = _CTX["rules"].get(name)
    if ax is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(ax, (tuple, list)):
        out = 1
        for a in ax:
            out *= int(shape[a])
        return out
    return int(shape[ax])


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (the partitioned program's leaves)."""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def placements_for(mesh, *axes, shape=None) -> list:
    """The placements over a DTensor's ``mesh`` of the logical ``axes``
    under the current context (axes ``mesh`` lacks are dropped). With a
    ``shape``, a dim whose size does not divide evenly over its mesh axes
    stays whole (GSPMD would pad it; DTensor's views refuse uneven
    shards)."""
    placements = to_placements(_on_mesh(logical_to_spec(axes), mesh), mesh)
    if shape is None:
        return placements
    from torch.distributed.tensor import Replicate

    ways: dict = {}
    for i, p in enumerate(placements):
        if p.is_shard():
            ways[p.dim] = ways.get(p.dim, 1) * mesh.size(i)
    return [Replicate() if p.is_shard() and shape[p.dim] % ways[p.dim] else p
            for p in placements]


def _on_mesh(spec: Spec, mesh) -> Spec:
    """``spec`` without the axes ``mesh`` does not have (the replica mesh
    dims, which the partitioned steps split by hand)."""
    names = set(mesh.mesh_dim_names)

    def keep(ax):
        if ax is None:
            return None
        if isinstance(ax, (tuple, list)):
            kept = tuple(a for a in ax if a in names)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return ax if ax in names else None

    return Spec(*(keep(a) for a in spec))


def shard(x, *axes):
    """Constrain a DTensor's layout by logical axis names; the identity
    (``x`` itself) without a context, for a plain tensor, or when the
    rank does not match the spec. A leading ``"replica"`` is dropped where
    ``x`` has one dim fewer (serving paths carry no replica dim)."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return x
    if x.ndim == len(axes) - 1 and axes[0] == "replica":
        axes = axes[1:]  # serving paths carry no replica dim
    if x.ndim != len(axes) or not is_dtensor(x):
        return x
    return constrain(x, placements_for(x.device_mesh, *axes, shape=x.shape))


def constrain(x, placements, grad_as_output: bool = False):
    """A DTensor redistributed to ``placements`` (``_Constrain``). With
    ``grad_as_output`` its gradient flows back in the output's layout (any
    layout holds the same values), where the input's own would be one a
    view behind it cannot take."""
    if tuple(placements) == tuple(x.placements):
        return x
    return _Constrain.apply(x, tuple(placements), grad_as_output)


def pin(x):
    """``x`` (a DTensor) as it is, with a backward that hands its gradient
    back in ``x``'s own layout: after a reshape, the layout the reshape's
    backward can split again."""
    if not is_dtensor(x):
        return x
    return _Constrain.apply(x, tuple(x.placements), False)


def gathered(w, *keep: int):
    """A DTensor weight with its shards gathered on every tensor dim but
    those in ``keep`` (FSDP's all-gather before use, whose backward
    reduce-scatters the gradient); a plain tensor as it is. The sharded
    dims kept are the tensor-parallel and expert dims, so every product
    has one layout whatever the sizes: DTensor left alone would weigh
    gathering a weight against moving activations, and switch between
    the two with the sequence length."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    keep = {k % w.ndim for k in keep}
    want = [Replicate() if p.is_shard() and p.dim not in keep else p for p in w.placements]
    return constrain(w, want)


class _Constrain(torch.autograd.Function):
    """``redistribute`` whose backward gives a partial-sum input its
    gradient whole (replicated), as the conjugate of an all-reduce is the
    identity (Megatron's f/g pair): DTensor's own backward hands such an
    input a partial-sum gradient, and the product behind it then gathers
    its weight instead of using it sharded."""

    @staticmethod
    def forward(ctx, x, placements, grad_as_output):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        ctx.grad_as_output = grad_as_output
        out = x.redistribute(x.device_mesh, placements)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate

        if ctx.grad_as_output:
            return grad, None, None
        want = [Replicate() if p.is_partial() else p for p in ctx.placements]
        return grad.redistribute(ctx.mesh, want), None, None

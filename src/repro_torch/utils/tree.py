"""Helpers over the port's parameter trees: dicts of tensors.

Port of the parts of ``repro/utils/tree.py`` the trainer calls. Replicated
trees carry a leading replica dimension R on every leaf.

The trainer, the SGD update, the merge and the non-finite guard take flat
dicts (one level, leaf name -> tensor). A model whose parameters nest (the
LM: a ``prefix`` list and ``blocks.pos{j}`` dicts) crosses that boundary
through :func:`flatten` and :func:`unflatten`, which key each leaf by its
dotted path (``"blocks.pos0.mixer.wq"``, ``"prefix.0.ffn.wi"``) in the
tree's own order, so the leaves come in the same order on every call.

Under the sharded placement the replica and momentum state is a
:class:`ShardedTree`: one block of contiguous replicas a shard, on the
shard's device. The helpers the algorithms call on the whole population
at the barrier (:func:`tree_size`, :func:`tree_replica_slice`, and
:func:`tree_fill_rows`, the fleet's) take either layout, so no algorithm
tests the placement. Inside a round the cross-replica helpers take the
replica axis's name (``core.algorithms.replica_axis_name``): ``None``
reduces over the leading dim as it is, the sharded placement's axis
completes the reduction over the shards (``sharding.executor``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


class ShardedTree:
    """A replica-stacked tree split over the shards of a replica mesh:
    ``blocks[s]`` is shard s's dict of leaves (its rows of the replica dim,
    in order), on its device."""

    def __init__(self, blocks):
        self.blocks = list(blocks)

    def keys(self):
        return self.blocks[0].keys()

    @property
    def rows_per_block(self) -> int:
        return next(iter(self.blocks[0].values())).shape[0]

    def gather(self, device) -> dict:
        """The whole (R, ...) tree on ``device``, as new tensors."""
        return {k: torch.cat([b[k].to(device) for b in self.blocks]) for k in self.keys()}


def _axis(name):
    from repro_torch.sharding.executor import bound_axis

    return bound_axis(name)


def replica_all_sum(x, axis: Optional[str] = None):
    """``x`` summed over every shard of the replica axis ``axis``; the
    identity when ``axis`` is None (every replica in this program)."""
    return x if axis is None else _axis(axis).all_sum(x)


def replica_all_max(x, axis: Optional[str] = None):
    """The maximum of ``x`` over the shards of ``axis`` (the live gate of
    a round: whether any replica anywhere is unmasked)."""
    return x if axis is None else _axis(axis).all_max(x)


def tree_map(fn: Callable, *trees: dict) -> dict:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def flatten(tree, prefix: str = "") -> dict:
    """A nested tree of dicts and lists -> {dotted path: leaf}, depth first
    in the tree's own order. Empty dicts and lists hold no leaf and
    vanish."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: dict = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten(flat: dict):
    """Inverse of :func:`flatten`: a level whose keys are all digits becomes
    a list. The leaves are the flat dict's own tensors (no copy)."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        *parents, last = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def tree_size(a) -> int:
    """Total number of scalar parameters in the tree (either layout)."""
    if isinstance(a, ShardedTree):
        return sum(tree_size(b) for b in a.blocks)
    return sum(l.numel() for l in a.values())


def tree_l2_norm_per_replica(a: dict) -> torch.Tensor:
    """(R,) L2 norm per replica, accumulated in f32 (Algorithm 2's
    regularization check ``||w_i||_2 / |w| < pert_thr``)."""
    parts = [l.float().square().sum(dim=tuple(range(1, l.ndim))) for l in a.values()]
    return torch.sqrt(torch.stack(parts).sum(dim=0))


def tree_broadcast_replicas(a: dict, n: int) -> dict:
    """Copy a tree (no replica dim) into n replicas. The copies are
    materialized (not an ``expand`` view): rounds update replicas in place."""
    return tree_map(lambda l: l.unsqueeze(0).repeat((n,) + (1,) * l.ndim), a)


def tree_replica_mean_keepdims(a: dict, axis: Optional[str] = None) -> dict:
    """f32 mean over the replica dim, kept as a dim of size 1, leafwise:
    the cross-replica averaging primitive of the sync/crossbow family. With
    ``axis``, each shard's mean is averaged over the shards (exact: every
    shard holds as many replicas)."""
    def leaf(l):
        m = l.float().mean(dim=0, keepdim=True)
        if axis is not None:
            ax = _axis(axis)
            m = ax.all_sum(m) / ax.size
        return m

    return tree_map(leaf, a)


def tree_replica_slice(a, i: int) -> dict:
    """Replica i of every leaf, as a copy on its shard's device (either
    layout): rounds update replicas in place."""
    if isinstance(a, ShardedTree):
        a, i = a.blocks[i // a.rows_per_block], i % a.rows_per_block
    return tree_map(lambda l: l[i].clone(), a)


def tree_fill_rows(a, rows, value: float):
    """A copy of the replica tree (either layout) with the given replicas'
    every value set to ``value``."""
    if isinstance(a, ShardedTree):
        n = a.rows_per_block
        return ShardedTree([
            tree_fill_rows(b, [r - s * n for r in rows if s * n <= r < (s + 1) * n], value)
            for s, b in enumerate(a.blocks)
        ])

    def fill(l):
        index = torch.tensor(list(rows), dtype=torch.long, device=l.device)
        return l.index_fill(0, index, value)

    return tree_map(fill, a)

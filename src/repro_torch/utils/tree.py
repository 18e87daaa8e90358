"""Helpers over the port's parameter trees: dicts of tensors.

Port of the parts of ``repro/utils/tree.py`` the trainer calls. Replicated
trees carry a leading replica dimension R on every leaf.

The trainer, the SGD update, the merge and the non-finite guard take flat
dicts (one level, leaf name -> tensor). A model whose parameters nest (the
LM: a ``prefix`` list and ``blocks.pos{j}`` dicts) crosses that boundary
through :func:`flatten` and :func:`unflatten`, which key each leaf by its
dotted path (``"blocks.pos0.mixer.wq"``, ``"prefix.0.ffn.wi"``) in the
tree's own order, so the leaves come in the same order on every call.
"""
from __future__ import annotations

from typing import Callable

import torch


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


def tree_size(a: dict) -> int:
    """Total number of scalar parameters in the tree."""
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


def tree_replica_mean_keepdims(a: dict) -> dict:
    """f32 mean over the replica dim, kept as a dim of size 1, leafwise:
    the cross-replica averaging primitive of the sync/crossbow family."""
    return tree_map(lambda l: l.float().mean(dim=0, keepdim=True), a)


def tree_replica_slice(a: dict, i: int) -> dict:
    """Replica i of every leaf, as a copy: rounds update replicas in place."""
    return tree_map(lambda l: l[i].clone(), a)

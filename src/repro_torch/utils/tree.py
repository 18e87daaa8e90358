"""Helpers over the port's parameter trees: dicts of tensors.

Port of the parts of ``repro/utils/tree.py`` the trainer calls. Replicated
trees carry a leading replica dimension R on every leaf.
"""
from __future__ import annotations

from typing import Callable

import torch


def tree_map(fn: Callable, *trees: dict) -> dict:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


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

"""Gradient aggregation (TensorFlow-mirrored synchronous SGD baseline).

Port of ``repro/core/algorithms/sync.py``. Per-round cross-replica
gradient averaging over a static equal plan with per-GPU batch b_max / R;
replicas stay identical, so the "merge" is just a replica copy. The paper
models its per-batch all-reduce as one merge cost per round.
"""
from __future__ import annotations

import numpy as np

from repro_torch.optim.row_sparse import densify_tree
from repro_torch.utils import tree as tu

from .base import (
    Algorithm,
    MergeOutcome,
    RoundTransforms,
    StateExtras,
    register,
    replica_axis_name,
)


def mean_grads(grads, update_mask, axis=None):
    """All replicas share the plain cross-replica mean gradient.

    Replicas see different batches, so row-sparse grads have no common row
    set to average over — densify before the mean. (Static plans: every
    replica is live each round, so the mask does not enter.) The mean spans
    the whole population: under the sharded placement ``axis`` folds the
    other shards in.
    """
    grads = densify_tree(grads)
    means = tu.tree_replica_mean_keepdims(grads, axis)
    return tu.tree_map(lambda g, m: m.expand_as(g).to(g.dtype), grads, means)


@register("sync")
class GradientAggregation(Algorithm):
    #: the gradient mean reduces across replicas every round
    round_collectives = True

    def init_state_extras(self, cfg, params, keep_global_copies):
        b0 = max(cfg.b_min, cfg.b_max // cfg.n_replicas)
        return StateExtras(b=np.full(cfg.n_replicas, float(b0)))

    def resize_b(self, cfg, b, lr, base_lr):
        """The share b_max/R depends on R itself: a membership change
        re-derives everyone's batch size and linear-scaled lr."""
        new_b = np.asarray(self.init_state_extras(cfg, None, False).b, np.float64)
        return new_b, base_lr * new_b / cfg.b_max

    def round_transforms(self, cfg):
        axis = replica_axis_name(cfg)  # None under vmap: the helpers reduce as is
        return RoundTransforms(grad_transform=lambda g, mask: mean_grads(g, mask, axis))

    def merge(self, trainer, state, plan, replicas):
        R = trainer.cfg.n_replicas
        return MergeOutcome(
            replicas=replicas,  # identical already
            global_model=tu.tree_replica_slice(replicas, 0),
            alphas=np.full(R, 1.0 / R),
        )

    def merges_per_megabatch(self, plan):
        # "updates the global model after every batch"
        return plan.n_rounds

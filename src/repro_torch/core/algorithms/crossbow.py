"""CROSSBOW synchronous model averaging (paper §5.1 baseline).

Port of ``repro/core/algorithms/crossbow.py``. Independent learners
corrected toward the replica average after every round. The correction is
one function — ``crossbow_correct`` — run as the post-round hook and again
at the mega-batch barrier, through ``trainer.apply_replicas`` (the whole
population under either placement), to read the center as the global
model.
"""
from __future__ import annotations

import numpy as np

from repro_torch.utils import tree as tu

from .base import Algorithm, MergeOutcome, RoundTransforms, register, replica_axis_name


def crossbow_correct(replicas, c: float, axis=None):
    """w_i ← w_i − c (w_i − w̄). Returns (corrected replicas, f32 center w̄).
    The center averages the whole population: ``axis`` extends the mean
    over the shards of the sharded placement."""
    center = tu.tree_replica_mean_keepdims(replicas, axis)
    corrected = tu.tree_map(
        lambda l, m: (l.float() - c * (l.float() - m)).to(l.dtype), replicas, center
    )
    return corrected, tu.tree_map(lambda m: m[0], center)


@register("crossbow")
class Crossbow(Algorithm):
    #: independent learners: a membership change keeps survivors' own
    #: parameters; leavers fold into the center, joiners clone it
    resize_policy = "preserve"

    #: the center averages the whole population every round
    round_collectives = True

    def round_transforms(self, cfg):
        c = cfg.crossbow_correction
        axis = replica_axis_name(cfg)
        return RoundTransforms(post_round=lambda reps: crossbow_correct(reps, c, axis)[0])

    def merge(self, trainer, state, plan, replicas):
        cfg = trainer.cfg
        c = cfg.crossbow_correction
        replicas, center = trainer.apply_replicas(
            lambda reps, axis: crossbow_correct(reps, c, axis), replicas)
        return MergeOutcome(
            replicas=replicas,
            global_model=center,
            alphas=np.full(cfg.n_replicas, 1.0 / cfg.n_replicas),
        )

    def merges_per_megabatch(self, plan):
        # synchronous averaging after every batch, like `sync`
        return plan.n_rounds

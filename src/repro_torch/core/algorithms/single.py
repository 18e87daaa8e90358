"""Single-worker mini-batch SGD (R = 1).

Port of ``repro/core/algorithms/single.py``. On one GPU, Adaptive ==
Elastic == plain SGD (paper §5.2): dynamic planning degenerates to
sequential dispatch, and the merge is the identity (a copy of the one
replica).
"""
from __future__ import annotations

import numpy as np

from repro_torch.utils import tree as tu

from .base import Algorithm, MergeOutcome, register


@register("single")
class SingleWorker(Algorithm):
    def plan(self, scheduler, state, mega_samples, fetch_fn):
        return self._plan_dynamic(scheduler, state, mega_samples, fetch_fn)

    def merge(self, trainer, state, plan, replicas):
        return MergeOutcome(
            replicas=replicas,
            global_model=tu.tree_replica_slice(replicas, 0),
            alphas=np.full(trainer.cfg.n_replicas, 1.0 / trainer.cfg.n_replicas),
        )

    def resolve_n_replicas(self, requested):
        return 1

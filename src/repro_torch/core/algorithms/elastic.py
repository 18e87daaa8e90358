"""Elastic model averaging (K-step averaging, paper §5.1 baseline).

Port of ``repro/core/algorithms/elastic.py``. Static equal batches,
uniform-weight normalized merge with the same global-model momentum rule
as Adaptive, no batch-size adaptation.
"""
from __future__ import annotations

import numpy as np

from .base import Algorithm, MergeOutcome, StateExtras, register


@register("elastic")
class ElasticAveraging(Algorithm):
    def init_state_extras(self, cfg, params, keep_global_copies):
        b = np.full(cfg.n_replicas, float(cfg.b_max))
        if keep_global_copies:
            return StateExtras(b=b, global_model=params, prev_global=params)
        return StateExtras(b=b)  # §4 memory-lean merging

    def merge(self, trainer, state, plan, replicas):
        cfg = trainer.cfg
        alphas = np.full(cfg.n_replicas, 1.0 / cfg.n_replicas)
        new_global, new_replicas = trainer.merge_models(
            replicas, alphas, state.global_model, state.prev_global,
            cfg.gamma if state.global_model is not None else 0.0,
        )
        return MergeOutcome(
            replicas=new_replicas,
            global_model=new_global,
            prev_global=state.global_model,
            alphas=alphas,
        )

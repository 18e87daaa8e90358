"""The paper's contribution: Adaptive SGD.

Port of ``repro/core/algorithms/adaptive.py``. Dynamic availability-driven
scheduling (§3.1) + batch size scaling (Algorithm 1) + normalized model
merging with perturbation and global-model momentum (Algorithm 2).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import adaptive_sgd as asgd
from repro_torch.utils import tree as tu

from .base import Algorithm, MergeOutcome, StateExtras, register


@register("adaptive")
class AdaptiveSGD(Algorithm):
    def init_state_extras(self, cfg, params, keep_global_copies):
        b = np.full(cfg.n_replicas, float(cfg.b_max))
        if keep_global_copies:
            return StateExtras(b=b, global_model=params, prev_global=params)
        return StateExtras(b=b)  # §4 memory-lean merging

    def plan(self, scheduler, state, mega_samples, fetch_fn):
        return self._plan_dynamic(scheduler, state, mega_samples, fetch_fn)

    def merge(self, trainer, state, plan, replicas):
        cfg = trainer.cfg
        R = cfg.n_replicas
        alphas = asgd.merge_weights(plan.u, state.b)
        norms = trainer.replica_norms(replicas)
        n_param = tu.tree_size(replicas) / R
        alphas, pert_active = asgd.apply_perturbation(
            alphas, plan.u, norms / n_param, cfg
        )
        new_global, new_replicas = trainer.merge_models(
            replicas,
            alphas,
            state.global_model,
            state.prev_global,
            cfg.gamma if state.global_model is not None else 0.0,
        )
        return MergeOutcome(
            replicas=new_replicas,
            global_model=new_global,
            prev_global=state.global_model,
            alphas=alphas,
            pert_active=pert_active,
        )

    def adapt(self, state, plan, cfg):
        return asgd.batch_size_scaling(state.b, state.lr, plan.u, cfg)

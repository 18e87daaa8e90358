"""Delayed-synchronous SGD with adaptive batch sizes (ABS-SGD-style).

Port of ``repro/core/algorithms/delayed_sync.py``, the reference's sixth
algorithm:

* **Adaptive batch sizes** — the mega-batch is planned with the paper's
  availability-driven dynamic dispatch, and between mega-batches
  per-replica batch sizes follow Algorithm 1 with the linear lr rule.
* **Synchronous aggregation** — each lockstep round averages gradients
  across the *live* replicas of that round (masked replicas' zero
  gradients must not dilute the mean).
* **Delay** — the per-round all-reduce is modelled as hidden behind
  compute: one barrier merge cost per mega-batch instead of one per round.
* **Barrier** — the update-count-weighted average (Algorithm 2's
  normalization without the global-momentum term), through
  ``trainer.merge_models``: the ``weighted_merge`` kernel on the card.
"""
from __future__ import annotations

from repro_torch.core import adaptive_sgd as asgd
from repro_torch.optim.row_sparse import densify_tree
from repro_torch.utils import tree as tu

from .base import Algorithm, MergeOutcome, RoundTransforms, register, replica_axis_name


def masked_mean_grads(grads, update_mask, axis=None):
    """Mean over live replicas, broadcast to all (masked rows get it too,
    but their SGD update is masked off, so they stay frozen). Live replicas
    count across the whole mesh: with ``axis`` the weighted sum and the live
    count are summed over the shards before the divide."""
    grads = densify_tree(grads)
    w = update_mask.float()
    denom = tu.replica_all_sum(w.sum(), axis).clamp_min(1.0)

    def one(g):
        wg = w.view((-1,) + (1,) * (g.ndim - 1)) * g.float()
        mean = tu.replica_all_sum(wg.sum(dim=0, keepdim=True), axis) / denom
        return mean.expand_as(g).to(g.dtype)

    return tu.tree_map(one, grads)


@register("delayed_sync")
class DelayedSyncAdaptiveBatch(Algorithm):
    # state init: the base default (b = b_max everywhere, no global copies)

    #: the masked gradient mean reduces across replicas every round
    round_collectives = True

    def plan(self, scheduler, state, mega_samples, fetch_fn):
        return self._plan_dynamic(scheduler, state, mega_samples, fetch_fn)

    def round_transforms(self, cfg):
        axis = replica_axis_name(cfg)
        return RoundTransforms(grad_transform=lambda g, mask: masked_mean_grads(g, mask, axis))

    def merge(self, trainer, state, plan, replicas):
        alphas = asgd.merge_weights(plan.u, state.b)
        new_global, new_replicas = trainer.merge_models(replicas, alphas, None, None, 0.0)
        return MergeOutcome(replicas=new_replicas, global_model=new_global, alphas=alphas)

    def adapt(self, state, plan, cfg):
        return asgd.batch_size_scaling(state.b, state.lr, plan.u, cfg)

    def merges_per_megabatch(self, plan):
        return 1  # aggregation latency is hidden behind compute (the delay)

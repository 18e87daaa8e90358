"""The pluggable Algorithm API.

Port of ``repro/core/algorithms/base.py``. An *algorithm* is everything
that distinguishes one member of the elastic-SGD family from another: how
per-replica state is initialized, how a mega-batch is partitioned, what
happens to gradients/replicas inside a lockstep round, how replicas are
merged at the barrier, and how batch sizes/learning rates adapt between
mega-batches. ``ElasticTrainer`` drives whichever ``Algorithm`` the
registry resolves from ``cfg.algorithm``.

Hooks (host-side, except the ``RoundTransforms`` callables, which run
inside every round):

  * ``init_state_extras(cfg, params, keep_global_copies)`` → ``StateExtras``
  * ``plan(scheduler, state, mega_samples, fetch_fn)`` → ``MegaBatchPlan``
  * ``round_transforms(cfg)`` → ``RoundTransforms``
  * ``merge(trainer, state, plan, replicas)`` → ``MergeOutcome``; the
    trainer exposes ``merge_models``, ``replica_norms`` and
    ``apply_replicas`` (a function of the replicas run under the placement)
  * ``adapt(state, plan, cfg)`` → ``(new_b, new_lr)``
  * ``merges_per_megabatch(plan)`` — merge costs charged to the clock
  * ``resolve_n_replicas(requested)`` — clamp the replica count
  * ``resize_policy`` / ``resize_b(cfg, b, lr, base_lr)`` — what a
    membership change keeps (``ElasticTrainer.resize``)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.sharding.rules import REPLICA_AXIS


def replica_axis_name(cfg) -> Optional[str]:
    """The collective axis a per-round hook must reduce over, or None.

    Under ``cfg.placement == 'sharded'`` the round transforms run in each
    shard's worker thread on that shard's block of replicas, so
    cross-replica math (a gradient mean, CROSSBOW's center) folds the other
    shards in over this axis (``tu.replica_all_sum``,
    ``tu.tree_replica_mean_keepdims`` take it). Under the vmap placement
    every replica is local and this is None: the helpers reduce as before.
    """
    return REPLICA_AXIS if getattr(cfg, "placement", "vmap") == "sharded" else None


# --------------------------------------------------------------------------
# hook result types
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class StateExtras:
    """Algorithm-specific slice of the initial ``ElasticState``: the (R,)
    initial batch sizes (the trainer derives the initial lr from them by
    the linear-scaling rule) and the Algorithm-2 global/prev-global copies
    (None = merge directly on the replicas)."""

    b: np.ndarray
    global_model: Optional[dict] = None
    prev_global: Optional[dict] = None


@dataclass(frozen=True)
class RoundTransforms:
    """Per-round behavior, as plain callables run inside every round.

    ``grad_transform(grads, update_mask) -> grads`` runs after the
    per-replica gradients and before the SGD update (grads may hold
    RowSparseGrad leaves); ``post_round(replicas) -> replicas`` runs after
    the update. Masked replicas must stay consistent with the algorithm's
    semantics: a transform must not leak a masked replica's (zero) gradient
    into live ones.
    """

    grad_transform: Optional[Callable[[dict, Any], dict]] = None
    post_round: Optional[Callable[[dict], dict]] = None


@dataclass(frozen=True)
class MergeOutcome:
    """What the barrier produced: the (R, ...) replicas training continues
    from, the global model for evaluation, and the Algorithm-2 diagnostics
    (``alphas``/``pert_active``) for the metrics log."""

    replicas: dict
    global_model: dict
    prev_global: Optional[dict] = None
    alphas: Optional[np.ndarray] = None
    pert_active: bool = False


# --------------------------------------------------------------------------
# the strategy protocol
# --------------------------------------------------------------------------


class Algorithm:
    """Base strategy: K-step model averaging over a static equal plan.

    Subclasses override only the hooks whose behavior differs.
    """

    #: registry key, set by @register
    name: str = "?"

    #: membership-change contract, consumed by ``ElasticTrainer.resize``:
    #:   'merge'    — default. Every current replica (leavers included)
    #:                contributes a final normalized merge; the whole new
    #:                population restarts from the merged global.
    #:   'preserve' — the final merge still folds the leavers' updates into
    #:                the global, but survivors keep their own (diverged)
    #:                parameters; only joiners clone the merged global
    #:                (CROSSBOW's independent learners).
    resize_policy: str = "merge"

    #: True when the round transforms reduce across replicas inside every
    #: round (sync's gradient mean, CROSSBOW's center): a placement that
    #: exchanges only at the barrier (the reference's multi-process host
    #: span) cannot run them.
    round_collectives: bool = False

    # ---- state ----
    def init_state_extras(self, cfg, params, keep_global_copies: bool) -> StateExtras:
        """``params`` is None (and ``keep_global_copies`` False) when
        ``resize_b`` sizes joiners."""
        # paper: initialize at b_max (Fig. 10a)
        return StateExtras(b=np.full(cfg.n_replicas, float(cfg.b_max)))

    # ---- planning ----
    def plan(self, scheduler, state, mega_samples: int, fetch_fn):
        """Default: static equal partitioning (the slowest replica
        dictates the barrier, paper Fig. 3)."""
        R = scheduler.cfg.n_replicas
        per_rep = max(1, int(round(mega_samples / (R * state.b[0]))))
        return scheduler.plan_static(int(state.b[0]), per_rep, fetch_fn=fetch_fn)

    def _plan_dynamic(self, scheduler, state, mega_samples: int, fetch_fn):
        """Availability-driven dispatch over the virtual clock (paper §3.1)."""
        return scheduler.plan_megabatch(
            np.round(state.b).astype(np.int64), mega_samples, fetch_fn=fetch_fn
        )

    # ---- per-round behavior ----
    def round_transforms(self, cfg) -> RoundTransforms:
        return RoundTransforms()

    # ---- barrier ----
    def merge(self, trainer, state, plan, replicas) -> MergeOutcome:
        """Plain average of the replicas (no global-model momentum)."""
        R = trainer.cfg.n_replicas
        alphas = np.full(R, 1.0 / R)
        new_global, new_replicas = trainer.merge_models(
            replicas, alphas, None, None, 0.0
        )
        return MergeOutcome(
            replicas=new_replicas, global_model=new_global, alphas=alphas
        )

    # ---- between-mega-batch adaptation ----
    def adapt(self, state, plan, cfg):
        return state.b, state.lr

    # ---- accounting ----
    def merges_per_megabatch(self, plan) -> int:
        return 1

    def resolve_n_replicas(self, requested: int) -> int:
        return requested

    # ---- membership change ----
    def resize_b(self, cfg, b: np.ndarray, lr: np.ndarray, base_lr: float):
        """Per-replica batch sizes / learning rates for the resized
        population; ``cfg`` is the new config, ``b``/``lr`` the old arrays.

        Default: survivors keep their adapted values (Algorithm 1 resumes
        from them at the new R on the next ``adapt``); joiners start at the
        algorithm's initial batch size (``init_state_extras(cfg, None, False)``)
        with the linear-scaling learning rate. A shrink consults nothing.
        """
        new_R = cfg.n_replicas
        keep = min(len(b), new_R)
        new_b = np.empty(new_R, np.float64)
        new_b[:keep] = np.asarray(b, np.float64)[:keep]
        new_lr = np.empty(new_R, np.float64)
        new_lr[:keep] = np.asarray(lr, np.float64)[:keep]
        if new_R > keep:
            init_b = np.asarray(self.init_state_extras(cfg, None, False).b, np.float64)
            new_b[keep:] = init_b[keep:new_R]
            new_lr[keep:] = base_lr * new_b[keep:] / cfg.b_max
        return new_b, new_lr


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, type[Algorithm]] = {}


def register(name: str):
    """Class decorator: ``@register("my_algo")`` on an Algorithm subclass."""

    def deco(cls):
        if not (isinstance(cls, type) and issubclass(cls, Algorithm)):
            raise TypeError(f"{cls!r} must subclass Algorithm")
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"algorithm {name!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get(name: str) -> Algorithm:
    """Resolve a registered algorithm to a fresh strategy instance."""
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"unknown algorithm {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def available() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))

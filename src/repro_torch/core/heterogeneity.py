"""Device heterogeneity model + virtual clock.

Copied from ``repro/core/heterogeneity.py`` (``SpeedModel``, ``CostModel``,
``VirtualClock``, with their membership and checkpoint methods); the
simulated speeds draw the same numpy random stream.

The paper identifies two sources of heterogeneity (§1):
  1. intrinsic device variance — identical GPUs differ by up to 32% on the
     same batch (paper Fig. 1);
  2. sparse-data variance — per-batch non-zero counts differ, and sparse
     kernels are cardinality-sensitive.

(1) is simulated with a per-replica speed factor and (2) is taken directly
from the data (total nnz of each batch). ``CostModel.step_time`` returns the
virtual seconds a replica needs for a batch; the scheduler's discrete-event
simulation runs on this clock. The algorithm only ever sees *relative
speeds*, exactly as in the paper.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SpeedModel:
    """Per-replica multiplicative slowdown factors.

    ``max_gap`` = 0.32 reproduces the paper's observed fastest/slowest gap.
    ``jitter`` adds per-step lognormal noise (clock/memory-latency
    oscillation); ``drift`` lets factors wander over time so the adaptive
    algorithm has something to track.
    """

    n_replicas: int
    max_gap: float = 0.32
    jitter: float = 0.03
    drift: float = 0.0
    seed: int = 0
    factors: np.ndarray = field(init=False)
    _rng: np.random.Generator = field(init=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        if self.n_replicas == 1:
            self.factors = np.ones(1)
        else:
            # evenly spread in [1, 1+max_gap], randomly permuted
            base = 1.0 + np.linspace(0.0, self.max_gap, self.n_replicas)
            self.factors = self._rng.permutation(base)

    def step_factor(self, i: int) -> float:
        f = self.factors[i]
        if self.jitter > 0:
            f *= float(self._rng.lognormal(0.0, self.jitter))
        return float(f)

    def advance(self) -> None:
        """Random-walk drift of the underlying factors (optional); the
        fastest replica stays pinned at 1.0 and the gap stays within twice
        ``max_gap``."""
        if self.drift > 0:
            self.factors *= np.exp(self._rng.normal(0.0, self.drift, self.n_replicas))
            self.factors /= self.factors.min()  # fastest pinned to 1.0
            self.factors = np.clip(self.factors, 1.0, 1.0 + 2 * self.max_gap)

    def resize(self, new_R: int) -> None:
        """Membership change: survivors keep their current factors, joiners
        start at the homogeneous prior (1.0). After a shrink the surviving
        factors are renormalized so the fastest is again 1.0."""
        keep = min(self.n_replicas, new_R)
        factors = np.ones(new_R)
        factors[:keep] = self.factors[:keep]
        self.factors = factors / factors.min()
        self.n_replicas = new_R

    def permute(self, perm) -> None:
        """Reorder replica slots (targeted eviction moves the evicted slot
        to the tail before a shrink). Pure relabeling: no renormalization."""
        self.factors = self.factors[np.asarray(perm, np.int64)]

    # ---- checkpointing ----
    def state_dict(self) -> dict:
        """Factor arrays (``arrays`` -> tensor store) plus the jitter/drift
        RNG (``meta`` -> JSON metadata), so a restored run replays the same
        simulated heterogeneity."""
        return {
            "arrays": {"factors": self.factors.copy()},
            "meta": {"kind": "simulated",
                     "rng": self._rng.bit_generator.state},
        }

    def load_state_dict(self, sd: dict) -> None:
        self.factors = np.asarray(sd["arrays"]["factors"], np.float64).copy()
        self.n_replicas = len(self.factors)
        self._rng.bit_generator.state = sd["meta"]["rng"]


@dataclass
class CostModel:
    """Virtual step time of one batch on one replica.

    time = speed_i * (overhead + work_cost * work_units)

    ``work_units`` is the total nnz of a sparse batch (cuSPARSE-like
    cardinality sensitivity).
    """

    speed: SpeedModel
    overhead: float = 1.0e-3
    work_cost: float = 2.0e-6

    def step_time(self, replica: int, work_units: int) -> float:
        return self.speed.step_factor(replica) * (
            self.overhead + self.work_cost * float(work_units)
        )


@dataclass
class VirtualClock:
    """Per-replica virtual timelines; merge barrier = max over replicas."""

    n_replicas: int
    t: np.ndarray = field(init=False)

    def __post_init__(self):
        self.t = np.zeros(self.n_replicas)

    def earliest(self) -> int:
        return int(np.argmin(self.t))

    def resize(self, new_R: int) -> None:
        """Membership change: survivors keep their virtual timelines;
        joiners enter at the latest survivor time (between mega-batches all
        clocks sit at the barrier, so this is the barrier time)."""
        keep = min(self.n_replicas, new_R)
        t = np.full(new_R, float(self.t[:keep].max()) if keep else 0.0)
        t[:keep] = self.t[:keep]
        self.t = t
        self.n_replicas = new_R

    def permute(self, perm) -> None:
        """Reorder replica timelines (targeted eviction)."""
        self.t = self.t[np.asarray(perm, np.int64)]

    def advance(self, i: int, dt: float) -> None:
        self.t[i] += dt

    def barrier(self) -> float:
        """All replicas wait for the slowest (synchronization point)."""
        m = float(self.t.max())
        self.t[:] = m
        return m

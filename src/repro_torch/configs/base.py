"""Adaptive SGD / elastic averaging hyperparameters (paper Alg. 1 + 2).

Copied from ``repro/configs/base.py`` (``ElasticConfig``).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ElasticConfig:
    algorithm: str = "adaptive"  # any key in the core/algorithms registry
    placement: str = "vmap"      # replica execution placement: only 'vmap'
                                 # (all replicas on one device, vectorized
                                 # over the leading R dim) is ported so far
    n_replicas: int = 4
    mega_batch: int = 100        # batches between merges (paper default 100)
    b_max: int = 256             # max per-replica batch size (slots)
    b_min: int = 32              # paper: b_max / 8
    beta: float = 16.0           # paper: b_min / 2
    pert_thr: float = 0.10       # perturbation threshold (Alg. 2)
    delta: float = 0.10          # perturbation factor (Alg. 2)
    gamma: float = 0.90          # global-model momentum (Alg. 2)
    replica_axis: str = "data"
    # CROSSBOW-only: correction rate of local replica toward global average
    crossbow_correction: float = 0.1

    @staticmethod
    def from_bmax(b_max: int, **kw) -> "ElasticConfig":
        """Paper's default derivation: b_min = b_max/8, beta = b_min/2."""
        b_min = max(1, b_max // 8)
        return ElasticConfig(b_max=b_max, b_min=b_min, beta=b_min / 2, **kw)

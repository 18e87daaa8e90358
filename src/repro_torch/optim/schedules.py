"""Learning-rate schedules: the linear-scaling rule and warmup.

Copied from ``repro/optim/schedules.py`` (``linear_scaled_lr``, ``rescale_lr``,
``warmup_factor``, ``cosine_decay``).

The paper (following Goyal et al. [19]) couples batch size and learning rate
linearly: when Algorithm 1 rescales ``b_i -> b_i'`` it applies
``lr_i <- lr_i * b_i'/b_i``. Warmup addresses the instability of large
initial rates. Both are host-side scalar functions (they feed the per-replica
lr vector passed into sgd_update).
"""
from __future__ import annotations

import numpy as np


def linear_scaled_lr(base_lr: float, base_batch: int, batch) -> np.ndarray:
    """lr for batch size(s) ``batch`` given a reference (base_lr, base_batch)."""
    return np.asarray(base_lr, np.float64) * np.asarray(batch, np.float64) / base_batch


def rescale_lr(lr, old_batch, new_batch) -> np.ndarray:
    """Algorithm 1 lines 4/7: lr' = lr * b'/b (elementwise)."""
    old = np.maximum(np.asarray(old_batch, np.float64), 1.0)
    return np.asarray(lr, np.float64) * np.asarray(new_batch, np.float64) / old


def warmup_factor(step: int, warmup_steps: int) -> float:
    """Linear warmup from 1/warmup to 1.0 over warmup_steps (paper's warmup)."""
    if warmup_steps <= 0 or step >= warmup_steps:
        return 1.0
    return (step + 1) / warmup_steps


def cosine_decay(step: int, total: int, floor: float = 0.1) -> float:
    if total <= 0:
        return 1.0
    t = min(step, total) / total
    return floor + (1 - floor) * 0.5 * (1 + np.cos(np.pi * t))

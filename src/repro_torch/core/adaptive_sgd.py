"""Algorithms 1 & 2 of the paper.

Port of ``repro/core/adaptive_sgd.py``; the host-side numpy functions are
copied verbatim.

* ``batch_size_scaling`` — Algorithm 1 (host, numpy): rescale each
  replica's batch size and learning rate by its deviation from the mean
  update count.
* ``merge_weights`` / ``apply_perturbation`` — Algorithm 2's normalization
  and perturbation of the merge weights (host, numpy).
* ``normalized_merge`` — Algorithm 2's model update on the device: the
  weighted average of the replicas plus the global-model momentum.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ElasticConfig
from repro_torch.kernels.weighted_merge.ops import merge_pytree
from repro_torch.utils import tree as tu

# --------------------------------------------------------------------------
# Algorithm 1: Batch Size Scaling
# --------------------------------------------------------------------------


def batch_size_scaling(
    b: np.ndarray, lr: np.ndarray, u: np.ndarray, cfg: ElasticConfig
) -> tuple[np.ndarray, np.ndarray]:
    """One application of Algorithm 1.

    b, lr, u: per-replica batch size, learning rate, update count since the
    last merge. Returns updated (b, lr). Faster replicas (u_i > mean) get
    larger batches; slower ones smaller; lr follows the linear-scaling rule.
    """
    b = np.asarray(b, np.float64).copy()
    lr = np.asarray(lr, np.float64).copy()
    u = np.asarray(u, np.float64)
    mu = u.mean()  # line 1
    for i in range(len(b)):
        if u[i] > mu and b[i] + cfg.beta * (u[i] - mu) <= cfg.b_max:  # line 3
            new_b = b[i] + cfg.beta * (u[i] - mu)
            lr[i] = lr[i] * new_b / b[i]  # line 4
            b[i] = new_b  # line 5
        elif u[i] < mu and b[i] - cfg.beta * (mu - u[i]) >= cfg.b_min:  # line 6
            new_b = b[i] - cfg.beta * (mu - u[i])
            lr[i] = lr[i] * new_b / b[i]  # line 7
            b[i] = new_b  # line 8
    return b, lr


# --------------------------------------------------------------------------
# Algorithm 2: Normalized Model Merging
# --------------------------------------------------------------------------


def merge_weights(u: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Lines 1-6: alpha_i from update counts (if they differ) else batch sizes."""
    u = np.asarray(u, np.float64)
    b = np.asarray(b, np.float64)
    if np.all(u == u[0]):  # line 2: identical update counts
        alphas = b / b.sum()  # line 3
    else:
        alphas = u / u.sum()  # line 5
    return alphas


def apply_perturbation(
    alphas: np.ndarray,
    u: np.ndarray,
    replica_norms_per_param: np.ndarray,
    cfg: ElasticConfig,
) -> tuple[np.ndarray, bool]:
    """Lines 7-10: boost the most-updated replica when all are regularized.

    ``replica_norms_per_param`` = ||w_i||_2 / |w| for each replica.
    Returns (alphas, activated). Note the deliberate denormalization.
    """
    alphas = np.asarray(alphas, np.float64).copy()
    if len(alphas) < 2:
        return alphas, False
    if np.all(replica_norms_per_param < cfg.pert_thr):  # line 7
        r = int(np.argmax(u))  # line 8
        s = int(np.argmin(u))
        if r != s:
            alphas[r] *= 1.0 + cfg.delta  # line 9
            alphas[s] *= 1.0 - cfg.delta
            return alphas, True
    return alphas, False


def normalized_merge(
    replicas: dict,
    alphas,
    global_model: Optional[dict],
    prev_global: Optional[dict],
    gamma: float,
    axis: Optional[str] = None,
) -> dict:
    """Lines 11-12: w' = sum_i alpha_i w_i + gamma (w̄ - w̄_p).

    ``replicas`` leaves have a leading replica dim R. Returns the new global
    model w'. When global/prev are None, or gamma is 0, the momentum term is
    skipped.

    Every leaf goes through the weighted-merge op (``kernels/weighted_merge``),
    momentum term fused: the CUDA kernel on the card, its plain version on
    the CPU, both accumulating in f32.

    ``axis`` — set in a shard's worker under the sharded placement, where
    ``replicas`` and ``alphas`` are the shard's own: the shard's weighted
    sum (the op's no-momentum branch) is a partial of line 11, summed over
    the shards in shard order; the momentum term is then added in f32 to
    the complete sum and the result cast once, as the reference's psum path
    does. Every shard returns the new global on its own device.
    """
    device = next(iter(replicas.values())).device
    alphas = torch.as_tensor(np.asarray(alphas), dtype=torch.float32, device=device)
    momentum = not (global_model is None or prev_global is None or gamma == 0.0)
    if axis is None:
        if not momentum:
            return merge_pytree(replicas, alphas)
        return merge_pytree(replicas, alphas, global_model, prev_global, gamma)
    merged = tu.tree_map(lambda l: tu.replica_all_sum(l, axis), merge_pytree(replicas, alphas))
    if not momentum:
        return merged
    return tu.tree_map(
        lambda m, g, gp: (m.float() + gamma * (g.float() - gp.float())).to(m.dtype),
        merged, global_model, prev_global,
    )


def replica_regularization(replicas: dict) -> np.ndarray:
    """||w_i||_2 / |w| per replica (feeds the line-7 condition)."""
    norms = tu.tree_l2_norm_per_replica(replicas)
    n_param = tu.tree_size(replicas) / norms.shape[0]
    return norms.cpu().numpy() / n_param

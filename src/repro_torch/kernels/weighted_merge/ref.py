"""Plain PyTorch version of the weighted model merge (Algorithm 2, line 11).

Port of ``repro/kernels/weighted_merge/ref.py::weighted_merge_ref``:

  out = sum_r alphas[r] * replicas[r]  (+ gamma * (g - gp) when g is given
  and gamma != 0)

over replicas (R, N), accumulated in f32 and returned in the replicas'
dtype. The CPU path of ``ops.merge`` and the oracle the CUDA kernel is held
against.
"""
from __future__ import annotations

import torch


def weighted_merge_ref(replicas, alphas, g=None, gp=None, gamma: float = 0.0):
    acc = torch.einsum("r,rn->n", alphas.float(), replicas.float())
    if g is not None and gamma != 0.0:
        acc = acc + gamma * (g.float() - gp.float())
    return acc.to(replicas.dtype)

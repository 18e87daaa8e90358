"""Plain PyTorch version of the padded-COO sparse input layer (SpMM).

Port of ``repro/kernels/spmm/ref.py::spmm_ref``:

  h[..., b, :] = sum_k  mask[..., b, k] * val[..., b, k] * W[..., idx[..., b, k], :]

with an optional leading replica dim (idx/val/mask (R,B,K), W (R,NF,H)).
Accumulates in f32 and returns W's dtype. The CPU path of ``ops.spmm`` and
the oracle the CUDA kernel is held against.
"""
from __future__ import annotations

import torch


def spmm_ref(feat_idx, feat_val, feat_mask, w):
    idx = feat_idx.long()
    if w.ndim == 2:
        rows = w[idx]                                            # (B, K, H)
    else:
        rep = torch.arange(w.shape[0], device=w.device).view(-1, 1, 1)
        rows = w[rep, idx]                                       # (R, B, K, H)
    scale = (feat_val * feat_mask).float()[..., None]
    return (rows.float() * scale).sum(dim=-2).to(w.dtype)

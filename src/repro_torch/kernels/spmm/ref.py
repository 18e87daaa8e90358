"""Plain PyTorch versions of the padded-COO sparse input layer (SpMM) and
its backward.

Port of ``repro/kernels/spmm/ref.py``:

  h[..., b, :] = sum_k  mask[..., b, k] * val[..., b, k] * W[..., idx[..., b, k], :]

with an optional leading replica dim (idx/val/mask (R,B,K), W (R,NF,H)).
Accumulates in f32. The CPU path of ``ops.spmm``/``ops.spmm_grad_w`` and
the oracles the CUDA kernels are held against.
"""
from __future__ import annotations

import math

import torch


def _gather_rows(feat_idx, w):
    """W rows named by each slot: (…, B, K, H), replica r from W[r]."""
    idx = feat_idx.long()
    if w.ndim == 2:
        return w[idx]
    rep = torch.arange(w.shape[0], device=w.device).view(-1, 1, 1)
    return w[rep, idx]


def spmm_ref(feat_idx, feat_val, feat_mask, w):
    """Returns (…, B, H) in W's dtype."""
    rows = _gather_rows(feat_idx, w)                             # (…, B, K, H)
    scale = (feat_val * feat_mask).float()[..., None]
    return (rows.float() * scale).sum(dim=-2).to(w.dtype)


def spmm_grad_w_ref(feat_idx, feat_val, feat_mask, dh, n_rows: int):
    """Transpose of spmm_ref: dW[r] = sum_{idx[b,k]=r} scale[b,k]*dh[b].

    A zero (…, n_rows, H) f32 tensor plus one ``index_add_`` over the
    flattened slots. Masked slots are multiplied in (scale 0), not dropped,
    as in the reference: a NaN in ``dh[b]`` reaches row ``idx[b,k]``.
    """
    *lead, B, K = feat_idx.shape
    H = dh.shape[-1]
    L = math.prod(lead)
    scale = (feat_val * feat_mask).float()
    vals = scale[..., None] * dh.float()[..., None, :]             # (…, B, K, H)
    offsets = torch.arange(L, device=dh.device).view(-1, 1) * n_rows
    flat = (feat_idx.reshape(L, B * K).long() + offsets).reshape(-1)
    out = torch.zeros((L * n_rows, H), dtype=torch.float32, device=dh.device)
    out.index_add_(0, flat, vals.reshape(L * B * K, H))
    return out.reshape(*lead, n_rows, H)


def spmm_grad_val_ref(feat_idx, feat_mask, w, dh):
    """d feat_val[…, b, k] = mask[…, b, k] * <dh[…, b], W[…, idx[…, b, k]]>, f32."""
    rows = _gather_rows(feat_idx, w)                             # (…, B, K, H)
    dv = torch.einsum("...bkh,...bh->...bk", rows.float(), dh.float())
    return dv * feat_mask

"""Plain PyTorch version of the flash-attention kernel: exact softmax
attention, GQA-native, causal / sliding-window.

Port of ``repro/kernels/flash_attention/ref.py``. q (B, Sq, Hq, hd);
k, v (B, Skv, Hkv, hd); Hq % Hkv == 0. f32 math, output in q's dtype.
"""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal=True, window=0):
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    qf = q.float().reshape(b, sq, hkv, rep, hd)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qf, k.float()) * (hd ** -0.5)
    rel = (torch.arange(sq, device=q.device)[:, None]
           - torch.arange(skv, device=q.device)[None, :])
    allow = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        allow &= rel >= 0
    if window > 0:
        allow &= rel < window
    s = torch.where(allow, s, float("-inf"))
    # a row with no allowed key: exp(-inf - -inf) is NaN, selected away to 0
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(allow, p, 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhrqk,bkhd->bqhrd", p, v.float())
    return o.reshape(b, sq, hq, hd).to(q.dtype)

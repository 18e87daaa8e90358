"""Public entry for the SpMM kernel (sparse XML input layer).

``spmm`` runs the plain version (``ref.spmm_ref``) on CPU tensors and the
CUDA kernel (``csrc/spmm.cu``) on CUDA tensors; there is no switch that
sends a CUDA tensor to the plain version. Forward only: the model emits
d``w1`` itself as a RowSparseGrad, so no backward kernel is on this path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

from .ref import spmm_ref


def spmm(feat_idx, feat_val, feat_mask, w):
    """Padded-COO batch x dense W.

    idx (…, B, K) int32, val (…, B, K) f32, mask (…, B, K) bool and
    W (…, NF, H) f32/bf16, with an optional leading replica dim R shared by
    all four. Returns (…, B, H) in W's dtype, accumulated in f32.
    """
    if all(t.device.type == "cpu" for t in (feat_idx, feat_val, feat_mask, w)):
        return spmm_ref(feat_idx, feat_val, feat_mask, w)
    return spmm_cuda(feat_idx, feat_val, feat_mask, w)


def spmm_cuda(feat_idx, feat_val, feat_mask, w):
    """Launch the CUDA kernel; raises on anything it does not take."""
    tensors = (feat_idx, feat_val, feat_mask, w)
    if w.device.type != "cuda" or any(t.device != w.device for t in tensors):
        raise ValueError("spmm_cuda needs all four tensors on one CUDA device")
    if feat_idx.dtype != torch.int32 or feat_val.dtype != torch.float32:
        raise TypeError("spmm_cuda needs int32 feat_idx and float32 feat_val")
    if feat_mask.dtype != torch.bool or w.dtype not in _build.DTYPE_CODES:
        raise TypeError("spmm_cuda needs bool feat_mask and float32/bfloat16 w")
    if not (feat_idx.shape == feat_val.shape == feat_mask.shape):
        raise ValueError("feat_idx, feat_val and feat_mask must share one shape")
    if w.ndim not in (2, 3) or feat_idx.ndim != w.ndim or (
        w.ndim == 3 and feat_idx.shape[0] != w.shape[0]
    ):
        raise ValueError(
            f"need (B,K) with (NF,H) or (R,B,K) with (R,NF,H); got "
            f"{tuple(feat_idx.shape)} and {tuple(w.shape)}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("spmm_cuda needs contiguous tensors")
    B, K = feat_idx.shape[-2:]
    NF, H = w.shape[-2:]
    R = w.shape[0] if w.ndim == 3 else 1
    out = torch.empty(feat_idx.shape[:-1] + (H,), dtype=w.dtype, device=w.device)
    with torch.cuda.device(w.device):
        err = _build.library().spmm_forward(
            feat_idx.data_ptr(), feat_val.data_ptr(), feat_mask.data_ptr(),
            w.data_ptr(), out.data_ptr(), R, B, K, NF, H, _build.DTYPE_CODES[w.dtype],
            torch.cuda.current_stream(w.device).cuda_stream,
        )
    _build.check(err, "spmm")
    spmm_cuda.launches += 1
    return out


spmm_cuda.launches = 0  # kernel launches since the last reset

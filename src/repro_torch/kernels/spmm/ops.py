"""Public entry for the SpMM kernels (sparse XML input layer).

Port of ``repro/kernels/spmm/ops.py``. ``spmm`` is differentiable with
respect to ``feat_val`` and ``w`` through a ``torch.autograd.Function``
(the reference's ``jax.custom_vjp``): the forward is the row-gather kernel
(``csrc/spmm.cu``), the backward for ``w`` the transpose kernel
``spmm_grad_w`` (``csrc/spmm_grad_w.cu``, after the counting sort of the
slots by row there, ``sort_rows_cuda``), and the backward for
``feat_val`` the plain gather-dot ``spmm_grad_val_ref``, which the
reference also computes outside any kernel. CPU tensors run the plain
versions (``ref.py``) and CUDA tensors the kernels; there is no switch that
sends a CUDA tensor to a plain version. The sparse-gradient path calls
``spmm`` under ``torch.no_grad()`` and so launches no backward kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

from .ref import SORT_TILE, sort_passes, spmm_grad_val_ref, spmm_grad_w_ref, spmm_ref

# sorted slots per block of the grad_w walk (csrc/spmm_grad_w.cu, at most 512)
GRAD_W_CHUNK = 128


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def spmm(feat_idx, feat_val, feat_mask, w):
    """Padded-COO batch x dense W.

    idx (…, B, K) int32, val (…, B, K) f32, mask (…, B, K) bool and
    W (…, NF, H) f32/bf16, with an optional leading replica dim R shared by
    all four. Returns (…, B, H) in W's dtype, accumulated in f32.
    Differentiable with respect to ``feat_val`` and ``w``.
    """
    return _Spmm.apply(feat_idx, feat_val, feat_mask, w)


def _spmm_forward(feat_idx, feat_val, feat_mask, w):
    if _on_cpu(feat_idx, feat_val, feat_mask, w):
        return spmm_ref(feat_idx, feat_val, feat_mask, w)
    return spmm_cuda(feat_idx, feat_val, feat_mask, w)


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat_idx, feat_val, feat_mask, w):
        ctx.save_for_backward(feat_idx, feat_val, feat_mask, w)
        return _spmm_forward(feat_idx, feat_val, feat_mask, w)

    @staticmethod
    def backward(ctx, dh):
        feat_idx, feat_val, feat_mask, w = ctx.saved_tensors
        dval = dw = None
        if ctx.needs_input_grad[1]:
            # d feat_val: gather-dot, same O(B*K*H) footprint as the forward
            dval = spmm_grad_val_ref(feat_idx, feat_mask, w, dh).to(feat_val.dtype)
        if ctx.needs_input_grad[3]:
            dw = spmm_grad_w(feat_idx, feat_val, feat_mask, dh, w.shape[-2]).to(w.dtype)
        return None, dval, None, dw


def spmm_grad_w(feat_idx, feat_val, feat_mask, dh, n_rows: int):
    """Transpose SpMM: dW[…, r] = sum_{idx[…,b,k]=r} val*mask*dh[…, b].

    idx/val/mask (…, B, K), dh (…, B, H), with the same optional leading
    replica dim. Returns (…, n_rows, H) f32; rows no slot names are 0.
    Every ``idx`` must lie in [0, n_rows), as for ``spmm``.
    """
    if _on_cpu(feat_idx, feat_val, feat_mask, dh):
        return spmm_grad_w_ref(feat_idx, feat_val, feat_mask, dh, n_rows)
    return spmm_grad_w_cuda(feat_idx, feat_val, feat_mask, dh, n_rows)


def _check_inputs(name, feat_idx, feat_val, feat_mask, dense):
    """The checks both CUDA wrappers make; ``dense`` is W or dh."""
    tensors = (feat_idx, feat_val, feat_mask, dense)
    if dense.device.type != "cuda" or any(t.device != dense.device for t in tensors):
        raise ValueError(f"{name} needs all four tensors on one CUDA device")
    if feat_idx.dtype != torch.int32 or feat_val.dtype != torch.float32:
        raise TypeError(f"{name} needs int32 feat_idx and float32 feat_val")
    if feat_mask.dtype != torch.bool:
        raise TypeError(f"{name} needs bool feat_mask")
    if not (feat_idx.shape == feat_val.shape == feat_mask.shape):
        raise ValueError("feat_idx, feat_val and feat_mask must share one shape")
    if dense.ndim not in (2, 3) or feat_idx.ndim != dense.ndim or (
        dense.ndim == 3 and feat_idx.shape[0] != dense.shape[0]
    ):
        raise ValueError(
            f"{name}: need (B,K) with a 2-D tensor or (R,B,K) with a 3-D one; got "
            f"{tuple(feat_idx.shape)} and {tuple(dense.shape)}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")


def spmm_cuda(feat_idx, feat_val, feat_mask, w):
    """Launch the forward CUDA kernel; raises on anything it does not take."""
    _check_inputs("spmm_cuda", feat_idx, feat_val, feat_mask, w)
    if w.dtype not in _build.DTYPE_CODES:
        raise TypeError("spmm_cuda needs float32/bfloat16 w")
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
    _build.count_launch(spmm_cuda)
    return out


spmm_cuda.launches = 0  # kernel launches since the last reset


def sort_rows_cuda(keys, n_rows: int, named=None):
    """Launch the counting sort: each replica's keys (R, S) int32 in
    [0, n_rows), sorted ascending with ties in slot order. Returns (rows,
    order) int32, as ``torch.sort(stable=True)`` gives them
    (``ref.sort_rows_ref`` is its plain version). ``named``, an
    (R, n_rows rounded up to 16) uint8 tensor, gets 1 at [r, k] where a key
    of replica r is k and 0 elsewhere below n_rows."""
    if keys.device.type != "cuda" or keys.dtype != torch.int32:
        raise ValueError("sort_rows_cuda needs int32 keys on a CUDA device")
    if keys.ndim != 2 or not keys.is_contiguous():
        raise ValueError(f"sort_rows_cuda needs contiguous (R, S) keys, got {tuple(keys.shape)}")
    R, S = keys.shape
    passes, bits = sort_passes(n_rows)
    rows, order = torch.empty_like(keys), torch.empty_like(keys)
    counts = torch.empty((passes * R * -(-S // SORT_TILE)) << bits, dtype=torch.int32,
                         device=keys.device)
    tmp = torch.empty(2 * min(passes - 1, 2) * R * S, dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        err = _build.library().spmm_sort_rows(
            keys.data_ptr(), rows.data_ptr(), order.data_ptr(), counts.data_ptr(),
            tmp.data_ptr(), None if named is None else named.data_ptr(), R, S, n_rows, bits,
            passes, SORT_TILE,
            torch.cuda.current_stream(keys.device).cuda_stream,
        )
    _build.check(err, "spmm_sort_rows")
    _build.count_launch(sort_rows_cuda)
    return rows, order


sort_rows_cuda.launches = 0  # kernel launches since the last reset


def spmm_grad_w_cuda(feat_idx, feat_val, feat_mask, dh, n_rows: int):
    """Launch the transpose CUDA kernel; raises on anything it does not take.

    Per replica the S = B*K slots are sorted by row id with the counting
    sort above (stable: the reference argsorts outside its Pallas kernel),
    which also marks the rows they name; the kernel reads each sorted slot's
    sample, val and mask through the order and writes every row of the
    uninitialised output once. ``dh`` is taken in f32, as the reference
    casts it.
    """
    dh = dh.float().contiguous()
    _check_inputs("spmm_grad_w_cuda", feat_idx, feat_val, feat_mask, dh)
    if dh.shape[:-1] != feat_idx.shape[:-1]:
        raise ValueError(f"dh {tuple(dh.shape)} does not match feat_idx "
                         f"{tuple(feat_idx.shape)}")
    B, K = feat_idx.shape[-2:]
    H = dh.shape[-1]
    R = dh.shape[0] if dh.ndim == 3 else 1
    S = B * K
    named = torch.empty((R, -(-n_rows // 16) * 16), dtype=torch.uint8, device=dh.device)
    rows, order = sort_rows_cuda(feat_idx.reshape(R, S), n_rows, named)
    out = torch.empty((R, n_rows, H), dtype=torch.float32, device=dh.device)
    n_chunks = -(-S // GRAD_W_CHUNK)
    head = torch.empty((R * n_chunks, H), dtype=torch.float32, device=dh.device)
    tail = torch.empty_like(head)
    with torch.cuda.device(dh.device):
        err = _build.library().spmm_grad_w(
            rows.data_ptr(), order.data_ptr(), named.data_ptr(), feat_val.data_ptr(),
            feat_mask.data_ptr(),
            dh.data_ptr(), out.data_ptr(), head.data_ptr(), tail.data_ptr(),
            R, S, B, K, n_rows, H, GRAD_W_CHUNK,
            torch.cuda.current_stream(dh.device).cuda_stream,
        )
    _build.check(err, "spmm_grad_w")
    _build.count_launch(spmm_grad_w_cuda)
    return out if dh.ndim == 3 else out[0]


spmm_grad_w_cuda.launches = 0  # kernel launches since the last reset

"""Plain PyTorch versions of the padded-COO sparse input layer (SpMM) and
its backward.

Port of ``repro/kernels/spmm/ref.py``:

  h[..., b, :] = sum_k  mask[..., b, k] * val[..., b, k] * W[..., idx[..., b, k], :]

with an optional leading replica dim (idx/val/mask (R,B,K), W (R,NF,H)).
Accumulates in f32. The CPU path of ``ops.spmm``/``ops.spmm_grad_w`` and
the oracles the CUDA kernels are held against; ``sort_rows_ref`` is the
counting sort of ``csrc/spmm_grad_w.cu`` pass by pass, which the transpose
kernel walks (the reference argsorts there, ``repro/kernels/spmm/spmm.py``).
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


def slot_scale(feat_val, feat_mask):
    """val * mask of each slot in f32, as the reference computes it: XLA
    turns a product with a converted bool into a select, so a masked slot's
    scale is exactly 0 even where its val is not finite."""
    return torch.where(feat_mask.bool(), feat_val, 0).float()


def spmm_ref(feat_idx, feat_val, feat_mask, w):
    """Returns (…, B, H) in W's dtype."""
    rows = _gather_rows(feat_idx, w)                             # (…, B, K, H)
    scale = slot_scale(feat_val, feat_mask)[..., None]
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
    scale = slot_scale(feat_val, feat_mask)
    vals = scale[..., None] * dh.float()[..., None, :]             # (…, B, K, H)
    offsets = torch.arange(L, device=dh.device).view(-1, 1) * n_rows
    flat = (feat_idx.reshape(L, B * K).long() + offsets).reshape(-1)
    out = torch.zeros((L * n_rows, H), dtype=torch.float32, device=dh.device)
    out.index_add_(0, flat, vals.reshape(L * B * K, H))
    return out.reshape(*lead, n_rows, H)


def spmm_grad_val_ref(feat_idx, feat_mask, w, dh):
    """d feat_val[…, b, k] = mask[…, b, k] * <dh[…, b], W[…, idx[…, b, k]]>, f32
    (exactly 0 for a masked slot, as the reference's select gives it)."""
    rows = _gather_rows(feat_idx, w)                             # (…, B, K, H)
    dv = torch.einsum("...bkh,...bh->...bk", rows.float(), dh.float())
    return torch.where(feat_mask.bool(), dv, 0)


SORT_TILE = 2048      # keys a block of the counting sort (csrc/spmm_grad_w.cu kSortTile)
SORT_DIGIT_BITS = 9   # the widest digit a pass sorts on: 512 buckets


def sort_passes(n_rows: int) -> tuple[int, int]:
    """(passes, digit bits) of the counting sort of keys in [0, n_rows):
    as few passes of at most 9 bits as cover the keys, of equal width, at
    least 2 bits (the kernel reads the counts of two digits at once)."""
    bits = max(2, (n_rows - 1).bit_length())
    passes = -(-bits // SORT_DIGIT_BITS)
    return passes, -(-bits // passes)


def sort_rows_ref(keys, n_rows: int, tile: int = SORT_TILE):
    """Each replica's keys (R, S) int32 in [0, n_rows), sorted ascending with
    ties in slot order: (rows, order) int32, as ``torch.sort(stable=True)``
    gives them.

    The kernel's passes in plain torch: least significant digit first, each
    pass a stable scatter by one digit. Per tile of ``tile`` keys the digit
    counts; a key's place is the replica's keys of smaller digits, plus its
    digit's keys in earlier tiles, plus those before it in its own tile.
    """
    R, S = keys.shape
    passes, bits = sort_passes(n_rows)
    radix = 1 << bits
    n_tiles = -(-S // tile)
    slot = torch.arange(S, device=keys.device)
    tile_of = slot // tile
    cur_k = keys.long()
    cur_v = slot.expand(R, S)
    for p in range(passes):
        digit = (cur_k >> (p * bits)) & (radix - 1)
        bucket = tile_of * radix + digit                           # (R, S)
        counts = torch.zeros((R, n_tiles * radix), dtype=torch.long, device=keys.device)
        counts.scatter_add_(1, bucket, torch.ones_like(bucket))
        by_digit = counts.view(R, n_tiles, radix).transpose(1, 2).reshape(R, -1)
        start = (by_digit.cumsum(1) - by_digit).view(R, radix, n_tiles).transpose(1, 2)
        # a key's rank in its tile: the keys of its digit before it there
        rank = torch.empty_like(digit)
        for t in range(n_tiles):
            part = digit[:, t * tile:(t + 1) * tile]
            seen = torch.nn.functional.one_hot(part, radix).cumsum(1)
            rank[:, t * tile:(t + 1) * tile] = seen.gather(2, part[..., None])[..., 0] - 1
        pos = start.reshape(R, -1).gather(1, bucket) + rank
        cur_k = torch.empty_like(cur_k).scatter_(1, pos, cur_k)
        cur_v = torch.empty_like(cur_k).scatter_(1, pos, cur_v)
    return cur_k.int(), cur_v.int()

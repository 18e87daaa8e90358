"""Row-sparse gradient representation for embedding-style parameters.

Port of ``repro/optim/row_sparse.py``. The XML input layer touches only the
~B*K embedding rows gathered by a batch, so its gradient is row-sparse:
``RowSparseGrad`` carries the touched ``rows`` and the per-slot row
gradients ``vals`` as an *unreduced* padded COO — duplicates allowed,
static shapes. Slots whose row id is ``>= n_rows`` are padding sentinels.
JAX drops out-of-bounds scatter updates silently; torch's ``index_add_``
raises on them (and faults on CUDA), so every scatter here clamps the
sentinel rows to a valid row and zeroes their payload with ``torch.where``
first — a select, not a product, so a NaN in a sentinel slot stays out.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RowSparseGrad:
    """Gradient of a (..., n_rows, H) parameter, touched rows only.

    rows: (..., S) int — row ids; >= n_rows marks a padded/masked slot.
    vals: (..., S, H)  — per-slot row gradient (unreduced; duplicates add).
    n_rows: int        — the dense row count NF.
    """

    rows: torch.Tensor
    vals: torch.Tensor
    n_rows: int

    def densify(self) -> torch.Tensor:
        """Scatter-add into a dense (..., n_rows, H) f32 tensor."""
        lead, (S, H) = self.rows.shape[:-1], self.vals.shape[-2:]
        L = math.prod(lead)
        flat, valid = flat_rows(self.rows.reshape(L, S), self.n_rows)
        vals = torch.where(valid[:, None], self.vals.reshape(L * S, H).float(), 0.0)
        out = torch.zeros((L * self.n_rows, H), dtype=torch.float32, device=self.vals.device)
        out.index_add_(0, flat, vals)
        return out.reshape(*lead, self.n_rows, H)


def is_row_sparse(x) -> bool:
    return isinstance(x, RowSparseGrad)


def densify_tree(grads: dict) -> dict:
    """Replace every RowSparseGrad leaf with its dense scatter-add."""
    return {k: g.densify() if is_row_sparse(g) else g for k, g in grads.items()}


def flat_rows(rows: torch.Tensor, n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, S) row ids -> ((L*S,) int64 ids into the (L*n_rows, H) flattening
    of an (L, n_rows, H) parameter, (L*S,) in-bounds mask). Sentinel slots
    point at row 0 of their own slice; callers zero their payload."""
    valid = rows < n_rows
    offsets = torch.arange(rows.shape[0], device=rows.device).view(-1, 1) * n_rows
    flat = torch.where(valid, rows.long(), 0) + offsets
    return flat.reshape(-1), valid.reshape(-1)


def first_occurrence(rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(..., S) f32: 1.0 at the first slot of each distinct in-bounds row id,
    along the last dim.

    Per-row-once weights for the lazy weight-decay/momentum terms: with
    duplicates, gather-modify-scatter would apply a per-row term once per
    *slot*; multiplying by this mask applies it once per *row*. Sentinel
    (out-of-bounds) slots get 0. The sort is stable, as ``jnp.argsort``.
    """
    sorted_rows, order = torch.sort(rows, dim=-1, stable=True)
    first_sorted = torch.ones(rows.shape, dtype=torch.float32, device=rows.device)
    first_sorted[..., 1:] = (sorted_rows[..., 1:] != sorted_rows[..., :-1]).float()
    first = torch.zeros_like(first_sorted).scatter_(-1, order, first_sorted)
    return first * (rows < n_rows)

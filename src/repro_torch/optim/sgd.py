"""SGD for the replicas' local updates.

Port of ``repro/optim/sgd.py``. Every parameter leaf carries a leading
replica dim R; the learning rate is a scalar or an (R,) vector (the
paper's per-GPU learning rate, Alg. 1 lines 4/7) and ``update_mask`` an
(R,) 0/1 vector (the masked lockstep round). Unlike the reference, the
update is **in place**: ``sgd_update`` writes the new values into the
parameter and momentum tensors it is given and returns them. That takes
the place of the reference's buffer donation.

Row-sparse gradients (``RowSparseGrad``) scatter only the touched rows,
with the reference's semantics:

* plain SGD (momentum=0, weight_decay=0) matches densifying the gradient
  and running the dense update;
* weight decay is lazy: touched rows decay exactly once per row;
* momentum is lazy: touched rows get ``m' = mu*m + g``, untouched rows keep
  their momentum; Nesterov steps touched slots by ``g + mu*m'``;
* ``grad_clip`` densifies sparse leaves first (the global norm needs the
  duplicate-reduced gradient), so clipped configs pay the dense cost.

The dense rule multiplies by ``momentum`` and ``weight_decay`` rounded to
the leaf's dtype, as JAX does with a Python scalar (in bf16 ``0.9`` is
``0.8984375``), so a bf16 step is the reference's bit for bit; the
row-sparse rule computes in f32 in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.optim.row_sparse import (
    RowSparseGrad,
    densify_tree,
    first_occurrence,
    flat_rows,
)


@dataclass(frozen=True)
class SGDConfig:
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0
    grad_clip: float = 0.0  # 0 = off; global-norm clip per replica


def init_momentum(params: dict, cfg: SGDConfig) -> Optional[dict]:
    if cfg.momentum == 0.0:
        return None
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _per_replica(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast a scalar or (R,) tensor against an (R, ...) leaf."""
    return v if v.ndim == 0 else v.reshape((-1,) + (1,) * (ndim - 1))


def clip_by_global_norm(grads: dict, max_norm: float, replica_dim: bool) -> dict:
    """Scale dense ``grads`` so their global L2 norm is at most
    ``max_norm``: one norm over every leaf, or with ``replica_dim`` one per
    replica (the leaves' leading dim). Returns new tensors."""
    if max_norm <= 0.0:
        return grads
    leaves = list(grads.values())
    if replica_dim:
        sq = sum(l.float().square().flatten(1).sum(dim=1) for l in leaves)
        scale = torch.clamp(max_norm / (torch.sqrt(sq) + 1e-9), max=1.0)  # (R,)
        return {k: (l.float() * _per_replica(scale, l.ndim)).to(l.dtype)
                for k, l in grads.items()}
    norm = torch.sqrt(sum(l.float().square().sum() for l in leaves))
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: (l * scale).to(l.dtype) for k, l in grads.items()}


def _in_dtype(c: float, dtype: torch.dtype) -> float:
    """The Python coefficient ``c`` rounded to ``dtype`` (JAX's weak-typed
    scalar times a leaf)."""
    return torch.tensor(c, dtype=dtype).item()


def _dense_leaf_update(p, g, m, lr, cfg: SGDConfig, update_mask):
    """The dense rule: wd -> momentum -> masked step, written into p (and m)."""
    if cfg.weight_decay:
        g = g + _in_dtype(cfg.weight_decay, g.dtype) * p.to(g.dtype)
    new_m = None
    if m is not None:
        new_m = _in_dtype(cfg.momentum, m.dtype) * m + g.to(m.dtype)
        g = g + _in_dtype(cfg.momentum, new_m.dtype) * new_m if cfg.nesterov else new_m
    delta = _per_replica(lr, p.ndim) * g.float()
    if update_mask is not None:
        delta = delta * _per_replica(update_mask, p.ndim)
    p.copy_(p.float() - delta)
    if new_m is not None:
        if update_mask is not None:
            # frozen replicas must not accumulate momentum either
            new_m = torch.where(_per_replica(update_mask, m.ndim) > 0, new_m, m)
        m.copy_(new_m)


def _sparse_leaf_update(p, g: RowSparseGrad, m, lr, cfg: SGDConfig, update_mask):
    """Scatter-only update for a RowSparseGrad leaf (see module docstring).

    Sentinel slots are clamped to a valid row by ``flat_rows`` and their
    scatter payload is selected to 0; every gathered per-row term is also
    weighted by the ``first_occurrence`` mask, which is 0 there.
    """
    R, n_rows, H = p.shape[0], g.n_rows, p.shape[-1]
    S = g.rows.shape[-1]
    flat, valid = flat_rows(g.rows, n_rows)
    valid = valid.view(R, S, 1)
    p2 = p.view(R * n_rows, H)
    lr = lr.expand(R) if lr.ndim == 0 else lr
    mk = (
        torch.ones(R, dtype=torch.float32, device=p.device)
        if update_mask is None else update_mask
    ).view(R, 1, 1)
    vals = g.vals.float()
    first = None
    if cfg.weight_decay or m is not None:
        first = first_occurrence(g.rows, n_rows)[..., None]
    if cfg.weight_decay:  # lazy decay: touched rows, exactly once per row
        vals = vals + cfg.weight_decay * first * p2[flat].view(R, S, H).float()
    if m is not None:
        m32 = m.float().view(R * n_rows, H)  # m itself when m is f32
        upd = mk * ((cfg.momentum - 1.0) * first * m32[flat].view(R, S, H) + vals)
        m32.index_add_(0, flat, torch.where(valid, upd, 0.0).view(R * S, H))
        m_rows = m32[flat].view(R, S, H)  # touched rows after the update
        if cfg.nesterov:  # every slot's own gradient, plus mu*m' once per row
            slot_delta = vals + cfg.momentum * first * m_rows
        else:             # once per row
            slot_delta = first * m_rows
        if m32.data_ptr() != m.data_ptr():
            m.copy_(m32.view(m.shape))
    else:
        slot_delta = vals
    step = -(lr.reshape(R, 1, 1) * mk) * slot_delta
    p2.index_add_(0, flat, torch.where(valid, step, 0.0).view(R * S, H).to(p.dtype))


def sgd_update(
    params: dict,
    grads: dict,
    lr,
    cfg: SGDConfig = SGDConfig(),
    momentum_state: Optional[dict] = None,
    update_mask=None,
):
    """One SGD step over replica-stacked leaves, in place.

    ``lr`` — scalar or (R,). ``update_mask`` — optional (R,) 0/1 vector:
    replicas whose virtual clock has passed the mega-batch horizon keep
    their parameters unchanged. ``grads`` leaves may be RowSparseGrad;
    with ``cfg.grad_clip`` > 0 they are densified and clipped per replica
    first. Parameter and momentum leaves must be contiguous. Returns
    ``(params, momentum_state)``, the same objects, updated.
    """
    if cfg.grad_clip > 0.0:
        grads = densify_tree(grads)  # the clip norm needs the reduced gradient
        grads = clip_by_global_norm(grads, cfg.grad_clip, replica_dim=True)
    any_leaf = next(iter(params.values()))
    lr = torch.as_tensor(lr, dtype=torch.float32, device=any_leaf.device)
    if update_mask is not None:
        update_mask = torch.as_tensor(update_mask, dtype=torch.float32, device=any_leaf.device)
    for k, p in params.items():
        g = grads[k]
        m = momentum_state[k] if momentum_state is not None else None
        if isinstance(g, RowSparseGrad):
            _sparse_leaf_update(p, g, m, lr, cfg, update_mask)
        else:
            _dense_leaf_update(p, g, m, lr, cfg, update_mask)
    return params, momentum_state

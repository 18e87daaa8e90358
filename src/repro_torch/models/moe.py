"""Mixture-of-Experts FFN: top-k router + sort-based dispatch + grouped FFN.

Port of ``repro/models/moe.py``. Tokens are sorted by expert id and
scattered into an (E, C, D) capacity buffer; the experts' SwiGLU runs as
one grouped product over it (``use_gmm_kernel`` routes it to the CUDA
kernel, ``kernels/moe_gmm``), and the outputs are combined back per token
with the router weights.

Every scatter of the reference is written here so that it gives the same
result on the card as on the CPU, in a fixed order:
  * dispatch: when an expert receives more than ``capacity`` assignments,
    the reference clamps every overflow entry to slot ``capacity - 1`` with
    a zeroed row, and its scatter lets the last write win, so that slot
    ends up zero: the kept assignment there is dropped too. The port writes
    the kept rows (distinct slots) and then zeroes slot ``capacity - 1`` of
    every expert that overflowed, which gives the same buffer.
  * combine: the reference scatter-adds each token's ``top_k``
    contributions in sorted order (ascending expert id); the port gathers
    them into that order and adds them one by one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gmm.ops import moe_ffn_gmm

from .layers import ninit, rmsnorm


def init_moe(
    generator,
    d_model: int,
    d_ff: int,
    n_experts: int,
    dtype,
    dense_residual_ff: int = 0,
):
    p = {
        "router": ninit(generator, (d_model, n_experts), d_model ** -0.5, torch.float32),
        "wi": ninit(generator, (n_experts, d_model, d_ff), d_model ** -0.5, dtype),
        "wg": ninit(generator, (n_experts, d_model, d_ff), d_model ** -0.5, dtype),
        "wo": ninit(generator, (n_experts, d_ff, d_model), d_ff ** -0.5, dtype),
        "norm": torch.zeros((d_model,), dtype=dtype, device=generator.device),
    }
    if dense_residual_ff:
        p["dense"] = {
            "wi": ninit(generator, (d_model, dense_residual_ff), d_model ** -0.5, dtype),
            "wg": ninit(generator, (d_model, dense_residual_ff), d_model ** -0.5, dtype),
            "wo": ninit(generator, (dense_residual_ff, d_model), dense_residual_ff ** -0.5, dtype),
        }
    return p


def _dispatch_indices(expert_ids: torch.Tensor, n_experts: int, capacity: int):
    """Sort-based slot assignment.

    expert_ids: (Tk,) int. Returns (sort_idx, slots, keep) where
    ``slots[j]`` is the destination row in the (E*C) buffer for the j-th
    sorted assignment and ``keep`` masks capacity overflow.
    """
    tk = expert_ids.shape[0]
    sort_idx = torch.argsort(expert_ids, stable=True)
    sorted_eids = expert_ids[sort_idx]
    counts = torch.bincount(expert_ids, minlength=n_experts)
    starts = counts.cumsum(0) - counts  # first sorted position of each expert
    pos_in_expert = torch.arange(tk, device=expert_ids.device) - starts[sorted_eids]
    keep = pos_in_expert < capacity
    slots = sorted_eids * capacity + pos_in_expert.clamp_max(capacity - 1)
    return sort_idx, slots, keep


def _dispatch_group(h_g: torch.Tensor, ids_g: torch.Tensor, n_experts: int, capacity: int):
    """One token group: sort-based dispatch of h_g (Tg, D) by ids_g (Tg, k)
    into an (E, C, D) buffer. Returns (buf, (sort_idx, slots, keep))."""
    top_k, d = ids_g.shape[-1], h_g.shape[-1]
    sort_idx, slots, keep = _dispatch_indices(ids_g.reshape(-1), n_experts, capacity)
    token_of = sort_idx // top_k
    buf = torch.zeros((n_experts * capacity, d), dtype=h_g.dtype, device=h_g.device)
    buf[slots[keep]] = h_g[token_of[keep]]
    buf[slots[~keep]] = 0  # overflow clears slot capacity-1 (see module doc)
    return buf.view(n_experts, capacity, d), (sort_idx, slots, keep)


def _combine_group(out_buf_g: torch.Tensor, meta, ids_g: torch.Tensor, w_g: torch.Tensor,
                   acc_dt: torch.dtype) -> torch.Tensor:
    """Each token's top_k expert outputs times its router weights, summed in
    ``acc_dt`` in ascending expert order. Returns (Tg, D)."""
    sort_idx, slots, keep = meta
    tg, top_k = ids_g.shape
    d = out_buf_g.shape[-1]
    out_rows = out_buf_g.reshape(-1, d)[slots]
    w_sorted = w_g.reshape(-1)[sort_idx].float()
    contrib = out_rows.to(acc_dt) * (w_sorted * keep)[:, None].to(acc_dt)
    # back to (token, k), then into ascending expert order within each token
    per_token = torch.empty_like(contrib)
    per_token[sort_idx] = contrib
    order = torch.argsort(ids_g, dim=-1)
    per_token = per_token.view(tg, top_k, d).gather(1, order[..., None].expand(-1, -1, d))
    y = torch.zeros((tg, d), dtype=acc_dt, device=out_buf_g.device)
    for j in range(top_k):
        y = y + per_token[:, j]
    return y


def _expert_ffn(params: dict, buf: torch.Tensor, use_gmm_kernel: bool) -> torch.Tensor:
    """Grouped SwiGLU over (E, C, D) capacity buffers."""
    if use_gmm_kernel:
        return moe_ffn_gmm(buf, params["wi"], params["wg"], params["wo"])
    g = F.silu(torch.bmm(buf, params["wg"]))
    u = torch.bmm(buf, params["wi"])
    return torch.bmm(g * u, params["wo"])


def _route(params: dict, h: torch.Tensor, top_k: int):
    """Router: (probs (T,E), top_w (T,k) renormalized, top_ids (T,k))."""
    probs = torch.softmax(h.float() @ params["router"], dim=-1)
    top_w, top_ids = torch.topk(probs, top_k, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, top_w, top_ids


def moe_ffn(
    params: dict,
    x: torch.Tensor,
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    use_gmm_kernel: bool = False,
    dispatch: str = "global",
    force_groups: int = 0,
    combine_dtype: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN body (pre-norm residual added by caller).

    x: (B, S, D) normed input. Returns (out (B,S,D), aux_loss scalar).

    dispatch:
      * ``global``  — one sort/gather/scatter over all T*k assignments.
      * ``sharded`` — dispatch computed per token group, over an explicit
        group dim. The group count is the mesh's expert-axis extent in the
        reference, which is 1 on one card, so this is the ``global`` path
        unless ``force_groups`` asks for more groups.
    """
    b, s, d = x.shape
    e = params["router"].shape[1]
    t = b * s
    h = x.reshape(t, d)
    probs, top_w, top_ids = _route(params, h, top_k)

    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    pe = probs.mean(dim=0)
    fe = torch.bincount(top_ids.reshape(-1), minlength=e).float() / (t * top_k)
    aux = e * (pe * fe).sum()

    groups = 1
    if dispatch == "sharded":
        groups = force_groups if force_groups else 1
        if t % groups or b % groups:
            groups = 1  # fall back (e.g. tiny smoke shapes)

    capacity = int(max(top_k, round(t // groups * top_k * capacity_factor / e)))
    acc_dt = torch.float32 if combine_dtype == "f32" else torch.bfloat16

    if groups == 1:
        buf, meta = _dispatch_group(h, top_ids, e, capacity)
        out_buf = _expert_ffn(params, buf, use_gmm_kernel)
        y = _combine_group(out_buf, meta, top_ids, top_w, acc_dt)
    else:
        tg = t // groups
        h_g = h.reshape(groups, tg, d)
        ids_g = top_ids.reshape(groups, tg, top_k)
        w_g = top_w.reshape(groups, tg, top_k)
        parts = [_dispatch_group(h_g[g], ids_g[g], e, capacity) for g in range(groups)]
        buf_g = torch.stack([buf for buf, _ in parts])                  # (G,E,C,D)
        # (G, E, C, D) -> (E, G*C, D)
        buf = buf_g.transpose(0, 1).reshape(e, groups * capacity, d)
        out_buf = _expert_ffn(params, buf, use_gmm_kernel)
        ob_g = out_buf.reshape(e, groups, capacity, d).transpose(0, 1)  # (G,E,C,D)
        y = torch.cat([_combine_group(ob_g[g], parts[g][1], ids_g[g], w_g[g], acc_dt)
                       for g in range(groups)])
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_ffn_gather(
    params: dict,
    x: torch.Tensor,
    *,
    top_k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode-time MoE FFN: gather the k routed experts' weights per token
    and compute densely (weight reads T*k*(3*D*F) instead of E*(3*D*F);
    only sensible when T*k < E)."""
    b, s, d = x.shape
    h = x.reshape(b * s, d)
    _, top_w, top_ids = _route(params, h, top_k)
    wi = params["wi"][top_ids]  # (T, k, D, F) — gathers only routed experts
    wg = params["wg"][top_ids]
    wo = params["wo"][top_ids]  # (T, k, F, D)
    g = F.silu(torch.einsum("td,tkdf->tkf", h, wg))
    u = torch.einsum("td,tkdf->tkf", h, wi)
    y = torch.einsum("tkf,tkfd,tk->td", g * u, wo, top_w.to(wo.dtype))
    return y.reshape(b, s, d).to(x.dtype), torch.zeros((), device=x.device)


def moe_layer(
    params: dict,
    x: torch.Tensor,
    *,
    top_k: int,
    norm_eps: float = 1e-5,
    capacity_factor: float = 1.25,
    use_gmm_kernel: bool = False,
    dispatch: str = "global",
    combine_dtype: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm MoE block: x + moe(norm(x)) [+ dense residual branch (arctic)]."""
    h = rmsnorm(x, params["norm"], norm_eps)
    if dispatch == "gather":
        out, aux = moe_ffn_gather(params, h, top_k=top_k)
    else:
        out, aux = moe_ffn(
            params, h, top_k=top_k, capacity_factor=capacity_factor,
            use_gmm_kernel=use_gmm_kernel, dispatch=dispatch,
            combine_dtype=combine_dtype,
        )
    if "dense" in params:
        dp = params["dense"]
        g = F.silu(h @ dp["wg"])
        u = h @ dp["wi"]
        out = out + (g * u) @ dp["wo"]
    return x + out, aux

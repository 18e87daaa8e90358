"""Mixture-of-Experts FFN: top-k router + sort-based dispatch + grouped FFN;
and the dropless layer of the Moonlight config (sigmoid router, held
experts, shared experts; ``moe_layer_dropless``, port-only).

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

Every shape here is static (no ``bincount``, no boolean-mask indexing), so
the layer also traces under ``FakeTensorMode`` (the dry run): the counts
are ``index_add_`` of ones into a zero vector, and the overflow rows go to
a spare row of the buffer, which is dropped.

Partitioned (a ``DTensor`` input, under a sharding context): the routing,
the sort and the combine run on each rank's own tokens as plain tensors,
and only the (E, C, D) buffers are DTensors, experts sharded over the
logical ``experts`` axis. With ``dispatch="sharded"`` the group count is
the expert axis's extent (``logical_axis_size``), as in the reference;
where the tokens are sharded over that same axis, each rank's tokens are
one group, dispatched locally, and the (G, E) -> (E, G) reshard of the
buffer is the expert-parallel all-to-all. Otherwise every rank gathers all
tokens and dispatches them alike.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gmm.ops import moe_ffn_gmm
from repro_torch.sharding.annotate import (
    constrain,
    gathered,
    is_dtensor,
    logical_axis_size,
    placements_for,
    shard,
)

from repro_torch.utils import trace

from .layers import ninit, residual, rmsnorm


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


def _counts(ids: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """How often each of 0..n-1 occurs in ``ids``, in ``dtype``: a static-
    shape ``bincount`` (sums of ones, so the same values)."""
    return torch.zeros((n,), dtype=dtype, device=ids.device).index_add_(
        0, ids, torch.ones(ids.shape, dtype=dtype, device=ids.device))


def _dispatch_indices(expert_ids: torch.Tensor, n_experts: int, capacity: int):
    """Sort-based slot assignment.

    expert_ids: (Tk,) int. Returns (sort_idx, slots, keep) where
    ``slots[j]`` is the destination row in the (E*C) buffer for the j-th
    sorted assignment and ``keep`` masks capacity overflow.
    """
    tk = expert_ids.shape[0]
    sort_idx = torch.argsort(expert_ids, stable=True)
    sorted_eids = expert_ids[sort_idx]
    counts = _counts(expert_ids, n_experts, expert_ids.dtype)
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
    n = n_experts * capacity
    # kept rows to their (distinct) slots, overflow rows to a spare row n
    buf = torch.zeros((n + 1, d), dtype=h_g.dtype, device=h_g.device)
    buf.index_copy_(0, torch.where(keep, slots, n), h_g[token_of])
    # overflow clears slot capacity-1 (see module doc)
    over = torch.zeros((n + 1,), dtype=torch.bool, device=h_g.device)
    over.index_fill_(0, torch.where(keep, n, slots), True)
    buf = torch.where(over[:n, None], 0, buf[:n])
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
    wi, wg, wo = (gathered(params["wi"], 0, 2), gathered(params["wg"], 0, 2),
                  gathered(params["wo"], 0, 1))
    if is_dtensor(buf):
        # the buffer takes the weights' layout: experts split where the
        # weights split them, whole where the weights split their hidden
        # dim, so every product has one layout (DTensor would otherwise
        # weigh moving the buffer against moving the weights, and switch
        # with the capacity)
        from torch.distributed.tensor import Replicate, Shard

        buf = constrain(buf, [Shard(0) if p.is_shard() and p.dim == 0 else Replicate()
                              for p in wi.placements])
    g = F.silu(torch.bmm(buf, wg))
    u = torch.bmm(buf, wi)
    return torch.bmm(g * u, wo)


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
    groups = 1
    if dispatch == "sharded":
        groups = force_groups if force_groups else logical_axis_size("experts")
        if t % groups or b % groups:
            groups = 1  # fall back (e.g. tiny smoke shapes)

    capacity = int(max(top_k, round(t // groups * top_k * capacity_factor / e)))
    acc_dt = torch.float32 if combine_dtype == "f32" else torch.bfloat16
    if is_dtensor(x):
        return _moe_ffn_partitioned(params, x, top_k=top_k, groups=groups, capacity=capacity,
                                    acc_dt=acc_dt, use_gmm_kernel=use_gmm_kernel)

    h = x.reshape(t, d)
    probs, top_w, top_ids = _route(params, h, top_k)

    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    pe = probs.mean(dim=0)
    fe = _counts(top_ids.reshape(-1), e, torch.float32) / (t * top_k)
    aux = e * (pe * fe).sum()
    y = _dispatch_ffn_combine(params, h, top_ids, top_w, groups, capacity, acc_dt,
                              use_gmm_kernel)
    return y.reshape(b, s, d).to(x.dtype), aux


def _dispatch_ffn_combine(params: dict, h: torch.Tensor, top_ids: torch.Tensor,
                          top_w: torch.Tensor, groups: int, capacity: int,
                          acc_dt: torch.dtype, use_gmm_kernel: bool,
                          wrap=None) -> torch.Tensor:
    """Dispatch the tokens h (T, D) in ``groups`` groups, run the experts,
    combine: (T, D) in ``acc_dt``. ``wrap`` (the partitioned path) turns
    the whole (E, G*C, D) buffer into a DTensor before the experts and
    returns the experts' output as a plain tensor again."""
    t, d = h.shape
    e = params["router"].shape[1]
    top_k = top_ids.shape[-1]

    def ffn(buf):
        if wrap is None:
            return _expert_ffn(params, buf, use_gmm_kernel)
        return wrap(buf)

    if groups == 1:
        buf, meta = _dispatch_group(h, top_ids, e, capacity)
        out_buf = ffn(buf)
        return _combine_group(out_buf, meta, top_ids, top_w, acc_dt)
    else:
        tg = t // groups
        h_g = h.reshape(groups, tg, d)
        ids_g = top_ids.reshape(groups, tg, top_k)
        w_g = top_w.reshape(groups, tg, top_k)
        parts = [_dispatch_group(h_g[g], ids_g[g], e, capacity) for g in range(groups)]
        buf_g = torch.stack([buf for buf, _ in parts])                  # (G,E,C,D)
        # (G, E, C, D) -> (E, G*C, D)
        buf = buf_g.transpose(0, 1).reshape(e, groups * capacity, d)
        out_buf = ffn(buf)
        ob_g = out_buf.reshape(e, groups, capacity, d).transpose(0, 1)  # (G,E,C,D)
        return torch.cat([_combine_group(ob_g[g], parts[g][1], ids_g[g], w_g[g], acc_dt)
                          for g in range(groups)])


def _moe_ffn_partitioned(params: dict, x, *, top_k: int, groups: int, capacity: int,
                         acc_dt: torch.dtype, use_gmm_kernel: bool):
    """``moe_ffn`` on a DTensor x (B, S, D) (module doc): routing, sort and
    combine on this rank's tokens, the experts over DTensor buffers."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if use_gmm_kernel:
        raise NotImplementedError("the partitioned MoE runs the experts as DTensor products; "
                                  "use_gmm_kernel is for one device")
    mesh = x.device_mesh
    b, s, d = x.shape
    e = params["router"].shape[1]
    t = b * s
    batch_pl = placements_for(mesh, "batch", None, None, shape=x.shape)
    bdims = [i for i, p in enumerate(batch_pl) if isinstance(p, Shard)]
    edims = [i for i, p in enumerate(placements_for(mesh, "experts", None, None,
                                                    shape=(e, 1, 1)))
             if isinstance(p, Shard)]
    n_shards = 1
    for i in bdims:
        n_shards *= mesh.size(i)
    local_groups = groups > 1 and groups == n_shards and bdims == edims
    if not local_groups:  # every rank dispatches all tokens
        batch_pl, bdims = [Replicate()] * mesh.ndim, []
    x_pl = x.redistribute(mesh, batch_pl)
    h = x_pl.to_local().reshape(-1, d)
    router = params["router"]
    if is_dtensor(router):
        router = router.full_tensor()
    probs, top_w, top_ids = _route({"router": router}, h, top_k)
    fe_cnt = _counts(top_ids.reshape(-1), e, torch.float32)
    if bdims:  # the token means, completed over the batch shards
        partial = [Partial() if i in bdims else Replicate() for i in range(mesh.ndim)]
        pe = DTensor.from_local(probs.sum(dim=0), mesh, partial, run_check=False).full_tensor() / t
        fe = DTensor.from_local(fe_cnt, mesh, partial, run_check=False).full_tensor()
    else:
        pe, fe = probs.mean(dim=0), fe_cnt
    # a DTensor, so that the loss's gradient reaches it as one
    aux = DTensor.from_local(e * (pe * fe / (t * top_k)).sum(), mesh,
                             [Replicate()] * mesh.ndim, run_check=False)

    def experts(buf):
        return shard(_expert_ffn(params, buf, False), "experts", None, None)

    if local_groups:
        buf, meta = _dispatch_group(h, top_ids, e, capacity)            # this rank's group
        g_pl = [Shard(0) if i in bdims else Replicate() for i in range(mesh.ndim)]
        buf_g = DTensor.from_local(buf[None], mesh, g_pl, run_check=False)  # (G,E,C,D)
        buf_g = shard(buf_g, "experts", None, None, None)   # G-dim local to shard
        # (G, E, C, D) -> (E, G*C, D): the expert-parallel all-to-all
        buf_e = shard(buf_g.transpose(0, 1), "experts", None, None, None)
        out = experts(buf_e.reshape(e, groups * capacity, d))
        # back: (E, G*C, D) -> (G, E, C, D), the reverse all-to-all
        ob_g = out.reshape(e, groups, capacity, d).transpose(0, 1).redistribute(mesh, g_pl)
        y = _combine_group(ob_g.to_local()[0], meta, top_ids, top_w, acc_dt)
    else:
        def wrap(buf):
            buf = DTensor.from_local(buf, mesh, [Replicate()] * mesh.ndim, run_check=False)
            return experts(buf).full_tensor()

        y = _dispatch_ffn_combine(params, h, top_ids, top_w, groups, capacity, acc_dt,
                                  False, wrap=wrap)
    y = DTensor.from_local(y.reshape(-1, s, d).to(x.dtype), mesh, batch_pl, run_check=False)
    return y, aux


def moe_ffn_gather(
    params: dict,
    x: torch.Tensor,
    *,
    top_k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode-time MoE FFN: gather the k routed experts' weights per token
    and compute densely (weight reads T*k*(3*D*F) instead of E*(3*D*F);
    only sensible when T*k < E). On a DTensor (a perf experiment's flag on
    the partitioned path) every rank first gathers the tokens and every
    expert's weights whole."""
    if is_dtensor(x):  # every rank gathers the tokens and the experts' weights whole
        from torch.distributed.tensor import DTensor, Replicate

        full = {k: params[k].full_tensor() if is_dtensor(params[k]) else params[k]
                for k in ("router", "wi", "wg", "wo")}
        y, aux = moe_ffn_gather(full, x.full_tensor(), top_k=top_k)
        return (DTensor.from_local(y, x.device_mesh, [Replicate()] * x.device_mesh.ndim,
                                   run_check=False), aux)
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
        g = F.silu(h @ gathered(dp["wg"], 1))
        u = h @ gathered(dp["wi"], 1)
        out = out + (g * u) @ gathered(dp["wo"], 0)
    return x + residual(out), aux


# --------------------------------------------------------------------------
# dropless MoE with a sigmoid router and shared experts (DeepSeek-V3 /
# Moonlight; port-only: the reference has none)
# --------------------------------------------------------------------------


def init_moe_dropless(generator, d_model: int, d_ff: int, n_experts: int, n_held: int,
                      n_shared: int, dtype):
    """The router over all ``n_experts`` (f32), the ``n_held`` routed
    experts this card holds (``wi``/``wg`` (Eh, D, F), ``wo`` (Eh, F, D)),
    the shared experts as one SwiGLU of ``n_shared * d_ff`` (``shared``) and
    the pre-norm gain. The selection bias is no leaf here: it is a fixed
    buffer (``models.model.init_buffers``), ``score_bias`` at apply time."""
    fs = n_shared * d_ff
    p = {
        "router": ninit(generator, (d_model, n_experts), d_model ** -0.5, torch.float32),
        "wi": ninit(generator, (n_held, d_model, d_ff), d_model ** -0.5, dtype),
        "wg": ninit(generator, (n_held, d_model, d_ff), d_model ** -0.5, dtype),
        "wo": ninit(generator, (n_held, d_ff, d_model), d_ff ** -0.5, dtype),
        "norm": torch.zeros((d_model,), dtype=dtype, device=generator.device),
    }
    if n_shared:
        p["shared"] = {
            "wi": ninit(generator, (d_model, fs), d_model ** -0.5, dtype),
            "wg": ninit(generator, (d_model, fs), d_model ** -0.5, dtype),
            "wo": ninit(generator, (fs, d_model), fs ** -0.5, dtype),
        }
    return p


def route_sigmoid(router: torch.Tensor, score_bias: torch.Tensor, h: torch.Tensor, top_k: int,
                  scale: float, norm_topk_prob: bool = True):
    """HF deepseek_v3's ``noaux_tc`` gate with one group, in f32: s =
    sigmoid(h W_r) over every expert; the top k of s + b (``score_bias``
    enters the selection only); weights s of the selected, over their sum
    (+1e-20) where ``norm_topk_prob``, times ``scale``. Returns (weights,
    ids), each (T, k)."""
    s = torch.sigmoid(h.float() @ router.float())
    _, ids = torch.topk(s + score_bias.float(), top_k, dim=-1)
    w = s.gather(-1, ids)
    if norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * scale, ids


def _load_summary(counts) -> dict:
    """The counters of the held experts' assignment counts (``trace.tally``)."""
    return {"assigned": int(counts.sum()), "load_max": int(counts.max()),
            "load_mean": float(counts.mean())}


def grouped_swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
                   counts: torch.Tensor, sizes: list) -> torch.Tensor:
    """The held experts' SwiGLU over rows grouped by expert: x (n, D) holds
    ``sizes[e]`` rows of expert e in turn (``counts`` the same on the
    device). bf16 on the card: three ``torch._grouped_mm`` over the groups'
    offsets (one launch each, with a backward); otherwise a product an
    expert."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        offs = counts.cumsum(0).to(torch.int32)
        g = torch._grouped_mm(x, wg, offs=offs)
        u = torch._grouped_mm(x, wi, offs=offs)
        return torch._grouped_mm(F.silu(g) * u, wo, offs=offs)
    outs = [(F.silu(xe @ wg[e]) * (xe @ wi[e])) @ wo[e]
            for e, xe in enumerate(x.split(sizes)) if sizes[e]]
    return torch.cat(outs) if outs else x.new_zeros((0, wo.shape[-1]))


_PINNED: dict = {}   # (device, thread) -> a pinned host buffer for the held counts


def sort_held(ids: torch.Tensor, first: int, n_held: int,
              valid: Optional[torch.Tensor] = None):
    """The (token, slot) assignments of ``ids`` (T, k) to the held experts
    ``[first, first + n_held)``, of the tokens ``valid`` (T,) keeps,
    sorted by expert (stably, so by token within one), the rest after
    them: (order (T k,), counts (n_held,) on the device, ``sizes``).
    ``sizes()`` waits for the counts' copy to the host, which is issued
    here, so the caller can queue work that does not need them (the
    shared experts) before it waits. In a training forward
    (not a checkpoint's recompute) the counts are also tallied on the
    device (``trace.tally("moe.load")``)."""
    local = ids - first
    held = (local >= 0) & (local < n_held)
    if valid is not None:
        held = held & valid[:, None]
    key = torch.where(held, local, n_held).reshape(-1)
    order = torch.argsort(key, stable=True)
    counts = _counts(key, n_held + 1, torch.int64)[:n_held]
    if torch.is_grad_enabled() and torch._C._current_graph_task_id() == -1:
        trace.tally("moe.load", counts, _load_summary)
    if not counts.is_cuda:
        return order, counts, counts.tolist
    slot = (counts.device, threading.get_ident())
    host = _PINNED.get(slot)
    if host is None or host.numel() != n_held:
        host = _PINNED[slot] = torch.empty(n_held, dtype=torch.int64, pin_memory=True)
    host.copy_(counts, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def sizes() -> list:
        done.synchronize()
        return host.tolist()

    return order, counts, sizes


def held_experts(params: dict, h: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                 held: tuple) -> torch.Tensor:
    """Dropless: sum_{held selected i} w_i SwiGLU_i(h) for every token, in
    f32 (T, D). The assignments to the held experts, sorted
    (``held``: ``sort_held``'s result), are gathered, run through
    ``grouped_swiglu``, weighted, put back at their (token, slot) and
    summed over the slots in slot order: the same result on every device.
    Their sizes, which shape the products, are the one host sync a call."""
    t, k = ids.shape
    order, counts, sizes = held
    sizes = sizes()
    rows = order[:sum(sizes)]
    tok = torch.div(rows, k, rounding_mode="floor")
    y = grouped_swiglu(h[tok], params["wi"], params["wg"], params["wo"], counts, sizes)
    contrib = y * w.reshape(-1)[rows][:, None].float()          # f32
    out = torch.zeros((t * k, h.shape[-1]), dtype=torch.float32, device=h.device)
    out.index_copy_(0, rows, contrib)
    return out.view(t, k, -1).sum(dim=1)


def shared_swiglu(p: dict, h: torch.Tensor) -> torch.Tensor:
    return (F.silu(h @ p["wg"]) * (h @ p["wi"])) @ p["wo"]


def moe_layer_dropless(params: dict, x: torch.Tensor, *, top_k: int, first_expert: int,
                       scale: float, norm_topk_prob: bool = True, norm_eps: float = 1e-5,
                       rows_valid: Optional[torch.Tensor] = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm dropless MoE block: x + sum_{held selected i} w_i
    SwiGLU_i(h) + SwiGLU_shared(h), h = norm(x); the router (``moe.route``)
    and the held experts (``moe.experts``) in f32, the shared experts
    (``moe.shared``) in the model's dtype, queued while the held experts'
    sizes travel to the host; their sum in f32, cast once.
    ``rows_valid`` (B,): the batch rows that hold a sample; the others (a
    masked lockstep slot's padding, whose loss is masked) reach no routed
    expert. Returns (x', 0): no auxiliary loss (HF's deepseek_v3 computes
    none)."""
    b, s, d = x.shape
    h = rmsnorm(x, params["norm"], norm_eps).reshape(b * s, d)
    with trace.span("moe.route"):
        w, ids = route_sigmoid(params["router"], params["score_bias"], h, top_k, scale,
                               norm_topk_prob)
        valid = None if rows_valid is None else rows_valid.repeat_interleave(s)
        held = sort_held(ids, first_expert, params["wi"].shape[0], valid)
    shared = None
    if "shared" in params:    # queued before the held experts wait for their sizes
        with trace.span("moe.shared"):
            shared = shared_swiglu(params["shared"], h)
    with trace.span("moe.experts"):
        y = held_experts(params, h, w, ids, held)
    if shared is not None:
        y = y + shared.float()
    return x + y.view(b, s, d).to(x.dtype), torch.zeros((), device=x.device)

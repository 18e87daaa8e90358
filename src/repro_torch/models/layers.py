"""Shared transformer layers: RMSNorm, RoPE, GQA attention (blockwise online
softmax, the flash kernel, one-token decode), latent attention (MLA), SwiGLU
MLP, embeddings, the LM head (``head_logits``: f32 logits, on bf16 tensor
cores where the inputs are bf16 on a card).

Port of ``repro/models/layers.py``. Every layer is a plain function over a
dict of tensors, with the reference's parameter names and layouts
(attention (B, S, H, hd)), so weights carried over from the reference
compare like with like. The reference's ``shard(...)`` annotations sit at
its call sites (``sharding.annotate``): the identity on plain tensors, a
redistribution of a DTensor under a sharding context.

Attention paths (both grouped-query native: repeated KV heads are never
materialized; q is reshaped to (B, S, Hkv, rep, hd) against the raw KV):
  * ``blockwise_attention`` — chunked online softmax in plain PyTorch, the
    model's own path for prefill; ``use_flash`` swaps in the CUDA kernel
    (``kernels/flash_attention``) where no key mask is given.
  * ``decode_attention``    — one-token query against a KV cache, updated
    in place, or against an encoder memory's K/V (``cross=True``).

Cross-attention (the encoder-decoder family) always takes the blockwise
path: the reference's cross call passes no ``use_flash``.

Latent attention (``mla_layer``, the Moonlight config's mixer; the reference
has none) trains through ``scaled_dot_product_attention`` (``mla_attention``):
its q/k heads (192) are wider than its v heads (128), which the flash kernel
and ``blockwise_attention``'s one head dim do not take, and at 4,096 tokens
the blockwise path's saved chunk scores would not fit.

Partitioned (DTensor inputs under a sharding context): the attention math
runs on each rank's own batch rows and query heads as plain tensors
(``_local_attention``), the heads sharded over the logical ``heads`` axis;
the KV heads follow the query heads' grouping where they split evenly over
that axis, and each rank takes the KV heads its query heads read where they
do not (the replicated-KV groups of Megatron's GQA). The projections around
it stay DTensor products.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.sharding.annotate import (
    constrain,
    gathered,
    is_dtensor,
    pin,
    placements_for,
    shard,
)
from repro_torch.utils import trace

# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------


def ninit(generator: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """Normal(0, scale) in f32 on the generator's device, cast to ``dtype``."""
    return (torch.randn(shape, generator=generator, device=generator.device) * scale).to(dtype)


# --------------------------------------------------------------------------
# norms / rope
# --------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + gain.float())).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: (..., S) or (S,)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) x (D, H, hd) -> (B, S, H, hd), contiguous. A DTensor
    product is laid out by whole heads first (sharded over the ``heads``
    axis where H divides evenly, else whole), so the view splits no head."""
    d, n, hd = w.shape
    y = h @ pin(gathered(w, 1).reshape(d, n * hd))
    if is_dtensor(y):
        y = constrain(y, placements_for(y.device_mesh, "batch", None, "heads",
                                        shape=(*y.shape[:-1], n)), grad_as_output=True)
    return y.view(*h.shape[:-1], n, hd)


def memory_kv(params: dict, memory: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A cross-attention block's keys and values over an encoder memory
    (B, Senc, D), taken from the raw memory (no norm, no RoPE)."""
    return _heads(memory, params["wk"]), _heads(memory, params["wv"])


def _merge_heads(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) x (H, hd, D) -> (B, S, D)."""
    n, hd, d = w.shape
    return pin(o.reshape(*o.shape[:-2], n * hd)) @ pin(gathered(w, 0).reshape(n * hd, d))


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def init_attention(generator, d_model: int, n_heads: int, n_kv: int, head_dim: int, dtype):
    s = d_model ** -0.5
    return {
        "wq": ninit(generator, (d_model, n_heads, head_dim), s, dtype),
        "wk": ninit(generator, (d_model, n_kv, head_dim), s, dtype),
        "wv": ninit(generator, (d_model, n_kv, head_dim), s, dtype),
        "wo": ninit(generator, (n_heads, head_dim, d_model), (n_heads * head_dim) ** -0.5, dtype),
        "norm": torch.zeros((d_model,), dtype=dtype, device=generator.device),
    }


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 512,
    kv_chunk: int = 512,
    kv_seq_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Online-softmax chunked attention, grouped-query native.

    q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd) with Hq % Hkv == 0.
    window > 0 = sliding-window causal attention (token i attends to
    [i-window+1, i]); ``kv_seq_mask`` (B, Skv) masks keys. Returns
    (B, Sq, Hq, hd) in q's dtype; the math is f32.
    """
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    if sq % q_chunk:
        q_chunk = sq
    if skv % kv_chunk:
        kv_chunk = skv
    nq, nkv = sq // q_chunk, skv // kv_chunk
    scale = hd ** -0.5
    dev = q.device

    # (nq, B, Hkv, rep, qc, hd) and (nkv, B, Hkv, kvc, hd)
    qc = q.reshape(b, nq, q_chunk, hkv, rep, hd).permute(1, 0, 3, 4, 2, 5)
    kc = k.reshape(b, nkv, kv_chunk, hkv, hd).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, nkv, kv_chunk, hkv, hd).permute(1, 0, 3, 2, 4)
    if kv_seq_mask is not None:
        mc = kv_seq_mask.reshape(b, nkv, kv_chunk).permute(1, 0, 2)   # (nkv, B, kvc)
    else:
        mc = torch.ones((nkv, b, kv_chunk), dtype=torch.bool, device=dev)
    q_pos = torch.arange(sq, device=dev).reshape(nq, q_chunk)
    kv_pos = torch.arange(skv, device=dev).reshape(nkv, kv_chunk)

    outs = []
    for i in range(nq):
        q_i, qp = qc[i].float(), q_pos[i]
        acc = torch.zeros((b, hkv, rep, q_chunk, hd), dtype=torch.float32, device=dev)
        m = torch.full((b, hkv, rep, q_chunk), float("-inf"), device=dev)
        l = torch.zeros((b, hkv, rep, q_chunk), dtype=torch.float32, device=dev)
        for j in range(nkv):
            s = torch.einsum("bhrqd,bhkd->bhrqk", q_i, kc[j].float()) * scale
            allow = mc[j][:, None, None, None, :]                       # (B,1,1,1,kvc)
            rel = qp[:, None] - kv_pos[j][None, :]                      # (qc, kvc)
            if causal:
                allow = allow & (rel >= 0)
            if window > 0:
                allow = allow & (rel < window)
            s = torch.where(allow, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)        # fully masked rows
            p = torch.where(allow, torch.exp(s - m_safe[..., None]), 0.0)
            corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhrqk,bhkd->bhrqd", p, vc[j].float())
            m = m_new
        outs.append(acc / l[..., None].clamp_min(1e-30))
    out = torch.stack(outs)                                             # (nq,B,Hkv,rep,qc,hd)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, hq, hd).to(q.dtype)


def residual(out):
    """A sublayer's output as the residual stream holds it: the identity on
    plain tensors; under a context, a DTensor made whole on its feature
    dim (the all-reduce after a row-parallel product) and sharded on its
    batch dim by the rules. The reference anchors the stream once, on the
    embedded input, and GSPMD carries that layout through; DTensor picks
    each op's layout alone, and without this anchor would shard the stream
    on its feature dim and gather weights instead."""
    return shard(out, "replica", "batch", "seq", None)


def _local_attention(core, q, k, v, **kwargs):
    """``core(q, k, v, **kwargs)`` -> (B, Sq, Hq, hd); on DTensors, on
    this rank's batch rows and query heads (module doc). ``kv_seq_mask``
    (B, Skv) follows the batch rows."""
    if not is_dtensor(q):
        return core(q, k, v, **kwargs)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = q.device_mesh
    hq, hkv = q.shape[2], k.shape[2]
    q_pl = placements_for(mesh, "batch", None, "heads", None, shape=q.shape)
    tp = [i for i, p in enumerate(q_pl) if p.is_shard() and p.dim == 2]
    n_tp = 1
    for i in tp:
        n_tp *= mesh.size(i)
    kv_split = hkv % n_tp == 0
    kv_pl = q_pl if kv_split else [Replicate() if i in tp else p for i, p in enumerate(q_pl)]
    q_l = q.redistribute(mesh, q_pl).to_local()
    k_l = k.redistribute(mesh, kv_pl).to_local()
    v_l = v.redistribute(mesh, kv_pl).to_local()
    if not kv_split:  # the KV heads this rank's query heads read
        r = 0
        for i in tp:
            r = r * mesh.size(i) + mesh.get_local_rank(i)
        chunk = -(-hq // n_tp)
        start, n_loc, rep = min(r * chunk, hq), q_l.shape[2], hq // hkv
        if n_loc and (n_loc % rep == 0 or rep % n_loc == 0):
            lo = start // rep
            k_l = k_l[:, :, lo:(start + n_loc - 1) // rep + 1]
            v_l = v_l[:, :, lo:(start + n_loc - 1) // rep + 1]
        else:
            idx = torch.arange(start, start + n_loc, device=k_l.device) // rep
            k_l, v_l = k_l.index_select(2, idx), v_l.index_select(2, idx)
    mask = kwargs.get("kv_seq_mask")
    if is_dtensor(mask):
        kwargs["kv_seq_mask"] = mask.redistribute(mesh, [
            p if p.is_shard() and p.dim == 0 else Replicate() for p in q_pl]).to_local()
    o = core(q_l, k_l, v_l, **kwargs).contiguous()
    return DTensor.from_local(o, mesh, q_pl, run_check=False, shape=q.shape,
                              stride=contiguous_stride(q.shape))


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def attention_layer(
    params: dict,
    x: torch.Tensor,
    *,
    n_rep: int,
    rope_theta: float,
    causal: bool = True,
    window: int = 0,
    positions: Optional[torch.Tensor] = None,
    kv_seq_mask: Optional[torch.Tensor] = None,
    norm_eps: float = 1e-5,
    q_chunk: int = 512,
    kv_chunk: int = 512,
    cross_kv: Optional[tuple] = None,
    use_flash: bool = False,
) -> torch.Tensor:
    """Pre-norm attention block: x + attn(norm(x)). x: (B, S, D).
    ``cross_kv`` (k, v), each (B, Senc, Hkv, hd), makes it cross-attention
    over an encoder memory: those are the keys and values, q takes no RoPE
    and nothing is causal."""
    s = x.shape[1]
    h = rmsnorm(x, params["norm"], norm_eps)
    q = _heads(h, params["wq"])
    if cross_kv is None:
        k = _heads(h, params["wk"])
        v = _heads(h, params["wv"])
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    else:
        k, v = cross_kv
        causal = False
    q = shard(q, "replica", "batch", "seq", "heads", None)
    if use_flash and kv_seq_mask is None:
        o = _local_attention(flash_attention, q, k, v, causal=causal, window=window)
    else:
        o = _local_attention(
            blockwise_attention, q, k, v, causal=causal, window=window,
            q_chunk=q_chunk, kv_chunk=kv_chunk, kv_seq_mask=kv_seq_mask,
        )
    return x + residual(_merge_heads(o, params["wo"]))


def decode_attention(
    params: dict,
    x: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    cur_len: int,
    *,
    n_rep: int,
    rope_theta: float,
    window: int = 0,
    norm_eps: float = 1e-5,
    cross: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, D); cache_k/v: (B, S, Hkv, hd).

    Grouped-query native: the cache is never head-repeated. The new token's
    K/V are written into ``cache_k``/``cache_v`` in place (the reference
    returns updated copies); returns (out, cache_k, cache_v). ``cur_len``
    is the number of valid cache entries before this token. With
    ``window`` > 0 the cache is a rolling buffer of size S = window.
    ``cross=True`` attends to an encoder memory's K/V: no write, no RoPE,
    every entry valid.
    """
    b = x.shape[0]
    s_cache, hkv = cache_k.shape[1], cache_k.shape[2]
    h = rmsnorm(x, params["norm"], norm_eps)
    q = _heads(h, params["wq"])                                          # (B,1,Hq,hd)
    if not cross:
        k = _heads(h, params["wk"])
        v = _heads(h, params["wv"])
        pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
        slot = cur_len % s_cache if window > 0 else cur_len
        slot = min(slot, s_cache - 1)  # dynamic_update_slice clamps its start
        cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    # the reference's annotation of its grouped query (B, Hkv, rep, hd):
    # batch-sharded, heads whole
    q = shard(q, "batch", None, None, None)
    n_valid = s_cache if cross else min(cur_len + 1, s_cache)
    o = _local_attention(_decode_core, q, cache_k, cache_v, n_valid=n_valid)
    return x + residual(_merge_heads(o.to(x.dtype), params["wo"])), cache_k, cache_v


def _decode_core(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                 n_valid: int) -> torch.Tensor:
    """One query position (B, 1, Hq, hd) against the first ``n_valid``
    entries of a (B, S, Hkv, hd) cache; returns (B, 1, Hq, hd) in q's
    dtype."""
    b, _, hq, hd = q.shape
    s_cache, hkv = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, hd)                                # Sq == 1 folded out
    # f32 accumulation without casting the cache's storage dtype: bf16
    # products are exact in f32, as with the reference's preferred_element_type
    s = torch.einsum("bhrk,bshk->bhrs", qg.float(), cache_k.float()) * hd ** -0.5
    if n_valid < s_cache:
        valid = torch.arange(s_cache, device=q.device) < n_valid
        s = torch.where(valid, s, float("-inf"))
    p = torch.softmax(s, dim=-1).to(cache_v.dtype)
    o = torch.einsum("bhrs,bshk->bhrk", p.float(), cache_v.float())
    return o.reshape(b, 1, hq, hd).to(q.dtype)


# --------------------------------------------------------------------------
# latent attention (MLA; port-only: the reference has none)
# --------------------------------------------------------------------------


def init_mla(generator, d_model: int, n_heads: int, kv_rank: int, nope: int, rope: int,
             v_dim: int, dtype):
    """DeepSeek-V3's latent attention without query compression: ``wq``
    (D, H, nope + rope), ``wkv_a`` (D, kv_rank + rope) into the latent and
    the one rotary key every head shares, ``kv_norm`` (kv_rank,) on the
    latent, ``wkv_b`` (kv_rank, H, nope + v) out of it, ``wo`` (H, v, D)."""
    s = d_model ** -0.5
    return {
        "wq": ninit(generator, (d_model, n_heads, nope + rope), s, dtype),
        "wkv_a": ninit(generator, (d_model, kv_rank + rope), s, dtype),
        "kv_norm": torch.zeros((kv_rank,), dtype=dtype, device=generator.device),
        "wkv_b": ninit(generator, (kv_rank, n_heads, nope + v_dim), kv_rank ** -0.5, dtype),
        "wo": ninit(generator, (n_heads, v_dim, d_model), (n_heads * v_dim) ** -0.5, dtype),
        "norm": torch.zeros((d_model,), dtype=dtype, device=generator.device),
    }


# HF deepseek_v3 builds kv_a_layernorm with its RMSNorm's default eps
MLA_KV_NORM_EPS = 1e-6


def apply_rope_pairs(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE in HF deepseek_v3's interleaved pair layout: the pairs (x[2i],
    x[2i+1]) rotate by position * theta^(-2i/d), and the result is laid out
    as [rotated evens, rotated odds] (HF's ``view(..., d // 2, 2)
    .transpose``). The layout is the same for q and k, so their products
    are those of an in-place rotation."""
    return apply_rope(torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1), positions, theta)


def mla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal attention with q/k heads wider than v's: q, k (B, S, H, dqk),
    v (B, S, H, dv) -> (B, S, H, dv). ``scaled_dot_product_attention``, its
    flash path in bf16 on the card (with a backward): v zero-padded to dqk
    and the output sliced back to dv, which is exact (the padded columns
    of p @ v are zeros)."""
    dqk, dv = q.shape[-1], v.shape[-1]
    if dv < dqk:
        v = F.pad(v, (0, dqk - dv))
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       is_causal=True, scale=scale)
    return o.transpose(1, 2)[..., :dv]


def mla_layer(params: dict, x: torch.Tensor, *, kv_rank: int, nope: int, rope: int,
              v_dim: int, rope_theta: float, norm_eps: float = 1e-5) -> torch.Tensor:
    """Pre-norm latent-attention block: x + W_o attn(norm(x)).

    q = W_q h per head as [q_nope, q_pe]; [c, k_pe] = W_kva h;
    c = RMSNorm(c); [k_nope, v] = W_kvb c per head; RoPE (``apply_rope_pairs``)
    on q_pe and on the one k_pe all heads share; k = [k_nope, k_pe];
    causal softmax at scale (nope + rope)^-0.5 (``mla_attention``)."""
    b, s, _ = x.shape
    h = rmsnorm(x, params["norm"], norm_eps)
    q = _heads(h, params["wq"])                                         # (B,S,H,nope+rope)
    n_heads = q.shape[2]
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    c, k_pe = (h @ params["wkv_a"]).split([kv_rank, rope], dim=-1)
    c = rmsnorm(c, params["kv_norm"], MLA_KV_NORM_EPS)
    k_nope, v = _heads(c, params["wkv_b"]).split([nope, v_dim], dim=-1)
    positions = torch.arange(s, device=x.device)
    q_pe = apply_rope_pairs(q_pe, positions, rope_theta)
    k_pe = apply_rope_pairs(k_pe[:, :, None, :], positions, rope_theta)  # (B,S,1,rope)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, s, n_heads, rope)], dim=-1)
    with trace.span("mla.attention"):
        o = mla_attention(q, k, v, (nope + rope) ** -0.5)
    return x + _merge_heads(o, params["wo"])


# --------------------------------------------------------------------------
# MLP (SwiGLU)
# --------------------------------------------------------------------------


def init_mlp(generator, d_model: int, d_ff: int, dtype):
    return {
        "wi": ninit(generator, (d_model, d_ff), d_model ** -0.5, dtype),
        "wg": ninit(generator, (d_model, d_ff), d_model ** -0.5, dtype),
        "wo": ninit(generator, (d_ff, d_model), d_ff ** -0.5, dtype),
        "norm": torch.zeros((d_model,), dtype=dtype, device=generator.device),
    }


def mlp_layer(params: dict, x: torch.Tensor, norm_eps: float = 1e-5) -> torch.Tensor:
    h = rmsnorm(x, params["norm"], norm_eps)
    g = F.silu(h @ gathered(params["wg"], 1))
    u = h @ gathered(params["wi"], 1)
    ff = shard(g * u, "replica", "batch", "seq", "ff")
    return x + residual(ff @ gathered(params["wo"], 0))


# --------------------------------------------------------------------------
# embeddings
# --------------------------------------------------------------------------


def init_embedding(generator, vocab: int, d_model: int, dtype):
    return {"table": ninit(generator, (vocab, d_model), d_model ** -0.5, dtype)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    if is_dtensor(params["table"]):
        return _embed_partitioned(params["table"], tokens)
    return params["table"][tokens]


def vocab_range(mesh, placements, dim: int, size: int) -> tuple[list, int]:
    """The mesh dims that shard tensor dim ``dim`` (of ``size``) and this
    rank's first index along it (torch's chunking)."""
    dims = [i for i, p in enumerate(placements) if p.is_shard() and p.dim == dim]
    r, n = 0, 1
    for i in dims:
        r, n = r * mesh.size(i) + mesh.get_local_rank(i), n * mesh.size(i)
    return dims, min(r * -(-size // n), size)


def _embed_partitioned(table, tokens):
    """Vocab-parallel lookup (Megatron's): each rank looks up the tokens in
    its own vocab range in its rows of the table, and the rows are summed
    over the vocab shards; the table's other dims are gathered first."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    vocab, offset = vocab_range(mesh, table.placements, 0, table.shape[0])
    t_pl = [Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim)]
    local = table.redistribute(mesh, t_pl).to_local()
    b_pl = [Replicate() if i in vocab else p
            for i, p in enumerate(placements_for(mesh, "batch", None, shape=tokens.shape))]
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    lt = tokens.redistribute(mesh, b_pl).to_local().long() - offset
    ok = (lt >= 0) & (lt < local.shape[0])
    rows = local[lt.clamp(0, max(local.shape[0] - 1, 0))]
    rows = torch.where(ok[..., None], rows, 0.0).to(local.dtype)
    partial = [Partial() if i in vocab else p for i, p in enumerate(b_pl)]
    return DTensor.from_local(rows, mesh, partial, run_check=False).redistribute(mesh, b_pl)


# --------------------------------------------------------------------------
# the LM head
# --------------------------------------------------------------------------

SPLIT_DEVICES = ("cuda",)   # where bf16 tensor-core GEMMs with an f32 output run
SPLIT_BYTES = 320 << 20     # the most the backward's bf16 hi + lo rows of dlogits take at once
# the most terms one backward GEMM sums: a tensor core's f32 accumulator
# truncates, so its error grows with the depth (on an H100, dx over all of
# [hi | lo] at 40,960 terms: 6.4e-5 of its norm; in GEMMs of 8,192: 1.0e-5)
SPLIT_DEPTH = 8192


def takes_split(x, w) -> bool:
    """Whether ``head_logits`` runs the head on bf16 tensor cores: bf16 ``x``
    and ``w``, plain tensors on a device of ``SPLIT_DEVICES``."""
    return (x.dtype == w.dtype == torch.bfloat16
            and x.device.type in SPLIT_DEVICES and w.device.type in SPLIT_DEVICES
            and not is_dtensor(x) and not is_dtensor(w))


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two bf16 matrices, accumulated and written in f32 (cuBLAS's
    bf16 tensor-core GEMM): each product of two bf16 values is exact in f32."""
    return torch.mm(a, b, out_dtype=torch.float32)


def split_rows(vocab: int) -> int:
    """The rows of dlogits (…, vocab) the backward splits at once: within
    ``SPLIT_BYTES``, and dW's GEMM over hi's and lo's rows within
    ``SPLIT_DEPTH``."""
    return max(1, min(SPLIT_BYTES // (4 * vocab), SPLIT_DEPTH // 2))


def head_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The f32 logits x (…, D) · w (V, D)ᵀ, in the span ``lm.head`` whose
    ``path`` says how they were computed.

    ``bf16_split`` (``takes_split``): the forward is one bf16 GEMM with an
    f32 output, the logits of ``x.float() @ w.float().T`` up to the order of
    summation; the backward splits the f32 dlogits into bf16 hi + lo
    (``split_grads``), within 2⁻¹⁶ of it, below the bf16 rounding of both
    gradients. ``f32`` (f32 or fp16 inputs, DTensors, CPU tensors):
    ``x.float() @ w.float().T`` as autograd takes it."""
    split = takes_split(x, w)
    with trace.span("lm.head", path="bf16_split" if split else "f32"):
        if split:
            return HeadLogits.apply(x, w)
        return x.float() @ w.float().T


class HeadLogits(torch.autograd.Function):
    """``head_logits``' bf16 path through ``mm_f32``. Saves ``x`` and ``w``
    as they are; each gradient is rounded once to bf16."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return mm_f32(x.reshape(-1, x.shape[-1]), w.T).view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        v = w.shape[0]
        dx, dw = split_grads(g.reshape(-1, v), x.reshape(-1, x.shape[-1]), w, mm_f32,
                             split_rows(v), SPLIT_DEPTH)
        return dx.to(x.dtype).view(x.shape), dw.to(w.dtype)


def split_bf16(g: torch.Tensor) -> torch.Tensor:
    """f32 g (n, V) as bf16 (n, 2, V): [:, 0] hi = bf16(g), [:, 1] lo =
    bf16(g − hi). g − hi is exact in f32, so hi + lo is g within 2⁻¹⁶ of
    |g| (bf16's rounding, twice) wherever lo is no subnormal."""
    hl = torch.empty(g.shape[0], 2, g.shape[1], dtype=torch.bfloat16, device=g.device)
    hl[:, 0] = g
    torch.sub(g, hl[:, 0], out=hl[:, 1])
    return hl


def split_grads(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor, mm, rows: int, depth: int):
    """(dx, dw) = (g · w, gᵀ · x) in f32, from f32 g (T, V) and bf16 x (T, D),
    w (V, D), through ``mm`` (two bf16 matrices' f32 product) on
    ``split_bf16(g)``, ``rows`` rows of g at a time. A GEMM's f32
    accumulator adds hi's and lo's products: dx = [hi | lo] · [w; w], in
    GEMMs over ``depth`` of its 2V columns, their partials added in f32; dw
    over the chunk's rows interleaved (hi₀, lo₀, hi₁, lo₁, …) against x's
    rows each taken twice (2 · ``rows`` terms)."""
    t, v = g.shape
    dx = g.new_empty(t, x.shape[1])
    ww = torch.cat([w, w])
    dw = None
    for s in range(0, t, rows):
        hl = split_bf16(g[s:s + rows])
        n = hl.shape[0]
        a = hl.view(n, 2 * v)
        acc = mm(a[:, :depth], ww[:depth])
        for k in range(depth, 2 * v, depth):
            acc.add_(mm(a[:, k:k + depth], ww[k:k + depth]))
        dx[s:s + n] = acc
        part = mm(hl.view(2 * n, v).T, x[s:s + n].repeat_interleave(2, dim=0))
        dw = part if dw is None else dw.add_(part)
    return dx, dw


def unembed(params: dict, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    logits = head_logits(x, gathered(params["table"], 0))
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits

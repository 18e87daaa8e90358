"""Unified causal LM for the decoder-only families: dense / GQA attention,
MoE FFN, Mamba2 (SSD) mixers and hybrid interleaves (Jamba).

Port of ``repro/models/model.py``, serving side. Layer stacks are grouped
into (prefix, periodic blocks) as in the reference: ``params["blocks"]``
holds, for each position in the period, every group's leaves stacked on a
leading dim, and the reference's ``lax.scan`` over groups is a loop that
indexes them. The encoder-decoder path and the vision/audio frontends
(seamless-m4t, internvl2) are not ported yet: they raise
``NotImplementedError``. ``loss_fn`` and ``make_model`` come with LM
training.

API:
    init(cfg, generator) -> params
    params_from_jax(np_params, device, dtype=None) -> params
    prefill(cfg, params, batch) -> last-position logits (B, 1, V)
    init_cache(cfg, batch, max_len, window, device) -> cache
    decode_step(cfg, params, cache, tokens) -> (logits (B, 1, V), cache)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

from . import layers as L
from . import mamba2 as M
from . import moe as MOE

# --------------------------------------------------------------------------
# layer pattern -> (prefix, period) decomposition
# --------------------------------------------------------------------------


def layer_pattern(cfg: ModelConfig) -> list[tuple[str, str]]:
    return [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(cfg.n_layers)]


def find_prefix_period(pattern: list) -> tuple[int, int]:
    """Smallest (prefix, period) with pattern[prefix:] periodic."""
    n = len(pattern)
    for prefix in range(0, n):
        rest = pattern[prefix:]
        for period in (1, 2, 4, 8):
            if len(rest) % period:
                continue
            if all(rest[i] == rest[i % period] for i in range(len(rest))):
                return prefix, period
    return n, 1  # fully unrolled fallback


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.encoder_layers > 0 or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder path and the vision/audio frontends "
            "(seamless-m4t, internvl2) are not ported yet"
        )


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _n_groups(cfg: ModelConfig, prefix: int, period: int) -> int:
    return (cfg.n_layers - prefix) // period


def _group(tree: dict, g: int) -> dict:
    """Group ``g`` of a stacked subtree (views, no copy)."""
    return {k: _group(v, g) if isinstance(v, dict) else v[g] for k, v in tree.items()}


def _stack(trees: list) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


# --------------------------------------------------------------------------
# per-layer init / apply
# --------------------------------------------------------------------------


def init_sublayers(cfg: ModelConfig, generator, kind: str, ffn_kind: str) -> dict:
    dt = _dtype(cfg)
    p: dict = {}
    if kind == "attn":
        p["mixer"] = L.init_attention(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, dt
        )
    else:  # ssm
        p["mixer"] = M.init_mamba2(
            generator, cfg.d_model, expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
            state=cfg.ssm_state, conv=cfg.ssm_conv, dtype=dt,
        )
    if ffn_kind == "moe":
        p["ffn"] = MOE.init_moe(
            generator, cfg.d_model, cfg.d_ff, cfg.n_experts, dt,
            dense_residual_ff=cfg.dense_residual_ff if cfg.dense_residual else 0,
        )
    elif cfg.d_ff > 0:
        p["ffn"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, dt)
    return p


def apply_sublayers(
    cfg: ModelConfig,
    kind: str,
    ffn_kind: str,
    params: dict,
    x: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill path: mixer -> ffn. Returns (x, aux)."""
    aux = torch.zeros((), device=x.device)
    if kind == "attn":
        x = L.attention_layer(
            params["mixer"], x,
            n_rep=cfg.n_heads // cfg.n_kv_heads,
            rope_theta=cfg.rope_theta,
            window=cfg.sliding_window,
            norm_eps=cfg.norm_eps,
            use_flash=cfg.use_flash_kernel,
        )
    else:
        x = M.mamba2_forward(
            params["mixer"], x,
            head_dim=cfg.ssm_head_dim, state=cfg.ssm_state, chunk=cfg.ssm_chunk,
            norm_eps=cfg.norm_eps, use_kernel=cfg.use_ssd_kernel,
        )
    if ffn_kind == "moe":
        x, aux = MOE.moe_layer(
            params["ffn"], x, top_k=cfg.top_k, norm_eps=cfg.norm_eps,
            dispatch=cfg.moe_dispatch, combine_dtype=cfg.moe_combine_dtype,
            use_gmm_kernel=cfg.use_gmm_kernel,
        )
    elif cfg.d_ff > 0:
        x = L.mlp_layer(params["ffn"], x, cfg.norm_eps)
    return x, aux


# --------------------------------------------------------------------------
# model init
# --------------------------------------------------------------------------


def init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random weights on the generator's device, in the reference's tree:
    ``embed``, ``prefix`` (list), ``blocks`` (``pos{j}`` stacked over
    groups; one group even when the pattern has none, as the reference
    inits), ``final_norm`` and, unless tied, ``lm_head``."""
    _check_supported(cfg)
    dt = _dtype(cfg)
    pattern = layer_pattern(cfg)
    prefix, period = find_prefix_period(pattern)
    n_groups = _n_groups(cfg, prefix, period)
    params: dict = {"embed": L.init_embedding(generator, cfg.vocab_size, cfg.d_model, dt)}
    params["prefix"] = [init_sublayers(cfg, generator, *pattern[i]) for i in range(prefix)]
    params["blocks"] = {
        f"pos{j}": _stack([init_sublayers(cfg, generator, *pattern[prefix + j])
                           for _ in range(max(n_groups, 1))])
        for j in range(period)
    }
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=dt, device=generator.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.ninit(
            generator, (cfg.vocab_size, cfg.d_model), cfg.d_model ** -0.5, dt
        )
    return params


def params_from_jax(np_params, device, dtype=None):
    """The reference's parameter tree with numpy leaves (dicts, the
    ``prefix`` list, stacked ``blocks``) to the port's, leaf for leaf.
    ``dtype`` casts the floating leaves; by default each keeps its own
    (bfloat16 arrives as ml_dtypes and goes through f32, which is exact)."""
    if isinstance(np_params, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in np_params.items()}
    if isinstance(np_params, (list, tuple)):
        return [params_from_jax(v, device, dtype) for v in np_params]
    arr = np.asarray(np_params)
    bf16 = arr.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(arr, np.float32 if bf16 else arr.dtype))
    want = dtype if (dtype is not None and t.is_floating_point()) else (
        torch.bfloat16 if bf16 else t.dtype)
    return t.to(device=device, dtype=want)


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------


def _trunk(cfg: ModelConfig, params: dict, x: torch.Tensor):
    """Apply the prefix layers, then each group of the periodic blocks."""
    pattern = layer_pattern(cfg)
    prefix, period = find_prefix_period(pattern)
    aux_total = torch.zeros((), device=x.device)
    for i in range(prefix):
        x, aux = apply_sublayers(cfg, *pattern[i], params["prefix"][i], x)
        aux_total = aux_total + aux
    for g in range(_n_groups(cfg, prefix, period)):
        for j in range(period):
            x, aux = apply_sublayers(cfg, *pattern[prefix + j],
                                     _group(params["blocks"][f"pos{j}"], g), x)
            aux_total = aux_total + aux
    return x, aux_total


def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict):
    """Token embeddings. Returns (x, n_vis); no frontend is ported, so
    n_vis is 0."""
    _check_supported(cfg)
    return L.embed(params["embed"], batch["tokens"]), 0


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x, cfg.logits_softcap)
    logits = x.float() @ params["lm_head"].float().T
    if cfg.logits_softcap > 0:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return logits


@torch.no_grad()
def prefill(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Full-sequence forward over ``batch["tokens"]`` (B, S), returning the
    last position's logits (B, 1, V) in f32."""
    x, _ = _embed_inputs(cfg, params, batch)
    x, _ = _trunk(cfg, params, x)
    return _logits(cfg, params, x[:, -1:, :])


# --------------------------------------------------------------------------
# decode: cache init / one-token step
# --------------------------------------------------------------------------


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int, device):
    dt = _dtype(cfg)
    if kind == "attn":
        shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    n_heads = (cfg.ssm_expand * cfg.d_model) // cfg.ssm_head_dim
    d_inner = n_heads * cfg.ssm_head_dim
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * cfg.ssm_state),
                            dtype=dt, device=device),
        "ssm": torch.zeros((batch, n_heads, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, window: int = 0,
               device=None) -> dict:
    """window > 0 => rolling attention buffers of that size. ``cur_len``
    is a Python int: the number of tokens the cache holds."""
    _check_supported(cfg)
    pattern = layer_pattern(cfg)
    prefix, period = find_prefix_period(pattern)
    n_groups = _n_groups(cfg, prefix, period)
    attn_len = min(max_len, window) if window else max_len
    cache: dict = {
        "prefix": [_layer_cache(cfg, pattern[i][0], batch, attn_len, device)
                   for i in range(prefix)],
        "blocks": {},
        "cur_len": 0,
    }
    for j in range(period):
        one = _layer_cache(cfg, pattern[prefix + j][0], batch, attn_len, device)
        cache["blocks"][f"pos{j}"] = {
            k: v[None].repeat((n_groups,) + (1,) * v.ndim) for k, v in one.items()
        }
    return cache


def _decode_sublayers(cfg: ModelConfig, kind: str, ffn_kind: str, params: dict,
                      x: torch.Tensor, cache: dict, cur_len: int, window: int):
    if kind == "attn":
        x, _, _ = L.decode_attention(
            params["mixer"], x, cache["k"], cache["v"], cur_len,
            n_rep=cfg.n_heads // cfg.n_kv_heads, rope_theta=cfg.rope_theta,
            window=window, norm_eps=cfg.norm_eps,
        )
    else:
        x, _ = M.mamba2_decode_step(
            params["mixer"], x, cache,
            head_dim=cfg.ssm_head_dim, state=cfg.ssm_state, norm_eps=cfg.norm_eps,
        )
    if ffn_kind == "moe":
        decode_dispatch = "gather" if cfg.moe_decode_gather else cfg.moe_dispatch
        x, _ = MOE.moe_layer(params["ffn"], x, top_k=cfg.top_k, norm_eps=cfg.norm_eps,
                             dispatch=decode_dispatch, combine_dtype=cfg.moe_combine_dtype)
    elif cfg.d_ff > 0:
        x = L.mlp_layer(params["ffn"], x, cfg.norm_eps)
    return x


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
                window: int = 0) -> tuple[torch.Tensor, dict]:
    """One-token decode against the cache. tokens (B, 1). Every cache leaf
    is updated in place (the reference returns a new cache); returns
    (logits (B,1,V) f32, cache) with ``cur_len`` advanced by one."""
    pattern = layer_pattern(cfg)
    prefix, period = find_prefix_period(pattern)
    cur = cache["cur_len"]
    x = L.embed(params["embed"], tokens)
    for i in range(prefix):
        x = _decode_sublayers(cfg, *pattern[i], params["prefix"][i], x,
                              cache["prefix"][i], cur, window)
    for g in range(_n_groups(cfg, prefix, period)):
        for j in range(period):
            x = _decode_sublayers(cfg, *pattern[prefix + j],
                                  _group(params["blocks"][f"pos{j}"], g), x,
                                  _group(cache["blocks"][f"pos{j}"], g), cur, window)
    cache["cur_len"] = cur + 1
    return _logits(cfg, params, x), cache

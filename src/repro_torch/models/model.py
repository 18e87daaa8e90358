"""Unified causal LM for the decoder-only families: dense / GQA attention,
MoE FFN, Mamba2 (SSD) mixers and hybrid interleaves (Jamba).

Port of ``repro/models/model.py``. Layer stacks are grouped into (prefix,
periodic blocks) as in the reference: ``params["blocks"]`` holds, for each
position in the period, every group's leaves stacked on a leading dim, and
the reference's ``lax.scan`` over groups is a loop over them; under
``cfg.remat`` each group runs under activation checkpointing, as the
reference's scan body does. The encoder-decoder path and the vision/audio
frontends (seamless-m4t, internvl2) are not ported yet: they raise
``NotImplementedError``.

Training runs with the kernel flags off: the LM kernels are forward-only,
here as in the reference, whose ``jax.grad`` cannot differentiate them.
``make_model`` refuses a config with a flag on, and each kernel's wrapper
raises where autograd would record it (``kernels.refuse_grad``).

API:
    init(cfg, generator) -> params
    params_from_jax(np_params, device, dtype=None) -> params
    loss_fn(cfg, params, batch) -> (loss, aux)           # training
    make_model(cfg) -> TrainableModel over the flattened tree
    prefill(cfg, params, batch) -> last-position logits (B, 1, V)
    init_cache(cfg, batch, max_len, window, device) -> cache
    decode_step(cfg, params, cache, tokens) -> (logits (B, 1, V), cache)
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.models.protocol import TrainableModel
from repro_torch.utils import tree as tu

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


KERNEL_FLAGS = ("use_flash_kernel", "use_ssd_kernel", "use_gmm_kernel")


def refuse_kernel_flags(cfg) -> None:
    """Training needs gradients through every layer, and the LM kernels have
    none (``kernels.refuse_grad``): refuse a config that routes a layer
    through one, naming the flag. Configs without the flags pass."""
    on = [f for f in KERNEL_FLAGS if getattr(cfg, f, False)]
    if on:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(on)} on, but the kernel has no backward (nor "
            "has the reference's): LM training runs with the kernel flags off"
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


def _unbind(tree: dict) -> list:
    """Every group of a stacked subtree, each a tree of views. One
    ``unbind`` per leaf: autograd stacks the groups' gradients once, where
    indexing group by group would build a full-size gradient for each."""
    parts = {k: _unbind(v) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[g] for k, v in parts.items()} for g in range(n)]


# activation checkpointing: the matmul outputs that ``remat_policy="dots"``
# keeps (the reference's ``dots_with_no_batch_dims_saveable``: an (M,K)x(K,N)
# product, which is what a (B,S,D)x(D,F) projection folds into; bmm and its
# batch dim, as in attention's einsums and the experts, are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, body):
    """``body`` under the configured activation-checkpoint policy: 'full'
    keeps only its inputs and recomputes the rest in the backward; 'dots'
    also keeps the matmul outputs and recomputes only the elementwise
    chains. Neither changes a number: the recomputation repeats the same
    ops on the same inputs."""
    if cfg.remat_policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return functools.partial(checkpoint, body, use_reentrant=False, context_fn=context_fn)
    return functools.partial(checkpoint, body, use_reentrant=False)


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
    """Train/prefill path: mixer -> ffn. Returns (x, aux)."""
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
# forward (train / prefill trunk)
# --------------------------------------------------------------------------


def _trunk(cfg: ModelConfig, params: dict, x: torch.Tensor):
    """Apply the prefix layers, then each group of the periodic blocks, the
    groups under activation checkpointing when ``cfg.remat`` is on and
    autograd records (the prefix layers are not, as in the reference)."""
    pattern = layer_pattern(cfg)
    prefix, period = find_prefix_period(pattern)
    aux_total = torch.zeros((), device=x.device)
    for i in range(prefix):
        x, aux = apply_sublayers(cfg, *pattern[i], params["prefix"][i], x)
        aux_total = aux_total + aux
    blocks = [_unbind(params["blocks"][f"pos{j}"]) for j in range(period)]

    def body(x, aux_acc, group):
        for j in range(period):
            x, aux = apply_sublayers(cfg, *pattern[prefix + j], group[j], x)
            aux_acc = aux_acc + aux
        return x, aux_acc

    if cfg.remat and torch.is_grad_enabled():
        body = _remat(cfg, body)
    for g in range(_n_groups(cfg, prefix, period)):
        x, aux_total = body(x, aux_total, [blocks[j][g] for j in range(period)])
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


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """Masked causal-LM cross entropy over f32 logits, for one model (no
    replica dim): ``tokens``/``targets`` (B, S), ``sample_mask`` (B,).
    Returns (loss + router_aux_coef * moe_aux, aux) with aux = accuracy,
    n_valid (live samples), moe_aux and ce_loss."""
    x, _ = _embed_inputs(cfg, params, batch)
    x, moe_aux = _trunk(cfg, params, x)
    logits = _logits(cfg, params, x)
    logp = torch.log_softmax(logits, dim=-1)
    tgt = batch["targets"].long()
    nll = -logp.gather(-1, tgt[..., None])[..., 0]                       # (B, S)
    smask = batch["sample_mask"].float()[:, None]
    n_valid = smask.sum() * tgt.shape[1]
    loss = (nll * smask).sum() / n_valid.clamp_min(1.0)
    acc = ((logits.argmax(-1) == tgt) * smask).sum() / n_valid.clamp_min(1.0)
    total = loss + cfg.router_aux_coef * moe_aux
    return total, {"accuracy": acc, "n_valid": smask.sum(), "moe_aux": moe_aux,
                   "ce_loss": loss}


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


# --------------------------------------------------------------------------
# trainer-protocol bundle
# --------------------------------------------------------------------------


def make_model(cfg: ModelConfig) -> TrainableModel:
    """The LM as the trainer takes it: parameters as a flat dict keyed by
    path (``utils.tree.flatten``), so the trainer, the SGD update and the
    merge see one leaf per stacked tensor. ``loss_fn`` takes one model and
    (B, S) batches, or replica-stacked (R, ...) leaves and (R, B, S)
    batches and returns (R,) loss and aux: a loop over the replicas, each
    on views of its leaves (the MoE dispatch's data-dependent sort and
    ``index_put`` do not vectorize). No ``sparse_grad_fn``: the trainer
    takes dense autograd, as the reference does for the LM. Refuses a
    config with a kernel flag on (``refuse_kernel_flags``)."""
    refuse_kernel_flags(cfg)

    def init_flat(generator: torch.Generator) -> dict:
        return tu.flatten(init(cfg, generator))

    def flat_loss(flat: dict, batch: dict):
        if batch["tokens"].ndim == 2:
            return loss_fn(cfg, tu.unflatten(flat), batch)
        views = {k: v.unbind(0) for k, v in flat.items()}
        outs = [loss_fn(cfg, tu.unflatten({k: v[r] for k, v in views.items()}),
                        {k: v[r] for k, v in batch.items()})
                for r in range(batch["tokens"].shape[0])]
        return (torch.stack([loss for loss, _ in outs]),
                {k: torch.stack([aux[k] for _, aux in outs]) for k in outs[0][1]})

    return TrainableModel(init=init_flat, loss_fn=flat_loss, config=cfg)

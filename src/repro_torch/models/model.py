"""Unified causal LM covering every registered architecture family: dense /
GQA attention, MoE FFN, Mamba2 (SSD) mixers, hybrid interleaves (Jamba),
encoder-decoder (Seamless, an audio frontend) and a vision frontend
(InternVL2).

Port of ``repro/models/model.py``. Layer stacks are grouped into (prefix,
periodic blocks) as in the reference: ``params["blocks"]`` holds, for each
position in the period, every group's leaves stacked on a leading dim, and
the reference's ``lax.scan`` over groups is a loop over them; under
``cfg.remat`` each group (and each encoder layer) runs under activation
checkpointing, as the reference's scan bodies do.

The frontends are stubs, as in the reference: a batch carries precomputed
embeddings, projected to ``d_model`` by ``frontend_proj``. ``frames`` (B,
F, Fd) feed the encoder (non-causal self-attention + MLP per layer), whose
memory every decoder layer cross-attends to through ``params["cross"][i]``
(no RoPE, blockwise, never the flash kernel); ``patch_embeds`` (B, P, Fd)
are prepended to the token embeddings, and the loss skips their
positions. Decoding sees neither, as in the reference: the cache's
``cross_kv`` holds zeros, and decode positions start at 0.

Latent attention (port-only; the reference has none): a config from
``configs/moonlight_16b_a3b.py`` (``is_mla``) takes MLA mixers
(``layers.mla_layer``), dense layers of ``dense_d_ff`` and dropless
sigmoid-routed MoE layers with shared experts over the experts it holds
(``moe.moe_layer_dropless``), whose fixed selection bias is a buffer beside
the trained leaves (``init_buffers``). It trains only: prefill and
decoding refuse it (``refuse_mla``), and so does the partitioned program
(``sharding.rules.MeshAxes``).

Training runs with the kernel flags off: the LM kernels are forward-only,
here as in the reference, whose ``jax.grad`` cannot differentiate them.
``make_model`` refuses a config with a flag on, and each kernel's wrapper
raises where autograd would record it (``kernels.refuse_grad``).

API:
    init(cfg, generator) -> params
    params_from_jax(np_params, device, dtype=None) -> params
    loss_fn(cfg, params, batch) -> (loss, aux)           # training
    make_model(cfg) -> TrainableModel over the flattened tree
    init_buffers(cfg, generator) -> fixed non-trained tensors (MLA's bias)
    prefill(cfg, params, batch) -> last-position logits (B, 1, V)
    init_cache(cfg, batch, max_len, window, device) -> cache
    decode_step(cfg, params, cache, tokens) -> (logits (B, 1, V), cache)
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.models.protocol import TrainableModel
from repro_torch.sharding.annotate import constrain, gathered, is_dtensor, placements_for, shard
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


def is_mla(cfg) -> bool:
    """A latent-attention config (``configs/moonlight_16b_a3b.py``): MLA
    mixers, dropless sigmoid-routed experts with shared ones."""
    return getattr(cfg, "kv_lora_rank", 0) > 0


def refuse_mla(cfg, what: str) -> None:
    """Raise a ``ValueError`` naming what serving (``what``: prefill or
    decoding) lacks for a latent-attention config; other configs pass."""
    if is_mla(cfg):
        raise ValueError(
            f"{cfg.name}: {what} of a latent-attention (MLA) config needs a cache of the "
            "compressed KV latent and its rotary key, and a prefill kernel for q/k heads of "
            f"{cfg.qk_head_dim} against v heads of {cfg.v_head_dim} (kernels/flash_attention "
            "takes one head dim of at most 128), which the port does not have; the config "
            "trains only (loss_fn, make_model)")


def init_buffers(cfg, generator: torch.Generator) -> dict:
    """The fixed tensors a config's loss reads beside its trained leaves,
    as a flat dict keyed like the parameters: for a latent-attention
    config, each MoE layer's selection bias (``e_score_correction_bias``)
    over all ``n_experts``, normal at ``cfg.score_bias_std``, in f32 on the
    generator's device, ``score_bias`` beside the layer's router. The loss
    has no gradient for it, and training leaves it as drawn. Empty for
    every other config."""
    if not is_mla(cfg):
        return {}
    pattern = layer_pattern(cfg)
    prefix, period = find_prefix_period(pattern)
    n_groups = _n_groups(cfg, prefix, period)

    # the leading layers are the dense ones: every MoE layer is in the blocks
    return {f"blocks.pos{j}.ffn.score_bias":
            torch.randn((max(n_groups, 1), cfg.n_experts), generator=generator,
                        device=generator.device) * cfg.score_bias_std
            for j in range(period) if pattern[prefix + j][1] == "moe"}


def init_sublayers(cfg: ModelConfig, generator, kind: str, ffn_kind: str) -> dict:
    dt = _dtype(cfg)
    p: dict = {}
    if kind == "mla":
        p["mixer"] = L.init_mla(generator, cfg.d_model, cfg.n_heads, cfg.kv_lora_rank,
                                cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, dt)
        if ffn_kind == "moe":
            p["ffn"] = MOE.init_moe_dropless(generator, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                             cfg.n_held, cfg.n_shared_experts, dt)
        else:
            p["ffn"] = L.init_mlp(generator, cfg.d_model, cfg.dense_d_ff, dt)
        return p
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
    cross: Optional[tuple] = None,  # (cross_params, encoder_memory)
    rows_valid: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Train/prefill path: mixer -> [cross-attn] -> ffn. Returns (x, aux).
    ``rows_valid`` (B,): the batch rows that hold a sample; a dropless MoE
    layer routes no other row to its experts (read by MLA configs only)."""
    aux = torch.zeros((), device=x.device)
    if kind == "mla":
        x = L.mla_layer(params["mixer"], x, kv_rank=cfg.kv_lora_rank,
                        nope=cfg.qk_nope_head_dim, rope=cfg.qk_rope_head_dim,
                        v_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps)
        if ffn_kind == "moe":
            return MOE.moe_layer_dropless(
                params["ffn"], x, top_k=cfg.top_k, first_expert=cfg.first_expert,
                scale=cfg.routed_scaling_factor, norm_topk_prob=cfg.norm_topk_prob,
                norm_eps=cfg.norm_eps, rows_valid=rows_valid)
        return L.mlp_layer(params["ffn"], x, cfg.norm_eps), aux
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
    if cross is not None:
        cp, mem = cross
        x = L.attention_layer(
            cp, x, n_rep=cfg.n_heads // cfg.n_kv_heads, rope_theta=cfg.rope_theta,
            norm_eps=cfg.norm_eps, cross_kv=L.memory_kv(cp, mem),
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
    inits), ``final_norm``, unless tied ``lm_head``; for an encoder,
    ``encoder`` (``layers``: attention + dense sublayers stacked over
    ``encoder_layers``, and ``norm``) and ``cross`` (one attention dict a
    decoder layer); for a frontend, ``frontend_proj`` (Fd, D)."""
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
    if cfg.encoder_layers > 0:
        params["encoder"] = {
            "layers": _stack([init_sublayers(cfg, generator, "attn", "dense")
                              for _ in range(cfg.encoder_layers)]),
            "norm": torch.zeros((cfg.d_model,), dtype=dt, device=generator.device),
        }
        params["cross"] = [
            L.init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.resolved_head_dim, dt)
            for _ in range(cfg.n_layers)
        ]
    if cfg.frontend is not None:
        params["frontend_proj"] = L.ninit(
            generator, (cfg.frontend_dim, cfg.d_model), cfg.frontend_dim ** -0.5, dt
        )
    return params


def params_from_jax(np_params, device, dtype=None):
    """The reference's parameter tree with numpy leaves (dicts, the
    ``prefix`` and ``cross`` lists, stacked ``blocks`` and
    ``encoder.layers``, ``frontend_proj``) to the port's, leaf for leaf.
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


def _run_encoder(cfg: ModelConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder over the projected frontend embeddings
    (``frames`` cast to the model's dtype first): per layer non-causal
    self-attention and the MLP, each layer under activation checkpointing
    when ``cfg.remat`` is on and autograd records; then the encoder norm."""
    x = frames.to(_dtype(cfg)) @ gathered(params["frontend_proj"], 1)
    enc = params["encoder"]

    def body(x, lp):
        h = L.attention_layer(lp["mixer"], x, n_rep=cfg.n_heads // cfg.n_kv_heads,
                              rope_theta=cfg.rope_theta, causal=False, norm_eps=cfg.norm_eps)
        return L.mlp_layer(lp["ffn"], h, cfg.norm_eps)

    if cfg.remat and torch.is_grad_enabled():
        body = _remat(cfg, body)
    for lp in _unbind(enc["layers"]):
        x = body(x, lp)
    return L.rmsnorm(x, enc["norm"], cfg.norm_eps)


def _trunk(cfg: ModelConfig, params: dict, x: torch.Tensor,
           memory: Optional[torch.Tensor] = None, rows_valid: Optional[torch.Tensor] = None):
    """Apply the prefix layers, then each group of the periodic blocks, the
    groups under activation checkpointing when ``cfg.remat`` is on and
    autograd records (the prefix layers are not, as in the reference).
    With an encoder ``memory``, decoder layer i (``prefix + g * period +
    j`` in group g) cross-attends to it through ``params["cross"][i]``."""
    pattern = layer_pattern(cfg)
    prefix, period = find_prefix_period(pattern)
    cross_all = params.get("cross")

    def cross(i):
        return None if cross_all is None else (cross_all[i], memory)

    x = L.residual(x)
    aux_total = torch.zeros((), device=x.device)
    for i in range(prefix):
        x, aux = apply_sublayers(cfg, *pattern[i], params["prefix"][i], x, cross(i),
                                 rows_valid)
        aux_total = aux_total + aux
    blocks = [_unbind(params["blocks"][f"pos{j}"]) for j in range(period)]

    def body(x, aux_acc, group, crosses):
        for j in range(period):
            x, aux = apply_sublayers(cfg, *pattern[prefix + j], group[j], x, crosses[j],
                                     rows_valid)
            aux_acc = aux_acc + aux
        return x, aux_acc

    if cfg.remat and torch.is_grad_enabled():
        body = _remat(cfg, body)
    for g in range(_n_groups(cfg, prefix, period)):
        x, aux_total = body(x, aux_total, [blocks[j][g] for j in range(period)],
                            [cross(prefix + g * period + j) for j in range(period)])
    return x, aux_total


def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict):
    """Token (+ vision frontend) embeddings. Returns (x, n_vis): the first
    n_vis positions are the projected ``patch_embeds`` (cast to the
    model's dtype first), not text, and the loss skips them."""
    tok = L.embed(params["embed"], batch["tokens"])
    if cfg.frontend == "vision":
        vis = batch["patch_embeds"].to(tok.dtype) @ gathered(params["frontend_proj"], 1)
        return torch.cat([vis, tok], dim=1), vis.shape[1]
    return tok, 0


def _memory(cfg: ModelConfig, params: dict, batch: dict) -> Optional[torch.Tensor]:
    """The encoder's output over ``batch["frames"]``, or None without an
    encoder."""
    return _run_encoder(cfg, params, batch["frames"]) if cfg.encoder_layers > 0 else None


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x, cfg.logits_softcap)
    logits = L.head_logits(x, gathered(params["lm_head"], 0))
    if cfg.logits_softcap > 0:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return logits


def _target_logp(logits: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """log_softmax(logits)[..., tgt]. For a DTensor whose vocab dim is
    sharded, vocab-parallel (Megatron's cross entropy): the log-sum-exp
    from ``amax`` and a sum over the shards, and each rank picks the
    targets in its own vocab range from its local shard, the picks summed
    over the shards; gathering the vocab dim would move the whole logits."""
    if not is_dtensor(logits):
        logp = torch.log_softmax(logits, dim=-1)
        return logp.gather(-1, tgt[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate

    top = logits.amax(dim=-1, keepdim=True).detach()
    lse = top + (logits - top).exp().sum(dim=-1, keepdim=True).log()
    logp = logits - lse
    mesh, v = logits.device_mesh, logits.shape[-1]
    vocab = [i for i, p in enumerate(logp.placements) if p.is_shard() and p.dim == logp.ndim - 1]
    if not vocab:  # a whole vocab a rank: gather locally (DTensor's gather would mask)
        rows = placements_for(mesh, "batch", None, None, shape=logp.shape)
        logp = constrain(logp, rows)
        if not is_dtensor(tgt):
            tgt = DTensor.from_local(tgt, mesh, [Replicate()] * mesh.ndim, run_check=False)
        tgt = constrain(tgt, rows)
        return DTensor.from_local(
            logp.to_local().gather(-1, tgt.to_local().unsqueeze(-1)).squeeze(-1), mesh, rows,
            run_check=False)
    pl = [Replicate() if i in vocab else p for i, p in enumerate(logp.placements)]
    local = logp.to_local()
    t_local = (tgt.redistribute(mesh, pl) if is_dtensor(tgt)
               else DTensor.from_local(tgt, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False).redistribute(mesh, pl)).to_local()
    _, offset = L.vocab_range(mesh, logp.placements, logp.ndim - 1, v)
    lt = t_local - offset
    ok = (lt >= 0) & (lt < local.shape[-1])
    picked = local.gather(-1, lt.clamp(0, max(local.shape[-1] - 1, 0))[..., None])[..., 0]
    picked = torch.where(ok, picked, 0.0)
    partial = [Partial() if i in vocab else p for i, p in enumerate(pl)]
    return DTensor.from_local(picked, mesh, partial, run_check=False).redistribute(mesh, pl)


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    """``argmax`` over the last dim. For a DTensor, whose vocab dim may be
    sharded, the first index of the maximum from ``amax`` and ``amin``
    (equal to ``argmax`` for finite logits): DTensor's own ``argmax``
    reads a shard's offset as a data-dependent value, which fake tensors
    cannot give."""
    if not is_dtensor(logits):
        return logits.argmax(-1)
    v = logits.shape[-1]
    top = logits.amax(dim=-1, keepdim=True)
    idx = torch.arange(v, device=logits.device)
    return torch.where(logits == top, idx, v).amin(dim=-1)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """Masked causal-LM cross entropy over f32 logits, for one model (no
    replica dim): ``tokens``/``targets`` (B, S), ``sample_mask`` (B,), and
    ``frames`` or ``patch_embeds`` (B, F, Fd) for a frontend. Returns (loss
    + router_aux_coef * moe_aux, aux) with aux = accuracy, n_valid (live
    samples), moe_aux and ce_loss."""
    memory = _memory(cfg, params, batch)
    x, n_vis = _embed_inputs(cfg, params, batch)
    x = shard(x, "replica", "batch", "seq", None)
    # a padded row's loss is masked: a dropless MoE layer skips its experts
    valid = batch["sample_mask"].bool() if is_mla(cfg) else None
    x, moe_aux = _trunk(cfg, params, x, memory, valid)
    if n_vis:
        x = x[:, n_vis:]
    logits = _logits(cfg, params, x)
    tgt = batch["targets"].long()
    nll = -_target_logp(logits, tgt)                                     # (B, S)
    smask = batch["sample_mask"].float()[:, None]
    n_valid = smask.sum() * tgt.shape[1]
    loss = (nll * smask).sum() / n_valid.clamp_min(1.0)
    acc = ((_argmax(logits) == tgt) * smask).sum() / n_valid.clamp_min(1.0)
    total = loss + cfg.router_aux_coef * moe_aux
    return total, {"accuracy": acc, "n_valid": smask.sum(), "moe_aux": moe_aux,
                   "ce_loss": loss}


@torch.no_grad()
def prefill(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Full-sequence forward over ``batch["tokens"]`` (B, S) (and the
    frontend's ``frames`` or ``patch_embeds``), returning the last
    position's logits (B, 1, V) in f32. Refuses a latent-attention config
    (``refuse_mla``)."""
    refuse_mla(cfg, "prefill")
    memory = _memory(cfg, params, batch)
    x, _ = _embed_inputs(cfg, params, batch)
    x, _ = _trunk(cfg, params, x, memory)
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
    is a Python int: the number of tokens the cache holds. With an encoder,
    ``cross_kv`` holds one (B, frontend_len, Hkv, hd) K/V pair of zeros a
    decoder layer, as in the reference, where nothing writes it. Refuses a
    latent-attention config (``refuse_mla``)."""
    refuse_mla(cfg, "decoding")
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
    if cfg.encoder_layers > 0:
        shape = (batch, cfg.frontend_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["cross_kv"] = [
            {"k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
             "v": torch.zeros(shape, dtype=_dtype(cfg), device=device)}
            for _ in range(cfg.n_layers)
        ]
    return cache


def _decode_sublayers(cfg: ModelConfig, kind: str, ffn_kind: str, params: dict,
                      x: torch.Tensor, cache: dict, cur_len: int, window: int,
                      cross: Optional[tuple] = None):  # (cross_params, cross_kv_cache)
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
    if cross is not None:
        cp, ckv = cross
        x, _, _ = L.decode_attention(
            cp, x, ckv["k"], ckv["v"], cur_len, n_rep=cfg.n_heads // cfg.n_kv_heads,
            rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps, cross=True,
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
    refuse_mla(cfg, "decoding")
    pattern = layer_pattern(cfg)
    prefix, period = find_prefix_period(pattern)
    cur = cache["cur_len"]

    def cross(i):
        if cfg.encoder_layers == 0:
            return None
        return params["cross"][i], cache["cross_kv"][i]

    x = L.residual(L.embed(params["embed"], tokens))
    for i in range(prefix):
        x = _decode_sublayers(cfg, *pattern[i], params["prefix"][i], x,
                              cache["prefix"][i], cur, window, cross(i))
    for g in range(_n_groups(cfg, prefix, period)):
        for j in range(period):
            x = _decode_sublayers(cfg, *pattern[prefix + j],
                                  _group(params["blocks"][f"pos{j}"], g), x,
                                  _group(cache["blocks"][f"pos{j}"], g), cur, window,
                                  cross(prefix + g * period + j))
    cache["cur_len"] = cur + 1
    return _logits(cfg, params, x), cache


# --------------------------------------------------------------------------
# trainer-protocol bundle
# --------------------------------------------------------------------------


def make_model(cfg: ModelConfig, buffers: Optional[dict] = None) -> TrainableModel:
    """The LM as the trainer takes it: parameters as a flat dict keyed by
    path (``utils.tree.flatten``), so the trainer, the SGD update and the
    merge see one leaf per stacked tensor. ``loss_fn`` takes one model and
    (B, S) batches, or replica-stacked (R, ...) leaves and (R, B, S)
    batches and returns (R,) loss and aux: a loop over the replicas, each
    on views of its leaves and of every batch field, the frontend's
    ``frames`` or ``patch_embeds`` (R, B, F, Fd) among them (the MoE
    dispatch's data-dependent sort and ``index_put`` do not vectorize). No ``sparse_grad_fn``: the trainer
    takes dense autograd, as the reference does for the LM. Refuses a
    config with a kernel flag on (``refuse_kernel_flags``).

    ``buffers`` (flat, keyed like the parameters): fixed tensors the loss
    reads beside the trained leaves, shared by every replica and copied to
    the batch's device once (``init_buffers``; for a latent-attention
    config drawn from seed 0 when not given)."""
    refuse_kernel_flags(cfg)
    if buffers is None:
        buffers = init_buffers(cfg, torch.Generator().manual_seed(0))
    placed: dict = {}

    def fixed(device) -> dict:
        if device not in placed:
            placed[device] = {k: v.to(device) for k, v in buffers.items()}
        return placed[device]

    def init_flat(generator: torch.Generator) -> dict:
        return tu.flatten(init(cfg, generator))

    def flat_loss(flat: dict, batch: dict):
        extra = fixed(batch["tokens"].device)
        if batch["tokens"].ndim == 2:
            return loss_fn(cfg, tu.unflatten({**flat, **extra}), batch)
        views = {k: v.unbind(0) for k, v in flat.items()}
        outs = [loss_fn(cfg, tu.unflatten({**{k: v[r] for k, v in views.items()}, **extra}),
                        {k: v[r] for k, v in batch.items()})
                for r in range(batch["tokens"].shape[0])]
        return (torch.stack([loss for loss, _ in outs]),
                {k: torch.stack([aux[k] for _, aux in outs]) for k in outs[0][1]})

    return TrainableModel(init=init_flat, loss_fn=flat_loss, config=cfg)

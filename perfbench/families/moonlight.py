"""Moonlight-16B-A3B (``repro_torch``'s latent-attention config,
``configs/moonlight_16b_a3b.py``) as a model family of the benchmark: what
the generic harness (``harness.py``) and ``control.py`` need of a model,
under the names ``spec.family`` checks.

The configuration file holds the source's ``config.json`` keys (the
catalog's), cut as its ``reduced`` lists; ``router_experts`` is the
router's published width and ``n_routed_experts`` the experts this card
holds, from ``first_expert``.

* ``pools``: the token streams (``traffic/lm_tokens.py``: sequence j from
  the seed and j alone) and the fixed selection biases, drawn on the card;
* ``weights``: the initial weights in the program's flat layout;
* ``build``: the program, an ``ElasticTrainer`` over ``TokenProvider``;
* ``fetched_samples``, ``model_flops``, ``launches``: sequences, FLOPs, and
  the recorded calls of the attention and of the held experts' products
  (``roofline_pct.mla_attention``, ``roofline_pct.moe_experts``);
* ``update_units``, ``reference``, ``replay``, ``FAULTS``: the plain
  reference (``reference/moonlight.py``).
"""
from __future__ import annotations

import functools
import math
from dataclasses import replace

import torch

from perfbench.reference import moonlight as ref
from perfbench.traffic import lm_tokens

update_units = ref.unit_norms
reference = ref.train
replay = ref.replay_decisions
FAULTS = ref.FAULTS


def model_config(config: dict):
    """The program's ``MLAMoEConfig`` of the configuration file."""
    from repro_torch.configs.moonlight_16b_a3b import MOONLIGHT_16B_A3B

    return replace(
        MOONLIGHT_16B_A3B,
        name=config["name"],
        n_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        d_ff=config["moe_intermediate_size"],
        dense_d_ff=config["intermediate_size"],
        vocab_size=config["vocab_size"],
        n_experts=config["router_experts"],
        experts_held=config["n_routed_experts"],
        first_expert=config["first_expert"],
        top_k=config["num_experts_per_tok"],
        n_dense_layers=config["first_k_dense_replace"],
        kv_lora_rank=config["kv_lora_rank"],
        qk_nope_head_dim=config["qk_nope_head_dim"],
        qk_rope_head_dim=config["qk_rope_head_dim"],
        v_head_dim=config["v_head_dim"],
        n_shared_experts=config["n_shared_experts"],
        routed_scaling_factor=config["routed_scaling_factor"],
        norm_topk_prob=config["norm_topk_prob"],
        router_scoring=config["scoring_func"],
        rope_theta=float(config["rope_theta"]),
        norm_eps=config["rms_norm_eps"],
        score_bias_std=config["score_bias_std"],
        dtype=config["dtype"],
    )


def shapes(config: dict) -> dict:
    """{flat key: (shape, fan_in or 0 for a gain, dtype)} of the program's
    parameters (``models/model.py`` ``init``): the dense layers under
    ``prefix.{i}``, the MoE layers stacked under ``blocks.pos0``."""
    d, h, v = config["hidden_size"], config["num_attention_heads"], config["vocab_size"]
    rank, nope = config["kv_lora_rank"], config["qk_nope_head_dim"]
    rope, vd = config["qk_rope_head_dim"], config["v_head_dim"]
    f, fd, eh = config["moe_intermediate_size"], config["intermediate_size"], \
        config["n_routed_experts"]
    fs = config["n_shared_experts"] * f
    dt, f32 = config["dtype"], "float32"
    n_dense = config["first_k_dense_replace"]
    groups = config["num_hidden_layers"] - n_dense

    def mixer(pre, g=()):
        return {
            f"{pre}.mixer.wq": (g + (d, h, nope + rope), d, dt),
            f"{pre}.mixer.wkv_a": (g + (d, rank + rope), d, dt),
            f"{pre}.mixer.kv_norm": (g + (rank,), 0, dt),
            f"{pre}.mixer.wkv_b": (g + (rank, h, nope + vd), rank, dt),
            f"{pre}.mixer.wo": (g + (h, vd, d), h * vd, dt),
            f"{pre}.mixer.norm": (g + (d,), 0, dt),
        }

    out = {"embed.table": ((v, d), d, dt)}
    for i in range(n_dense):
        out.update(mixer(f"prefix.{i}"))
        out.update({f"prefix.{i}.ffn.wi": ((d, fd), d, dt), f"prefix.{i}.ffn.wg": ((d, fd), d, dt),
                    f"prefix.{i}.ffn.wo": ((fd, d), fd, dt), f"prefix.{i}.ffn.norm": ((d,), 0, dt)})
    g = (groups,)
    out.update(mixer("blocks.pos0", g))
    out.update({
        "blocks.pos0.ffn.router": (g + (d, config["router_experts"]), d, f32),
        "blocks.pos0.ffn.wi": (g + (eh, d, f), d, dt),
        "blocks.pos0.ffn.wg": (g + (eh, d, f), d, dt),
        "blocks.pos0.ffn.wo": (g + (eh, f, d), f, dt),
        "blocks.pos0.ffn.norm": (g + (d,), 0, dt),
        "blocks.pos0.ffn.shared.wi": (g + (d, fs), d, dt),
        "blocks.pos0.ffn.shared.wg": (g + (d, fs), d, dt),
        "blocks.pos0.ffn.shared.wo": (g + (fs, d), fs, dt),
    })
    out["final_norm"] = ((d,), 0, dt)
    out["lm_head"] = ((v, d), d, dt)
    return out


def weights(config: dict, seed: int, device) -> dict:
    """The initial weights on ``device``, flat as the program keeps them:
    normal with std 1/sqrt(fan_in), the norms' gains 0, in the
    configuration's dtype (the router in f32), drawn in f32 by a generator
    on that device in one call a leaf. The same seed and device give the
    same weights bit for bit."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, (shape, fan_in, dt) in shapes(config).items():
        if fan_in:
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            out[k] = w.mul_(1.0 / math.sqrt(fan_in)).to(getattr(torch, dt))
        else:
            out[k] = torch.zeros(shape, dtype=getattr(torch, dt), device=device)
    return out


def biases(config: dict, seed: int, device) -> dict:
    """Each MoE layer's fixed selection bias over the router's experts,
    normal at ``score_bias_std``, f32, from the seed (its own generator):
    flat, ``blocks.pos0.ffn.score_bias`` (layers, experts)."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    groups = config["num_hidden_layers"] - config["first_k_dense_replace"]
    b = torch.randn((groups, config["router_experts"]), generator=gen, device=device)
    return {"blocks.pos0.ffn.score_bias": b * config["score_bias_std"]}


def pools(config: dict, seed: int, device):
    """(train, test): the training stream's seed and the biases, which
    the program and the reference share, and the held-out stream's."""
    train = {"config": config, "seed": seed, "biases": biases(config, seed, device)}
    return train, {"config": config, "seed": seed, "stream": 1}


def build(config: dict, traffic: dict, seed: int, devices: tuple, train: dict, test: dict):
    """The program: an ``ElasticTrainer`` over ``TokenProvider``, its
    provider, and the held-out batches it evaluates."""
    from repro_torch.configs.base import ElasticConfig
    from repro_torch.core.heterogeneity import MeasuredSpeedModel, SpeedModel
    from repro_torch.core.trainer import ElasticTrainer
    from repro_torch.data.providers import TokenProvider
    from repro_torch.models import model as MDL
    from repro_torch.models.protocol import TrainableModel

    v, s_len, b_max, R = config["vocab_size"], traffic["seq_len"], traffic["b_max"], \
        traffic["replicas"]
    provider = TokenProvider(lm_tokens.UniformTokens(v, seed, 0), s_len)
    held_out = TokenProvider(lm_tokens.UniformTokens(v, seed, test["stream"]), s_len)
    test_batches = held_out.test_batches(traffic["test_batches"], b_max)
    cfg = model_config(config)
    base = MDL.make_model(cfg, buffers=train["biases"])
    # the weights the benchmark draws on the first card, not the program's
    # CPU draw: the reference gets the same
    model = TrainableModel(init=lambda _generator: weights(config, seed, devices[0]),
                           loss_fn=base.loss_fn, config=cfg)
    ecfg = ElasticConfig.from_bmax(b_max, algorithm=traffic["algorithm"], n_replicas=R,
                                   mega_batch=traffic["mega_batch"],
                                   placement=traffic["placement"])
    speed = (MeasuredSpeedModel(R) if traffic["speed"] == "measured"
             else SpeedModel(R, max_gap=traffic["max_gap"], seed=seed))
    trainer = ElasticTrainer(
        model=model, provider=provider, cfg=ecfg, base_lr=traffic["lr"], speed=speed,
        seed=seed, device=devices[0], sparse_grads=traffic["sparse_grads"],
        overlap=traffic["overlap"],
        mesh=devices if traffic["placement"] == "sharded" else None,
    )
    return trainer, provider, test_batches


def fetched_samples(payload, staged: bool) -> int:
    """The sequences of one fetch."""
    return int(payload["sample_mask"].sum())


def forward_flops_per_token(config: dict, seq_len: int) -> float:
    """Forward FLOPs a token: 2 x the weights a token multiplies (the held
    experts at their expected share, 6 of 64 selections over the 8 held of
    64) and causal attention over an average seq_len / 2 keys."""
    d, h, v = config["hidden_size"], config["num_attention_heads"], config["vocab_size"]
    rank, nope = config["kv_lora_rank"], config["qk_nope_head_dim"]
    rope, vd = config["qk_rope_head_dim"], config["v_head_dim"]
    f, fd = config["moe_intermediate_size"], config["intermediate_size"]
    n_dense = config["first_k_dense_replace"]
    n_moe = config["num_hidden_layers"] - n_dense
    held = config["num_experts_per_tok"] * config["n_routed_experts"] / config["router_experts"]
    mla = d * h * (nope + rope) + d * (rank + rope) + rank * h * (nope + vd) + h * vd * d
    attn = seq_len / 2 * h * (nope + rope + vd)
    moe = d * config["router_experts"] + 3 * d * f * (held + config["n_shared_experts"])
    per_layer = config["num_hidden_layers"] * (mla + attn)
    return 2.0 * (per_layer + n_dense * 3 * d * fd + n_moe * moe + d * v)


def model_flops(config: dict, n_samples: int, work: int) -> float:
    """Forward and backward (3x forward; no recomputed work) of the
    ``work`` tokens of ``n_samples`` sequences."""
    seq_len = work // max(n_samples, 1)
    return 3.0 * work * forward_flops_per_token(config, seq_len)


def _in_backward() -> bool:
    """Whether autograd's engine is running this call: a checkpointed
    layer's recompute."""
    return torch._C._current_graph_task_id() != -1


def _attention(orig, rec):
    @functools.wraps(orig)
    def run(q, k, v, scale):
        if rec.recording:
            rec.launches["mla_attention"].append(
                (tuple(q.shape), v.shape[-1], torch.is_grad_enabled(), _in_backward()))
        return orig(q, k, v, scale)
    return run


def _experts(orig, rec):
    @functools.wraps(orig)
    def run(x, wi, wg, wo, counts, sizes):
        if rec.recording:
            rec.launches["moe_experts"].append(
                (x.shape[0], x.shape[1], wi.shape[-1], wi.shape[0], x.element_size(),
                 torch.is_grad_enabled(), _in_backward()))
        return orig(x, wi, wg, wo, counts, sizes)
    return run


def launches() -> dict:
    """{name: (module, attribute, wrap)}: the calls the rooflines read. An
    attention call records q's shape and v's head dim; an experts call its
    rows, D, F, held experts and element size; both whether autograd
    records it and whether it is a checkpoint's recompute."""
    return {"mla_attention": ("repro_torch.models.layers", "mla_attention", _attention),
            "moe_experts": ("repro_torch.models.moe", "grouped_swiglu", _experts)}

"""A plain PyTorch reference of the latent-attention config
(``repro_torch/configs/moonlight_16b_a3b.py``): the forward and loss of
Moonlight-16B-A3B's layers, in f32, for the port's CPU tests
(``tests/test_torch_moonlight.py``). Torch only: it imports nothing of the
port, of JAX or of the JAX package, which has no such model. The
benchmark's copy, with its Adaptive SGD training, is
``perfbench/reference/moonlight.py``.

The layers are HF ``deepseek_v3``'s (the source's ``model_type``); the
constants come from a dict of the source's ``config.json`` keys
(``first_expert`` the first expert held). Departures from HF
``deepseek_v3``, each also the port's:

* no auxiliary loss: HF's forward computes none, and the bias's balancing
  update (``noaux_tc``'s) is outside the model, so the bias
  ``e_score_correction_bias`` is fixed;
* RoPE in HF's interleaved pair layout: the pairs (x[2i], x[2i+1]) rotate
  and are laid out as [evens, odds], as HF's ``view(..., d // 2, 2)
  .transpose`` does;
* the RMSNorm gains are stored as g with the scale 1 + g; the latent's
  norm takes eps 1e-6, the default of HF's ``kv_a_layernorm``;
* an expert-parallel share: only the held experts' outputs are summed,
  their weights normalised over every selected expert.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

KV_NORM_EPS = 1e-6
FP8_MAX = 448.0


class Model:
    """The constants the forward reads, from the configuration file (the
    source's ``config.json`` keys; ``first_expert`` the first held)."""

    def __init__(self, config: dict, fault: str | None = None, fp8: bool = False):
        self.heads = config["num_attention_heads"]
        self.rank = config["kv_lora_rank"]
        self.nope, self.rope = config["qk_nope_head_dim"], config["qk_rope_head_dim"]
        self.v = config["v_head_dim"]
        self.top_k = config["num_experts_per_tok"]
        self.scale = config["routed_scaling_factor"]
        self.first = config["first_expert"]
        self.theta = float(config["rope_theta"])
        self.eps = config["rms_norm_eps"]
        self.fault, self.fp8 = fault, fp8
        if fault == "unscaled":
            self.scale = 1.0

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = _fp8(a), _fp8(b)
        return a @ b


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at the scale of its largest magnitude; the
    gradient passes through unchanged."""
    s = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return x + ((x / s).to(torch.float8_e4m3fn).float() * s - x).detach()


def rmsnorm(x, g, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * (1.0 + g)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, ..., d): HF's interleaved pairs, rotated, laid out [evens, odds]."""
    s, d = x.shape[0], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs   # (S, d/2)
    ang = ang.view(s, *([1] * (x.ndim - 2)), d // 2)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.cat([x1 * ang.cos() - x2 * ang.sin(), x2 * ang.cos() + x1 * ang.sin()], dim=-1)


def attention(m: Model, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x + the latent-attention sublayer, x (S, D)."""
    s, d = x.shape
    h = rmsnorm(x, p["norm"], m.eps)
    q = m.mm(h, p["wq"].reshape(d, -1)).view(s, m.heads, m.nope + m.rope)
    ckv = m.mm(h, p["wkv_a"])
    c, k_pe = ckv[:, :m.rank], ckv[:, m.rank:]
    if m.fault != "no_kv_norm":
        c = rmsnorm(c, p["kv_norm"], KV_NORM_EPS)
    kv = m.mm(c, p["wkv_b"].reshape(m.rank, -1)).view(s, m.heads, m.nope + m.v)
    k_nope, v = kv[..., :m.nope], kv[..., m.nope:]
    q = torch.cat([q[..., :m.nope], rope(q[..., m.nope:], m.theta)], dim=-1)
    k_pe = rope(k_pe, m.theta)[:, None, :].expand(s, m.heads, m.rope)
    k = torch.cat([k_nope, k_pe], dim=-1)
    scores = m.mm(q.transpose(0, 1), k.permute(1, 2, 0)) / (m.nope + m.rope) ** 0.5  # (H,S,S)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = m.mm(probs, v.transpose(0, 1)).transpose(0, 1).reshape(s, -1)             # (S, H*v)
    return x + m.mm(o, p["wo"].reshape(-1, d))


def swiglu(m: Model, h, wi, wg, wo):
    return m.mm(F.silu(m.mm(h, wg)) * m.mm(h, wi), wo)


def dense(m: Model, p: dict, x: torch.Tensor) -> torch.Tensor:
    return x + swiglu(m, rmsnorm(x, p["norm"], m.eps), p["wi"], p["wg"], p["wo"])


def route(m: Model, router, bias, h):
    """(weights, ids) (S, k) of the sigmoid router; a fault changes it."""
    logits = m.mm(h, router)
    s = torch.softmax(logits, dim=-1) if m.fault == "softmax_router" else torch.sigmoid(logits)
    ids = torch.topk(s if m.fault == "no_bias" else s + bias, m.top_k, dim=-1).indices
    w = s.gather(-1, ids)
    return w / (w.sum(dim=-1, keepdim=True) + 1e-20) * m.scale, ids


def moe(m: Model, p: dict, bias, x: torch.Tensor) -> torch.Tensor:
    """x + the MoE sublayer: the held experts a token selected, one expert
    at a time, and the shared experts."""
    h = rmsnorm(x, p["norm"], m.eps)
    w, ids = route(m, p["router"], bias, h)
    y = torch.zeros_like(h)
    for e in range(p["wi"].shape[0]):
        tok, slot = torch.nonzero(ids == m.first + e, as_tuple=True)
        if len(tok):
            out = swiglu(m, h[tok], p["wi"][e], p["wg"][e], p["wo"][e])
            y = y.index_add(0, tok, w[tok, slot][:, None] * out)
    if m.fault != "no_shared_experts":
        y = y + swiglu(m, h, p["shared.wi"], p["shared.wg"], p["shared.wo"])
    return x + y


def layers(w: dict) -> list:
    """Each layer's {name: tensor} in order: the unstacked ``prefix``
    layers, then each group of the stacked ``blocks.pos0`` layers."""
    out = []
    prefix = sorted({int(k.split(".")[1]) for k in w if k.startswith("prefix.")})
    for i in prefix:
        pre = f"prefix.{i}."
        out.append({k[len(pre):]: v for k, v in w.items() if k.startswith(pre)})
    pre = "blocks.pos0."
    stacked = {k[len(pre):]: v for k, v in w.items() if k.startswith(pre)}
    for g in range(next(iter(stacked.values())).shape[0] if stacked else 0):
        out.append({k: v[g] for k, v in stacked.items()})
    return out


def sequence_nll(m: Model, w: dict, biases: list, tokens, targets) -> torch.Tensor:
    """The summed -log p of one sequence's targets, f32."""
    x = w["embed.table"][tokens.long()]
    for p, bias in zip(layers(w), biases):
        x = attention(m, {k[6:]: v for k, v in p.items() if k.startswith("mixer.")}, x)
        ffn = {k[4:]: v for k, v in p.items() if k.startswith("ffn.")}
        x = dense(m, ffn, x) if bias is None else moe(m, ffn, bias, x)
    logits = m.mm(rmsnorm(x, w["final_norm"], m.eps), w["lm_head"].T)
    return -torch.log_softmax(logits, dim=-1).gather(-1, targets.long()[:, None]).sum()


def layer_biases(bias: dict, w: dict) -> list:
    """Each layer's selection bias in ``layers(w)``'s order: None for the
    leading dense layers (``prefix``), then the MoE layers' rows of the
    stacked ``blocks.pos0.ffn.score_bias``."""
    stacked = bias["blocks.pos0.ffn.score_bias"]
    return [None] * (len(layers(w)) - len(stacked)) + list(stacked.unbind(0))

"""Plain PyTorch training of the cut Moonlight-16B-A3B (the benchmark's
``moonlight-16b-a3b`` configuration) under Adaptive SGD.

The reference the benchmark holds ``repro_torch`` to. It imports nothing of
the program. Weights are the flat dict the benchmark draws
(``families/moonlight.py``: ``prefix.0.*`` the dense layer, ``blocks.pos0.*``
the MoE layers stacked on a leading dim), stored in the configuration's
dtype (bf16); every product is computed in f32 from them, one sequence at a
time (the program's state is freed first; a sequence's f32 activations,
attention scores included, fit beside the replicas).

The layers (HF ``deepseek_v3``'s modeling, ``model_type`` of the source):

* RMSNorm x / sqrt(mean x^2 + eps) (1 + g), eps 1e-5 before each sublayer;
* latent attention: q = W_q h per head as [q_nope, q_pe]; [c, k_pe] =
  W_kva h; c = RMSNorm(c) (eps 1e-6, the default of HF's
  ``kv_a_layernorm``); [k_nope, v] = W_kvb c per head; RoPE on q_pe and on
  the one k_pe every head shares; softmax((q k^T) / sqrt(192)) causal,
  then W_o;
* the router in f32: s = sigmoid(h W_r) over all 64 experts; the top 6 of
  s + b; weights s_sel / (sum s_sel + 1e-20) * 2.446 over all 6 selected;
* y = sum over the selected experts this card holds of w_i SwiGLU_i(h),
  plus the shared experts' SwiGLU (width 2 x 1,408); the first layer a
  dense SwiGLU of 11,264;
* the loss: cross entropy of f32 logits (untied head), the mean over the
  valid sequences' tokens.

Departures from HF ``deepseek_v3`` (each also the program's):

* no auxiliary loss: HF's forward computes none, and the bias's balancing
  update (``noaux_tc``'s) is outside the model and not in the
  configuration, so the bias ``e_score_correction_bias`` is fixed, drawn
  from the seed;
* RoPE in HF's interleaved pair layout: the pairs (x[2i], x[2i+1]) rotate
  by position * theta^(-2i/64) and are laid out as [evens, odds], as HF's
  ``view(..., d // 2, 2).transpose`` does; q and k alike, so their
  products are those of an in-place rotation;
* the RMSNorm gains are stored as g with the scale 1 + g (HF stores 1 + g);
* the card's share: only the held experts' outputs are summed, their
  weights normalised over all 6 selected.

Training is ``mlp.py``'s: Algorithm 1 and 2's host decisions from
``host.Replay`` (every sample is one sequence of ``seq_len`` work units),
plain SGD per replica and batch in f32 from the stored weights, rounded to
the stored dtype after each step, the non-finite guard, and the f32 merge.

``fault`` plants one of the faults ``control.py`` runs (``FAULTS``). Where
``control.py`` asks for its control (``torch.backends.cuda.matmul
.allow_tf32`` on), the configuration's dtype being bf16, the reference
computes in the precision below it: the inputs of every product rounded to
float8 e4m3, each tensor scaled by its largest magnitude (the f32 products
themselves run with TF32 off either way).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.traffic import lm_tokens

from . import host
from .check import Trajectory, leaf_norms, weight_sum
from .mlp import finite, merge

# each fault, and the fewest shards a cell needs for it to differ
FAULTS = {"softmax_router": 1, "no_bias": 1, "no_shared_experts": 1, "unscaled": 1,
          "no_kv_norm": 1}
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


def sgd_step(m: Model, rep: dict, biases: list, seqs: list, lr: float) -> float:
    """One SGD step of one replica on one batch (``seqs``: its valid
    sequences), in place: the mean loss over their tokens, each sequence's
    gradient accumulated in f32, then w <- w - lr g rounded to w's dtype."""
    leaves = {k: v.to(torch.float32, copy=True).requires_grad_(True) for k, v in rep.items()}
    n_tok = sum(len(t) for t, _ in seqs)
    total = 0.0
    for tokens, targets in seqs:
        loss = sequence_nll(m, leaves, biases, tokens, targets) / n_tok
        loss.backward()
        total += loss.item()
    with torch.no_grad():
        for k, v in rep.items():
            if leaves[k].grad is not None:    # a fault may leave a leaf out of the loss
                v.copy_(leaves[k] - lr * leaves[k].grad)
    return total


# the model's units of ``update1_units``: a head's slices (layer, head dim)
HEAD_LEAVES = {"mixer.wq": -2, "mixer.wkv_b": -2, "mixer.wo": 0}
EXPERT_LEAVES = ("ffn.wi", "ffn.wg", "ffn.wo")


def unit_norms(tree: dict, base: dict, scale: float = 1.0) -> list:
    """The norm of ``tree - scale * base`` by unit, in f64: by attention
    head of every layer (its columns of W_q and W_kvb, its rows of W_o),
    then by held expert of every MoE layer (its W_i, W_g, W_o)."""
    diff = {k: tree[k].double() - scale * base[k].double() for k in tree}
    heads, experts = [], []
    for p in layers(diff):
        sq = 0.0
        for k, dim in HEAD_LEAVES.items():
            d = p[k].movedim(dim % p[k].ndim, 0)
            sq = sq + d.square().flatten(1).sum(dim=1)
        heads += sq.sqrt().tolist()
        if "ffn.router" in p:
            experts += sum(p[k].square().flatten(1).sum(dim=1) for k in EXPERT_LEAVES) \
                .sqrt().tolist()
    return heads + experts


class _Drawn:
    """``host.Replay``'s sample stream where a sample is the next sequence
    drawn: the j-th id is the j-th sequence the program fetched."""

    def __init__(self):
        self.n = 0

    def take(self, k: int) -> np.ndarray:
        out = np.arange(self.n, self.n + k)
        self.n += k
        return out


def _replay(traffic: dict, seed: int, n_megabatches: int, readings) -> host.Replay:
    """``host.Replay`` for sequences: every sample ``seq_len`` work units,
    ids in the order drawn."""
    s = int(traffic["seq_len"])
    n = (n_megabatches + 2) * int(traffic["mega_batch"]) * int(traffic["b_max"])
    indptr = np.arange(n + 1, dtype=np.int64) * s
    replay = host.Replay(traffic, indptr, np.arange(n + 1, dtype=np.int64), seed, readings)
    replay.stream = _Drawn()
    return replay


def train(w0: dict, pool: dict, traffic: dict, seed: int, n_megabatches: int,
          readings: list | None = None, n_shards: int = 1, fault: str | None = None
          ) -> Trajectory:
    """The first ``n_megabatches`` mega-batches of Adaptive SGD from the
    weights ``w0`` on the training ``pool`` (``families/moonlight.py``'s:
    the configuration, the seed of the token stream and the selection
    biases)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {', '.join(FAULTS)}")
    config = pool["config"]
    fp8 = bool(torch.backends.cuda.matmul.allow_tf32) and config["dtype"] == "bfloat16"
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _train(Model(config, fault, fp8), w0, pool, traffic, seed, n_megabatches,
                      readings)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _train(m: Model, w0, pool, traffic, seed, n_megabatches, readings) -> Trajectory:
    config, device = pool["config"], w0["embed.table"].device
    s_len = int(traffic["seq_len"])
    biases = [None if b is None else b.to(device).float()
              for b in layer_biases(pool["biases"], w0)]
    replay = _replay(traffic, seed, n_megabatches, readings)
    R = replay.R
    reps = [{k: v.clone() for k, v in w0.items()} for _ in range(R)]
    glob, prev = w0, w0
    n_param = sum(v.numel() for v in w0.values())
    out = Trajectory()
    for k in range(n_megabatches):
        plan, b, lr, b_next, lr_next = replay.step()
        lr32 = torch.as_tensor(lr, dtype=torch.float32)
        round_losses = []
        for row in plan.grid:
            losses = []
            for i, ids in enumerate(row):
                if ids is None:
                    continue
                seqs = []
                for j in ids:
                    t = torch.from_numpy(lm_tokens.sequence(config["vocab_size"], s_len,
                                                            pool["seed"], 0, int(j))).to(device)
                    seqs.append((t[:-1], t[1:]))
                losses.append(sgd_step(m, reps[i], biases, seqs, lr32[i].item()))
            round_losses.append(float(np.mean(np.float64(losses))))
        ok = [finite(rep) for rep in reps]
        if not all(ok):
            if not any(ok):
                reps = [{k: v.clone() for k, v in glob.items()} for _ in range(R)]
            else:
                wts = np.where(ok, b, 0.0)
                donor = merge([rep for rep, good in zip(reps, ok) if good],
                              (wts / wts.sum())[np.asarray(ok)], glob, glob)
                reps = [rep if good else {k: v.clone() for k, v in donor.items()}
                        for rep, good in zip(reps, ok)]
        norms = np.array([np.sqrt(sum(torch.linalg.vector_norm(
            v, dtype=torch.float64).item() ** 2 for v in rep.values())) for rep in reps])
        alphas = host.merge_weights(plan.u, b, norms / n_param)
        new = merge(reps, alphas, glob, prev)
        prev, glob = glob, new
        reps = [{k: v.clone() for k, v in new.items()} for _ in range(R)]
        out.losses.append(float(np.mean(round_losses)))
        out.decisions.append(dict(u=plan.u.tolist(), n_rounds=plan.n_rounds,
                                  b=b_next.tolist(), lr=lr_next.tolist(),
                                  alphas=np.round(alphas, 4).tolist()))
        if k == 0:
            out.update1 = leaf_norms(glob, w0, weight_sum(alphas))
            out.update1_units = unit_norms(glob, w0, weight_sum(alphas))
    out.change = leaf_norms(glob, w0)
    return out


def replay_decisions(pool: dict, traffic: dict, seed: int, n_megabatches: int,
                     readings: list | None = None) -> list:
    """The host decisions of the first ``n_megabatches`` mega-batches, with
    no device work."""
    replay = _replay(traffic, seed, n_megabatches, readings)
    out = []
    for _ in range(n_megabatches):
        plan, _, _, b_next, lr_next = replay.step()
        out.append(dict(u=plan.u.tolist(), n_rounds=plan.n_rounds, b=b_next.tolist(),
                        lr=lr_next.tolist()))
    return out

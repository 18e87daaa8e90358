"""--arch moonlight-16b-a3b: Moonlight-16B-A3B at its published widths.

A port-only configuration (the JAX reference has no latent attention, no
sigmoid router and no shared experts), so it lives outside ``ARCHS``, which
stays the reference's field for field. ``ARCH_TABLE`` is ``ARCHS`` plus the
port-only entries; ``arch(name)`` looks a name up in it (``launch/train.py
--arch``).

Source: https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json
(``model_type`` deepseek_v3): 27 layers, the first dense; latent attention
(``kv_lora_rank`` 512, no query compression, q/k heads of 128 + 64 rotary
dims, v heads of 128, 16 heads); 64 routed experts of 1,408, 6 a token, 2
shared; sigmoid ``noaux_tc`` routing with one group, ``norm_topk_prob``,
``routed_scaling_factor`` 2.446; vocabulary 163,840, untied; bf16.

The new fields:

* ``kv_lora_rank``, ``qk_nope_head_dim``, ``qk_rope_head_dim``,
  ``v_head_dim``: the latent attention (``models/layers.py``
  ``mla_layer``); every layer's mixer is ``"mla"``.
* ``dense_d_ff``: the width of the dense layers (the first
  ``n_dense_layers``); ``d_ff`` is an expert's.
* ``n_shared_experts``: shared experts, one SwiGLU of ``n_shared_experts *
  d_ff`` as HF builds them.
* ``router_scoring`` ("sigmoid"), ``norm_topk_prob``,
  ``routed_scaling_factor``: the router (``models/moe.py``
  ``route_sigmoid``).
* ``experts_held``, ``first_expert``: the routed experts this card holds,
  ``[first_expert, first_expert + experts_held)`` of ``n_experts`` (the
  expert-parallel share; 0 holds all). The router scores all
  ``n_experts``.
* ``dropless``: every (token, held expert) pair is computed (no capacity
  buffer).
* ``score_bias_std``: the scale the fixed selection bias
  (``e_score_correction_bias``) is drawn at (``models/model.py``
  ``init_buffers``); the bias is no trained leaf.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from .archs import ARCHS
from .base import ModelConfig


@dataclass(frozen=True)
class MLAMoEConfig(ModelConfig):
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    dense_d_ff: int = 0
    n_shared_experts: int = 0
    router_scoring: str = "sigmoid"
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    experts_held: int = 0
    first_expert: int = 0
    dropless: bool = True
    score_bias_std: float = 0.0

    def __post_init__(self):
        if self.use_flash_kernel:
            raise ValueError(
                f"{self.name}: use_flash_kernel on a latent-attention config, but "
                "kernels/flash_attention takes one head dim of at most 128 for q, k and v; "
                f"this one has q/k {self.qk_head_dim} and v {self.v_head_dim}")
        if self.use_gmm_kernel:
            raise ValueError(f"{self.name}: use_gmm_kernel, but kernels/moe_gmm runs a "
                             "capacity buffer; this config's experts are dropless")
        if not self.dropless:
            raise ValueError(f"{self.name}: dropless=False, but the sigmoid-routed layer "
                             "(models/moe.py moe_layer_dropless) has no capacity buffer")
        if self.router_scoring != "sigmoid":
            raise ValueError(f"router_scoring {self.router_scoring!r}: only 'sigmoid'")
        if self.first_expert + self.n_held > self.n_experts:
            raise ValueError(f"experts [{self.first_expert}, {self.first_expert + self.n_held})"
                             f" lie outside the {self.n_experts} routed experts")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def n_held(self) -> int:
        return self.experts_held or self.n_experts

    def layer_kind(self, i: int) -> str:
        return "mla"

    def reduced(self) -> "MLAMoEConfig":
        """Smoke-test variant: 3 layers (1 dense), small widths, 16 experts
        of width 24 (a held share of 4 where the config holds a share), top
        4, 2 shared, f32."""
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=3,
            d_model=64,
            n_heads=4,
            n_kv_heads=4,
            d_ff=24,
            dense_d_ff=96,
            vocab_size=256,
            n_experts=16,
            top_k=4,
            n_dense_layers=1,
            kv_lora_rank=32,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
            experts_held=4 if self.experts_held else 0,
            first_expert=4 * (self.first_expert // self.n_held) if self.experts_held else 0,
            dtype="float32",
        )


MOONLIGHT_16B_A3B = MLAMoEConfig(
    name="moonlight-16b-a3b",
    arch_type="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    n_experts=64,
    top_k=6,
    n_dense_layers=1,
    router_aux_coef=0.0,
    rope_theta=50000.0,
    norm_eps=1e-5,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    dense_d_ff=11264,
    n_shared_experts=2,
    routed_scaling_factor=2.446,
    norm_topk_prob=True,
    score_bias_std=0.05,
    source="[hf:moonshotai/Moonlight-16B-A3B]",
)

CONFIG = MOONLIGHT_16B_A3B

# the port-only entries, and the whole table ``--arch`` chooses from
PORT_ARCHS: dict[str, ModelConfig] = {MOONLIGHT_16B_A3B.name: MOONLIGHT_16B_A3B}
ARCH_TABLE: dict[str, ModelConfig] = {**ARCHS, **PORT_ARCHS}


def arch(name: str) -> ModelConfig:
    """``ARCHS[name]``, else the port-only entry of that name."""
    try:
        return ARCH_TABLE[name]
    except KeyError:
        raise KeyError(f"no architecture {name!r}; known: {', '.join(ARCH_TABLE)}") from None

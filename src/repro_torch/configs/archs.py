"""The 10 assigned architectures (exact specs from the assignment table) +
the paper's own XML-MLP workload configs.

Copied from ``repro/configs/archs.py``. Every entry cites its source.
``ARCHS[name]`` is the full production config; ``ARCHS[name].reduced()``
is the small smoke variant.
"""
from __future__ import annotations

from .base import ModelConfig

ARCHS: dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# -- hybrid: Mamba+attention 1:7 interleave, MoE every 2nd layer ------------
JAMBA_1_5_LARGE = _register(ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_period=8,      # 1 attention layer per 8 (1:7 mamba:attn interleave)
    attn_offset=4,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    replica_axis="pod",  # 398B: replica = a full pod (FSDP+EP inside)
    expert_parallel=True,
    fsdp=True,
    source="[arXiv:2403.19887]",
))

# -- audio enc-dec: transformer backbone only; conformer frontend stubbed ---
SEAMLESS_M4T_LARGE_V2 = _register(ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    n_layers=24,          # decoder layers
    encoder_layers=24,    # text/unit encoder over stub audio embeddings
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    frontend="audio",
    frontend_len=1152,    # precomputed speech frame embeddings (stub)
    frontend_dim=1024,
    source="[arXiv:2308.11596]",
))

# -- dense small llama2 ------------------------------------------------------
TINYLLAMA_1_1B = _register(ModelConfig(
    name="tinyllama-1.1b",
    arch_type="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    source="[arXiv:2401.02385]",
))

# -- moe: 128 experts top-2 with parallel dense residual branch -------------
ARCTIC_480B = _register(ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    dense_residual=True,
    dense_residual_ff=4864,
    replica_axis="pod",
    expert_parallel=True,
    fsdp=True,
    source="[hf:Snowflake/snowflake-arctic-base]",
))

# -- dense (MHA: kv == heads) -------------------------------------------------
STABLELM_1_6B = _register(ModelConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    source="[hf:stabilityai/stablelm-2-1_6b]",
))

# -- vlm: InternViT frontend stubbed; InternLM2 backbone ---------------------
INTERNVL2_2B = _register(ModelConfig(
    name="internvl2-2b",
    arch_type="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision",
    frontend_len=256,     # 448px tile -> 256 patch embeddings after pixel shuffle
    frontend_dim=1024,    # InternViT-300M width, projected to d_model
    source="[arXiv:2404.16821]",
))

# -- ssm: attention-free Mamba2 / SSD ----------------------------------------
MAMBA2_780M = _register(ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,               # attn-free, no separate FFN (Mamba2 block only)
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
    source="[arXiv:2405.21060]",
))

# -- dense small llama3 -------------------------------------------------------
LLAMA3_2_1B = _register(ModelConfig(
    name="llama3.2-1b",
    arch_type="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
    source="[hf:meta-llama/Llama-3.2-1B]",
))

# -- fine-grained MoE (Moonlight) ---------------------------------------------
MOONSHOT_V1_16B_A3B = _register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    arch_type="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    n_experts=64,
    top_k=6,
    n_dense_layers=1,     # moonlight: first layer dense
    source="[hf:moonshotai/Moonlight-16B-A3B]",
))

# -- trillion-param MoE (paper-table scale) -----------------------------------
KIMI_K2_1T_A32B = _register(ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    top_k=8,
    n_dense_layers=1,
    replica_axis="pod",
    expert_parallel=True,
    fsdp=True,
    source="[arXiv:2501.kimi2]",
))


# -- the paper's own workloads (XML MLP over sparse data) --------------------
XML_WORKLOADS = {
    "xml-amazon-670k": dict(dataset="amazon-670k", hidden=128),
    "xml-delicious-200k": dict(dataset="delicious-200k", hidden=128),
}


def get(name: str) -> ModelConfig:
    return ARCHS[name]


ARCH_IDS = list(ARCHS.keys())

"""Configuration dataclasses.

Copied from ``repro/configs/base.py``: ``ModelConfig`` (the LM
architectures; ``reduced()`` is the small smoke variant), ``ElasticConfig``
(the paper's Adaptive SGD hyperparameters, Alg. 1 + 2) and ``InputShape``
with the assigned ``INPUT_SHAPES``. ``remat``/``remat_policy`` are read by
LM training (``models.model._remat``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | encdec | vlm | audio | xml_mlp
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # ---- MoE ----
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1          # MoE FFN on layers where (i % moe_every == moe_offset)
    moe_offset: int = 0
    n_dense_layers: int = 0     # first k layers use dense FFN (kimi-style)
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    dense_residual_ff: int = 0    # width of the parallel dense FFN
    router_aux_coef: float = 0.01
    moe_dispatch: str = "global"  # 'global' (baseline) | 'sharded' (§Perf)
    moe_combine_dtype: str = "f32"  # 'f32' (baseline) | 'bf16' (§Perf iter 2)
    moe_decode_gather: bool = False  # decode-time expert-gather FFN (§Perf)

    # ---- kernel routing (CUDA kernels on the card, plain versions on the CPU) ----
    use_flash_kernel: bool = False   # attention via kernels/flash_attention
    use_ssd_kernel: bool = False     # mamba2 SSD via kernels/ssd_scan
    use_gmm_kernel: bool = False     # MoE expert FFN via kernels/moe_gmm

    # ---- SSM (Mamba2 / SSD) ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_period: int = 0        # hybrid: attention layer where (i % attn_period == attn_offset)
    attn_offset: int = 0

    # ---- attention ----
    head_dim: int = 0           # 0 => d_model // n_heads
    rope_theta: float = 10000.0
    sliding_window: int = 0     # 0 => full attention
    long_context_window: int = 8192  # window used for long_500k on full-attn archs

    # ---- encoder-decoder / frontends ----
    encoder_layers: int = 0     # >0 => enc-dec; n_layers counts decoder layers
    frontend: Optional[str] = None      # None | 'audio' | 'vision'
    frontend_len: int = 0       # number of precomputed frame/patch embeddings
    frontend_dim: int = 0       # embedding dim produced by the (stub) frontend

    # ---- numerics ----
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"  # 'full' | 'dots' (save matmul outputs, §Perf)
    logits_softcap: float = 0.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # ---- sharding policy ----
    replica_axis: str = "data"  # 'data' (small archs) | 'pod' (huge archs)
    expert_parallel: bool = False  # shard experts over the data axis
    fsdp: bool = False             # shard non-expert params over the data axis

    # source citation for the assigned-arch table
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    def layer_kind(self, i: int) -> str:
        """'attn' | 'ssm' for the sequence-mixing sublayer of layer i."""
        if self.arch_type == "ssm":
            return "ssm"
        if self.arch_type == "hybrid":
            return "attn" if (i % self.attn_period == self.attn_offset) else "ssm"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """'dense' | 'moe' for the channel-mixing sublayer of layer i."""
        if self.n_experts == 0 or i < self.n_dense_layers:
            return "dense"
        return "moe" if (i % self.moe_every == self.moe_offset) else "dense"

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads))
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            encoder_layers=min(self.encoder_layers, 2),
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_dense_layers=min(self.n_dense_layers, 1),
            dense_residual_ff=min(self.dense_residual_ff, 512),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=min(self.ssm_head_dim, 32) if self.ssm_head_dim else 0,
            ssm_chunk=64,
            attn_period=min(self.attn_period, 2) if self.attn_period else 0,
            attn_offset=min(self.attn_offset, 1),
            frontend_len=min(self.frontend_len, 16) if self.frontend_len else 0,
            frontend_dim=min(self.frontend_dim, 256) if self.frontend_dim else 0,
            long_context_window=256,
            sliding_window=min(self.sliding_window, 128) if self.sliding_window else 0,
            dtype="float32",
        )


@dataclass(frozen=True)
class ElasticConfig:
    algorithm: str = "adaptive"  # any key in the core/algorithms registry
    placement: str = "vmap"      # replica execution placement: 'vmap' (all
                                 # replicas on one device, vectorized over
                                 # the leading R dim) or 'sharded' (R split
                                 # over a replica mesh, a thread and a
                                 # stream a shard; core/trainer.py)
    n_replicas: int = 4
    mega_batch: int = 100        # batches between merges (paper default 100)
    b_max: int = 256             # max per-replica batch size (slots)
    b_min: int = 32              # paper: b_max / 8
    beta: float = 16.0           # paper: b_min / 2
    pert_thr: float = 0.10       # perturbation threshold (Alg. 2)
    delta: float = 0.10          # perturbation factor (Alg. 2)
    gamma: float = 0.90          # global-model momentum (Alg. 2)
    replica_axis: str = "data"
    # CROSSBOW-only: correction rate of local replica toward global average
    crossbow_correction: float = 0.1

    @staticmethod
    def from_bmax(b_max: int, **kw) -> "ElasticConfig":
        """Paper's default derivation: b_min = b_max/8, beta = b_min/2."""
        b_min = max(1, b_max // 8)
        return ElasticConfig(b_max=b_max, b_min=b_min, beta=b_min / 2, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

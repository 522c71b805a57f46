"""Model configuration covering every assigned architecture family.

One frozen dataclass; family-specific fields are ignored by other
families. Exact assigned values live in repro_torch/configs/<arch>.py:
copies of the JAX package's configs, so this package never imports
``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"       # dense | moe | hybrid | ssm | encdec | encoder
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None   # None -> d_model // n_heads
    d_ff: int = 512
    vocab: int = 1024
    max_seq: int = 2048

    act: str = "swiglu"         # swiglu | geglu | gelu | relu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    qk_norm: bool = False
    pos: str = "rope"           # rope | learned | none
    rope_pct: float = 1.0       # chatglm partial rotary = 0.5
    rope_theta: float = 10000.0
    causal: bool = True
    tie_embeddings: bool = False

    # --- MoE (granite, kimi, jamba FFNs) ---
    n_experts: int = 0
    topk: int = 0
    expert_dff: int = 0          # per-expert hidden dim (kimi: 2048)
    n_shared_experts: int = 0    # kimi-style always-on shared expert
    # expert rows a call per expert: tokens * topk * factor / n_experts;
    # None is dropless (Jamba): the call's largest load, read to the host
    capacity_factor: Optional[float] = 1.25
    moe_renorm: bool = True      # gates: top-k probs renormalized to sum 1
                                 # (False: the softmax's probs as they are)
    moe_every: int = 1           # MoE replaces dense FFN every k-th layer
    moe_ep: bool = False         # shard_map expert parallelism (perf opt)
    fsdp_params: bool = False    # 2-D expert-weight sharding (model x data)
                                 # -- needed when params/chip > HBM (kimi 1T)

    # --- hybrid (jamba): repeating block of `block_len` sublayers ---
    block_len: int = 8
    attn_index: int = 4          # which sublayer in the block is attention
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_inner_norm: bool = False   # Jamba: RMSNorm on dt's input, B, C

    # --- rwkv6 ---
    rwkv_head_dim: int = 64

    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    dec_layers: int = 0
    enc_len: int = 1500          # stub frontend: precomputed frame embeds

    # --- vlm (pixtral): stub frontend of precomputed patch embeds ---
    num_patches: int = 0

    # --- classification head (roberta/SST-2) ---
    n_classes: int = 0

    dtype: str = "bfloat16"
    # attention sequence-chunk size for memory-efficient (online-softmax)
    # attention; 0 = always use plain attention
    attn_chunk: int = 1024
    # 'chunked' (plain attention) or 'flash' (the flash_attention kernel
    # on the card, its plain version on the CPU; forward only)
    attn_impl: str = "chunked"

    # parallelism hints
    pipeline_stages: int = 1     # PP unused for ZO (no backward) -- must be 1
    # TP sizing: small models (whisper-base: d_model=512) waste the 16-way
    # model axis on tiny shards + per-layer ARs; with use_tp=False weights
    # replicate and the model axis joins the batch axes (pure DP)
    use_tp: bool = True

    def __post_init__(self):
        assert self.pipeline_stages == 1, (
            "PP is deliberately unsupported: ZO training has no backward "
            "pass, so pipeline bubbles buy nothing (DESIGN.md Sec 4)")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SSM / hybrid only, per assignment)."""
        return self.family in ("ssm", "hybrid")

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        base = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 2,
            head_dim=16 if self.head_dim else None,
            d_ff=128,
            vocab=128,
            max_seq=64,
            dtype="float32",
            attn_chunk=0,
        )
        if self.n_experts:
            base.update(n_experts=min(self.n_experts, 4),
                        topk=min(self.topk, 2), expert_dff=64)
        if self.family == "hybrid":
            base.update(n_layers=4, block_len=4, attn_index=2,
                        mamba_d_state=4, mamba_expand=2)
        if self.family == "encdec":
            base.update(enc_layers=1, dec_layers=1, enc_len=8)
        if self.num_patches:
            base.update(num_patches=4)
        if self.n_kv_heads == 1:   # keep MQA archs MQA in the smoke test
            base.update(n_kv_heads=1)
        base.update(overrides)
        return dataclasses.replace(self, **base)

"""Analytic parameter and FLOP counts of a model configuration.

Port of ``active_params`` and ``model_flops`` from the JAX package's
``roofline/analysis.py`` (the fleet's lease latency model reads them).
That module's HLO roofline tools analyse compiled XLA programs and have
no counterpart here.
"""

from __future__ import annotations


def active_params(cfg) -> float:
    """Parameters touched per token (active experts only for MoE)."""
    d, v = cfg.d_model, cfg.vocab
    hd = cfg.resolved_head_dim if cfg.n_heads else 0
    emb = v * d  # embedding lookup is sparse; count once for lm_head

    def attn_p():
        return (d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
                + cfg.n_heads * hd * d)

    def mlp_p(f):
        mult = 3 if cfg.act in ("swiglu", "geglu") else 2
        return mult * d * f

    if cfg.family == "ssm":
        per_layer = 4 * d * d + d * d + 3 * d * cfg.d_ff  # rwkv tm + cm
        return cfg.n_layers * per_layer + emb
    if cfg.family == "hybrid":
        nb = cfg.n_layers // cfg.block_len
        di = cfg.mamba_expand * d
        mamba_p = 2 * d * di + di * d  # in/out proj dominate
        per_block = (cfg.block_len - 1) * mamba_p + attn_p()
        # ffn: half dense, half moe(topk active)
        n_moe = cfg.block_len // 2
        n_dense = cfg.block_len - n_moe
        f = cfg.expert_dff or cfg.d_ff
        per_block += n_dense * mlp_p(cfg.d_ff) + n_moe * cfg.topk * mlp_p(f)
        return nb * per_block + emb
    if cfg.family == "encdec":
        per = attn_p() + mlp_p(cfg.d_ff)
        return (cfg.enc_layers * per + cfg.dec_layers * (per + attn_p())
                + emb)
    per_layer = attn_p()
    if cfg.n_experts:
        per_layer += cfg.topk * mlp_p(cfg.expert_dff or cfg.d_ff)
        per_layer += cfg.n_shared_experts * mlp_p(cfg.expert_dff or cfg.d_ff)
    else:
        per_layer += mlp_p(cfg.d_ff)
    return cfg.n_layers * per_layer + emb


def model_flops(cfg, n_tokens: int, mode: str) -> float:
    """6*N_active*D for train (fwd+bwd); ZO train = 2 forwards = 4*N*D;
    prefill/decode = 2*N*D per token."""
    n = active_params(cfg)
    per_tok = {"train": 4.0, "train-adam": 6.0, "prefill": 2.0,
               "decode": 2.0}[mode]
    return per_tok * n * n_tokens

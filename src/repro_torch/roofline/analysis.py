"""Analytic parameter and FLOP counts, and the three-term roofline.

Port of the JAX package's ``roofline/analysis.py`` (the fleet's lease
latency model reads ``active_params``):

  compute     = flops             / peak FLOP/s      (per device)
  memory      = hbm bytes         / HBM bandwidth    (per device)
  collective  = collective bytes  / NVLink bandwidth (per device)

on the H100's data-sheet constants (``launch/mesh.py``). Where the
reference reads its counts from the partitioned HLO (``roofline/hlo.py``),
the port reads them from a traced run (``roofline/trace.py``; its byte
count is unfused). MODEL_FLOPS (4*N*D ZO / 6*N*D gradient training,
2*N*D a forward, N the active parameters) is computed from the config for
the usefulness ratio.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


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


def total_params(cfg) -> float:
    if not cfg.n_experts:
        return active_params(cfg)
    d = cfg.d_model
    f = cfg.expert_dff or cfg.d_ff
    mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    per_expert = mult * d * f
    if cfg.family == "hybrid":
        nb = cfg.n_layers // cfg.block_len
        n_moe_layers = nb * (cfg.block_len // 2)
    else:
        n_moe_layers = cfg.n_layers
    extra = n_moe_layers * (cfg.n_experts - cfg.topk) * per_expert
    return active_params(cfg) + extra


def model_flops(cfg, n_tokens: int, mode: str) -> float:
    """6*N_active*D for train (fwd+bwd); ZO train = 2 forwards = 4*N*D;
    prefill/decode = 2*N*D per token."""
    n = active_params(cfg)
    per_tok = {"train": 4.0, "train-adam": 6.0, "prefill": 2.0,
               "decode": 2.0}[mode]
    return per_tok * n * n_tokens


def roofline_terms(cost: Dict, analysis: Optional[Dict], n_chips: int,
                   cfg=None, n_tokens: int = 0, mode: str = "train",
                   flops_override: Optional[float] = None) -> Dict:
    """All terms in seconds-per-step (per device).

    ``analysis`` is a :func:`repro_torch.roofline.trace.analyze` result
    (the reference passes HLO text and analyzes it here); without one the
    terms read ``cost``'s ``flops`` and ``bytes accessed``, whose raw
    values are kept alongside either way."""
    la = analysis
    if flops_override is not None:
        flops = flops_override
    elif la is not None:
        flops = la["flops"]
    else:
        flops = float(cost.get("flops", 0.0))
    bytes_hbm = (la["hbm_bytes"] if la is not None
                 else float(cost.get("bytes accessed", 0.0)))
    coll = la["collective_bytes"] if la is not None else 0.0

    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = bytes_hbm / HBM_BW
    t_coll = coll / NVLINK_BW
    terms = {
        "flops_per_chip": flops,
        "hbm_bytes_per_chip": bytes_hbm,
        "collective_bytes_per_chip": coll,
        "raw_cost_analysis_flops": float(cost.get("flops", 0.0)),
        "raw_cost_analysis_bytes": float(cost.get("bytes accessed", 0.0)),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": max(
            [("compute", t_compute), ("memory", t_memory),
             ("collective", t_coll)], key=lambda kv: kv[1])[0],
    }
    if cfg is not None and n_tokens:
        mf = model_flops(cfg, n_tokens, mode)
        terms["model_flops_total"] = mf
        hw_total = flops * n_chips
        terms["useful_flops_ratio"] = (mf / hw_total) if hw_total else 0.0
        # roofline fraction: useful model flops per device over the
        # step's bound (the dominant term) at peak
        t_bound = max(t_compute, t_memory, t_coll)
        if t_bound > 0:
            terms["roofline_fraction"] = (
                (mf / n_chips) / PEAK_FLOPS_BF16) / t_bound
    return terms

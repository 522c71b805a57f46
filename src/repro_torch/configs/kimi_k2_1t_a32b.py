"""kimi-k2-1t-a32b [moe]: trillion-param MoE, 384 experts top-8 + 1 shared.
[arXiv:2501.kimi2; unverified paper-table]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
        n_heads=64, n_kv_heads=8, head_dim=112, d_ff=2048, vocab=163840,
        act="swiglu", norm="rmsnorm", pos="rope", rope_theta=5e4,
        n_experts=384, topk=8, expert_dff=2048, n_shared_experts=1,
        capacity_factor=1.25, fsdp_params=True, moe_ep=True, max_seq=32768)

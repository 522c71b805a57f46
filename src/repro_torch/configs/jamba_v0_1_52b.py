"""jamba-v0.1-52b [hybrid]: Mamba+attn 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887; hf]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536,
        act="swiglu", norm="rmsnorm", pos="none",   # jamba uses no pos emb
        n_experts=16, topk=2, expert_dff=14336, capacity_factor=1.25, moe_ep=True,
        block_len=8, attn_index=4, mamba_d_state=16, mamba_d_conv=4,
        mamba_expand=2, max_seq=524288)

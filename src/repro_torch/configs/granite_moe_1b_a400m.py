"""granite-moe-1b-a400m [moe]: 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=8, d_ff=512, vocab=49155,
        act="swiglu", norm="rmsnorm", pos="rope", tie_embeddings=True,
        n_experts=32, topk=8, expert_dff=512, capacity_factor=1.25, moe_ep=True,
        max_seq=32768)

"""qwen3-4b [dense]: qk_norm + GQA. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense", n_layers=36, d_model=2560,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=9728, vocab=151936,
        act="swiglu", norm="rmsnorm", qk_norm=True, pos="rope",
        rope_theta=1e6, max_seq=32768, tie_embeddings=True)

"""rwkv6-7b "Finch" [ssm]: attn-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096,
        n_heads=0, n_kv_heads=0, d_ff=14336, vocab=65536,
        norm="rmsnorm", pos="none", rwkv_head_dim=64, max_seq=524288)

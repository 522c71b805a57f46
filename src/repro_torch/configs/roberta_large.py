"""roberta-large (paper's own model, Sec 4.1: fine-tuned on SST-2)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="roberta-large", family="encoder", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=16, d_ff=4096, vocab=50265,
        act="gelu", norm="layernorm", pos="learned", causal=False,
        n_classes=2, max_seq=512, dtype="float32")

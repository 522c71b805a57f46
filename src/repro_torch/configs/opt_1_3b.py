"""OPT-1.3B (paper's own model, Sec 4.1: fine-tuned on SuperGLUE)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="opt-1.3b", family="dense", n_layers=24, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab=50272,
        act="relu", norm="layernorm", pos="learned", max_seq=2048)

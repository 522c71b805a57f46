"""Models: config, layers, block registry, runtime and family assembly."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model, build_model

__all__ = ["ModelConfig", "Model", "build_model"]

"""Architecture registry: 10 assigned archs + the paper's own two models.

``get_config(arch_id)`` -> ModelConfig; ``ARCHS`` lists assigned ids.
"""

from __future__ import annotations

import importlib

ARCHS = [
    "qwen3-4b", "glm4-9b", "chatglm3-6b", "gemma-2b", "pixtral-12b",
    "jamba-v0.1-52b", "kimi-k2-1t-a32b", "granite-moe-1b-a400m",
    "rwkv6-7b", "whisper-base",
]
PAPER_ARCHS = ["roberta-large", "opt-1.3b"]
ALL_ARCHS = ARCHS + PAPER_ARCHS

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ALL_ARCHS}


def get_config(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).config()

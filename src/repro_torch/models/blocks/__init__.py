"""Block registry: every mixer/FFN behind one protocol (see base.py).

Importing this package registers the ported block types (attention and
mlp); the runtime resolves them by name.
"""

from repro_torch.models.blocks.base import (BlockType, RunCtx, block_names,
                                            get_block, register_block)
from repro_torch.models.blocks import attention as _attention  # noqa: F401
from repro_torch.models.blocks import ffn as _ffn              # noqa: F401

__all__ = ["BlockType", "RunCtx", "block_names", "get_block",
           "register_block"]

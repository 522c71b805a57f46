"""Block registry: every mixer/FFN behind one protocol (see base.py).

Importing this package registers the block types (attention, mlp, moe,
mamba, rwkv time-mix / channel-mix, cross-attention); the runtime
resolves them by name.
"""

from repro_torch.models.blocks.base import (BlockType, RunCtx, block_names,
                                            get_block, register_block)
from repro_torch.models.blocks import attention as _attention  # noqa: F401
from repro_torch.models.blocks import cross_attention as _cross  # noqa: F401
from repro_torch.models.blocks import ffn as _ffn              # noqa: F401
from repro_torch.models.blocks import mamba as _mamba          # noqa: F401
from repro_torch.models.blocks import rwkv as _rwkv            # noqa: F401

__all__ = ["BlockType", "RunCtx", "block_names", "get_block",
           "register_block"]

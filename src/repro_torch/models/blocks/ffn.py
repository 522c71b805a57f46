"""FFN blocks: the dense MLP (stateless -- the runtime calls ``apply`` in
every mode). The MoE block waits for the slice that ports the other
model families."""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.blocks.base import BlockType, register_block


def _mlp_apply(cfg, p, x, rc, ctx=None):
    return L.mlp_apply(cfg, p, x, ctx), torch.zeros(
        (), dtype=torch.float32, device=x.device)


MLP = register_block(BlockType(name="mlp", apply=_mlp_apply))

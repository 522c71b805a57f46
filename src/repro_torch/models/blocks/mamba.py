"""Mamba (selective SSM) block -- the recurrent sublayer of the hybrid
family.

Port of the JAX package's ``models/blocks/mamba.py``. State is (conv
window in the model dtype, ssm accumulator in f32); prefill rolls both to
the last token with one scan, decode advances them one token, and both
write the layer's state in place (masked slots keep theirs)."""

from __future__ import annotations

import torch

from repro_torch.models import mamba as M
from repro_torch.models.blocks.base import (BlockType, commit_state,
                                            register_block)


def _apply(cfg, p, x, rc, ctx=None):
    return M.mamba_apply(cfg, p, x, ctx=ctx), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def _state_spec(cfg, bsz, max_len, dtype):
    _, di, _ = M.dims(cfg)
    return {"conv": ((bsz, cfg.mamba_d_conv - 1, di), dtype),
            "ssm": ((bsz, di, cfg.mamba_d_state), torch.float32)}


def _step(cfg, p, state, x, rc):
    y, new = M.mamba_prefill(cfg, p, state, x)
    return y, commit_state(state, new, rc.write_mask)


MAMBA = register_block(BlockType(
    name="mamba", apply=_apply, state_spec=_state_spec, prefill=_step,
    decode_step=_step))

"""RWKV-6 blocks: time-mix (the WKV linear-attention mixer) and
channel-mix (the squared-ReLU FFN).

Port of the JAX package's ``models/blocks/rwkv.py``. Both carry a
token-shift buffer in the model dtype; time-mix also carries the
(H, hd, hd) f32 WKV accumulator. The full-sequence scan and the
per-token cell are the same recurrence, so prefill and decode share one
step, which writes the layer's state in place (masked slots keep
theirs)."""

from __future__ import annotations

import torch

from repro_torch.models import rwkv6 as R
from repro_torch.models.blocks.base import (BlockType, commit_state,
                                            register_block)


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _tm_apply(cfg, p, x, rc, ctx=None):
    y, _ = R.timemix_apply(cfg, p, x, ctx=ctx)
    return y, _zero(x)


def _tm_state_spec(cfg, bsz, max_len, dtype):
    h, hd = R.heads(cfg)
    return {"state": ((bsz, h, hd, hd), torch.float32),
            "x_prev": ((bsz, 1, cfg.d_model), dtype)}


def _tm_step(cfg, p, state, x, rc):
    y, (st, xl) = R.timemix_apply(cfg, p, x, state=state["state"],
                                  x_prev=state["x_prev"])
    return y, commit_state(state, {"state": st, "x_prev": xl},
                           rc.write_mask)


def _cm_apply(cfg, p, x, rc, ctx=None):
    y, _ = R.channelmix_apply(cfg, p, x, ctx=ctx)
    return y, _zero(x)


def _cm_state_spec(cfg, bsz, max_len, dtype):
    return {"x_prev": ((bsz, 1, cfg.d_model), dtype)}


def _cm_step(cfg, p, state, x, rc):
    y, xl = R.channelmix_apply(cfg, p, x, x_prev=state["x_prev"])
    return y, commit_state(state, {"x_prev": xl}, rc.write_mask)


RWKV_TIMEMIX = register_block(BlockType(
    name="rwkv_timemix", apply=_tm_apply, state_spec=_tm_state_spec,
    prefill=_tm_step, decode_step=_tm_step))
RWKV_CHANNELMIX = register_block(BlockType(
    name="rwkv_channelmix", apply=_cm_apply, state_spec=_cm_state_spec,
    prefill=_cm_step, decode_step=_cm_step))

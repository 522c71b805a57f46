"""Decoder cross-attention block (encoder-decoder / whisper).

Port of the JAX package's ``models/blocks/cross_attention.py``.
Full-sequence apply projects K/V from ``rc.enc_out`` on the fly (ZO
perturbation included through the ctx); decode and prefill read
``(xk, xv)`` from the block's state and never write it
(``mutable_state=False``). A caller with encoder output fills the state
through :func:`cross_kv` a layer; the serving engine admits token-only
requests, so its cross state stays at the cache's zeros, as in the
reference engine. The attention itself is the plain one, as the
reference's ``cross_attn_apply`` computes it."""

from __future__ import annotations

import torch

from repro_torch.core.perturb_ctx import sub as _sub
from repro_torch.models import layers as L
from repro_torch.models.blocks.base import BlockType, register_block


def cross_kv(cfg, p, enc_out, ctx=None):
    """Project encoder output to this layer's cross K/V."""
    b, t, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = L.dense(p["wk"], enc_out, _sub(ctx, "wk")).reshape(
        b, t, cfg.n_kv_heads, hd)
    v = L.dense(p["wv"], enc_out, _sub(ctx, "wv")).reshape(
        b, t, cfg.n_kv_heads, hd)
    return k, v


def _apply(cfg, p, x, rc, ctx=None):
    kv = cross_kv(cfg, p, rc.enc_out, ctx)
    return L.cross_attn_apply(cfg, p, x, kv, ctx=ctx), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def _state_spec(cfg, bsz, max_len, dtype):
    shape = (bsz, cfg.enc_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"xk": (shape, dtype), "xv": (shape, dtype)}


def _from_state(cfg, p, state, x, rc):
    return L.cross_attn_apply(cfg, p, x, (state["xk"], state["xv"])), state


CROSS_ATTENTION = register_block(BlockType(
    name="cross_attention", apply=_apply, state_spec=_state_spec,
    prefill=_from_state, decode_step=_from_state, mutable_state=False))

"""Self-attention block: GQA/MQA attention over a KV cache.

Port of the JAX package's ``models/blocks/attention.py`` (full-sequence
apply, dense decode, paged decode, chunked paged prefill, the
speculative verify window, whole-prompt prefill). Cache layers are
updated in place.

Dense mode: per-slot (B, S_max, KV, hd) strips; decode writes position
``pos[b]`` of each slot. Paged mode: K/V live in a shared page pool
(``k_pages``/``v_pages``: (n_pages, page_size, KV, hd) per layer) with a
per-slot page table in ``rc.pages``; decode and chunked prefill attend
over live pages only, through the ``flash_decode`` / ``flash_prefill``
kernels on the card (their plain versions on the CPU), and the verify
window through ``flash_verify``. Physical page 0 is the pool's trash
page: masked-out slots and window offsets (``rc.write_mask``) and
unallocated table entries point there, so scatters need no merge and
reads need no index clamping.
"""

from __future__ import annotations

import torch

from repro_torch.core.batching import masked_merge
from repro_torch.kernels.ops import (paged_decode_attn, paged_prefill_attn,
                                     paged_verify_attn)
from repro_torch.models import layers as L
from repro_torch.models.blocks.base import BlockType, register_block


def _apply(cfg, p, x, rc, causal=None, ctx=None):
    y = L.attn_apply(cfg, p, x, positions=rc.positions, kv_mask=rc.kv_mask,
                     causal=causal, ctx=ctx)
    return y, torch.zeros((), dtype=torch.float32, device=x.device)


def _state_spec(cfg, bsz, max_len, dtype):
    shape = (bsz, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}


def _paged_state_spec(cfg, dtype):
    shape = (cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k_pages": (shape, dtype), "v_pages": (shape, dtype)}


def _rope(cfg, q, k, positions):
    if cfg.pos != "rope":
        return q, k
    cs = L.rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_pct,
                        cfg.rope_theta)
    return L.apply_rope(q, cs), L.apply_rope(k, cs)


def _decode_paged(cfg, p, state, x, rc):
    """One-token attention against the shared page pool. ``rc.pos`` is
    the (B,) int32 per-slot position, ``rc.pages`` the (B, n_live) int32
    page table slice covering every live page."""
    ck, cv = state["k_pages"], state["v_pages"]     # (NP, ps, KV, hd)
    b = x.shape[0]
    ps = ck.shape[1]
    pos = rc.pos.long()
    q, k, v = L.attn_project_qkv(cfg, p, x)       # (B,1,H,hd),(B,1,KV,hd)
    q, k = _rope(cfg, q, k, pos[:, None])
    # a slot whose stale position lies past the live table (an idle slot)
    # reads its last entry -- the trash page, as its row is all zeros
    lp = torch.clamp(pos // ps, max=rc.pages.shape[1] - 1)
    phys = torch.gather(rc.pages.long(), 1, lp[:, None])[:, 0]
    if rc.write_mask is not None:
        phys = torch.where(rc.write_mask, phys, 0)  # masked slots -> trash
    off = pos % ps
    ck[phys, off] = k[:, 0].to(ck.dtype)
    cv[phys, off] = v[:, 0].to(cv.dtype)
    out = paged_decode_attn(q[:, 0], ck, cv, rc.pages, rc.pos)
    return (L.dense(p["wo"], out.reshape(b, 1, -1)),
            {"k_pages": ck, "v_pages": cv})


def _decode_step(cfg, p, state, x, rc, causal=None):
    """One-token attention against the cache layer at the (B,) per-slot
    positions ``rc.pos``. Dense mode honours ``rc.write_mask`` by keeping
    a masked slot's old entry: the JAX engine's masked merge."""
    if "k_pages" in state:
        return _decode_paged(cfg, p, state, x, rc)
    ck, cv = state["k"], state["v"]                 # (B, S, KV, hd)
    b = x.shape[0]
    pos = rc.pos.long()
    q, k, v = L.attn_project_qkv(cfg, p, x)
    q, k = _rope(cfg, q, k, pos[:, None])
    rows = torch.arange(b, device=x.device)
    k_new, v_new = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)
    if rc.write_mask is not None:
        k_new = masked_merge(ck[rows, pos], k_new, rc.write_mask)
        v_new = masked_merge(cv[rows, pos], v_new, rc.write_mask)
    ck[rows, pos] = k_new
    cv[rows, pos] = v_new
    valid = (torch.arange(ck.shape[1], device=x.device)[None, :]
             <= pos[:, None])
    out = L.attention(q, ck, cv, causal=False, kv_mask=valid, chunk=0)
    return L.dense(p["wo"], out.reshape(b, 1, -1)), {"k": ck, "v": cv}


def _window_paged(cfg, p, state, x, rc, attn, what):
    """Scatter-then-read over the page pool for a multi-token paged entry
    (speculative verify, chunked prefill): the W tokens' own K/V is
    written through the page table first (masked slots and offsets
    scatter into the trash page), then the attention read sees exactly
    what a sequential decode of those tokens would have cached."""
    if "k_pages" not in state:
        raise ValueError(f"{what} needs a paged KV cache "
                         "(attention state has no k_pages pool)")
    ck, cv = state["k_pages"], state["v_pages"]     # (NP, ps, KV, hd)
    b, w = x.shape[:2]
    ps = ck.shape[1]
    pos = rc.pos.long()
    q, k, v = L.attn_project_qkv(cfg, p, x)       # (B,W,H,hd),(B,W,KV,hd)
    posw = pos[:, None] + torch.arange(w, device=x.device)[None, :]
    q, k = _rope(cfg, q, k, posw)
    # a masked offset (past a slot's draft, or an idle slot's stale
    # position) may lie past the live table: clamp, as _decode_paged
    # does; its write goes to the trash page and its output is dropped
    lp = torch.clamp(posw // ps, max=rc.pages.shape[1] - 1)
    phys = torch.gather(rc.pages.long(), 1, lp)
    if rc.write_mask is not None:
        wm = rc.write_mask
        if wm.dim() == 1:
            wm = wm[:, None]
        phys = torch.where(wm, phys, 0)             # masked -> trash
    off = posw % ps
    ck[phys, off] = k.to(ck.dtype)
    cv[phys, off] = v.to(cv.dtype)
    out = attn(q, ck, cv, rc.pages, rc.pos)
    return (L.dense(p["wo"], out.reshape(b, w, -1)),
            {"k_pages": ck, "v_pages": cv})


def _verify_paged(cfg, p, state, x, rc, causal=None):
    """Speculative-verify window: score W candidate tokens per slot at
    positions ``rc.pos .. rc.pos + W - 1``, overwriting the draft's K/V
    at those positions with this model's own (offsets past a slot's
    window, ``rc.write_mask`` (B, W) False, go to the trash page), then
    attend causally within the window (the flash_verify kernel on the
    card)."""
    return _window_paged(cfg, p, state, x, rc, paged_verify_attn,
                         "verify window")


def _prefill_paged(cfg, p, state, x, rc, causal=None):
    """Chunked prefill: write a C-token prompt chunk's K/V straight into
    the slot's reserved pages and attend over all prior chunks plus
    causally within this one (the flash_prefill kernel on the card)."""
    return _window_paged(cfg, p, state, x, rc, paged_prefill_attn,
                         "chunked prefill")


def _prefill(cfg, p, state, x, rc, causal=None):
    """Full-prompt attention that also writes positions [0, S) of the
    cache layer."""
    ck, cv = state["k"], state["v"]
    b, s, _ = x.shape
    q, k, v = L.attn_project_qkv(cfg, p, x)
    q, k = _rope(cfg, q, k, rc.positions)
    ck[:, :s] = k.to(ck.dtype)
    cv[:, :s] = v.to(cv.dtype)
    out = L.attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    return L.dense(p["wo"], out.reshape(b, s, -1)), {"k": ck, "v": cv}


ATTENTION = register_block(BlockType(
    name="attention", apply=_apply, state_spec=_state_spec,
    prefill=_prefill, decode_step=_decode_step,
    paged_state_spec=_paged_state_spec, verify=_verify_paged,
    prefill_paged=_prefill_paged))

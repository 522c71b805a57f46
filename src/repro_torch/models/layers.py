"""Shared neural layers: norms, RoPE, attention (GQA/MQA), MLPs, embedding.

Port of the JAX package's ``models/layers.py``.

Conventions:
  * params are nested dicts of tensors, keyed as in the JAX param tree
    (``p["wq"]["w"]``), one layer's slice of the stacked leaves at a time;
    any weight may be an int8 ``QuantizedLeaf``: the plain forward
    dequantizes it at the use site (``deq``, ``take_rows``);
  * activations flow in the param dtype (bf16 at full size), softmax and
    norm math in f32;
  * every parameterized apply-fn takes an optional ``ctx``
    (:class:`repro_torch.core.perturb_ctx.PerturbCtx`, scoped to its
    param sub-dict). ``ctx=None`` is the plain forward; with a ctx, dense
    weights compute ``X @ (W + coeff*z)`` through the ``zo_matmul``
    kernel and the other leaves add a transient ``coeff*z`` -- the
    perturbed forward of the fused MeZO step;
  * attention is the plain dense path the JAX package leaves to XLA, or
    with ``attn_impl="flash"`` the ``flash_attention`` kernel; the paged
    kernels live in ``repro_torch.kernels``;
  * under a user-axis ctx (the multi-tenant step) activations carry the
    n lanes flattened into the batch, ``(n * B, S, D)``; a perturbed leaf
    comes back with a leading lane axis and is applied to its own lane
    (``_lanes``), and what the card might sum in another order at
    another batch size -- the plain attention's products and softmax --
    runs lane by lane at the scalar path's shapes, so every lane's bits
    are a lone forward's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.perturb_ctx import sub as _sub
from repro_torch.core.spans import span
from repro_torch.kernels import ops as kops
from repro_torch.models import sharding as shd
from repro_torch.optim.quant import deq as _deq
from repro_torch.optim.quant import take_rows as _take_rows

_NEG_INF = -1e30


def dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# norms


def rmsnorm(x, scale, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    d = xf - mu
    var = torch.mean(d * d, dim=-1, keepdim=True)
    y = d * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def _batched(ctx) -> bool:
    return ctx is not None and ctx.batched


def _lanes(ctx, x, fn, *per_lane):
    """``fn(x, *per_lane)`` with each per-lane ``(n, ...)`` leaf broadcast
    over its own lane of ``x`` ``(n * B, ...)``: elementwise, so each lane
    is the scalar path's ``fn`` on that lane."""
    xl = ctx.lane_view(x)
    vs = [v.reshape(v.shape[0], *([1] * (xl.dim() - v.dim())),
                    *v.shape[1:]) for v in per_lane]
    return fn(xl, *vs).reshape(x.shape)


def per_row(ctx, v, x, ndim=None):
    """Leaf ``v`` ready to broadcast, in an elementwise expression,
    against a tensor of rank ``ndim`` (default ``x.dim()``) whose batch
    is ``x``'s: ``v`` itself without a user-axis ctx; under one, its
    per-lane ``(n, *leaf)`` form repeated over each lane's rows of the
    flattened ``(n * B, ...)`` batch and shaped ``(n * B, 1, ..., 1,
    *leaf)``, so every row meets its own lane's value where the scalar
    path's ``leaf`` would broadcast."""
    if not _batched(ctx):
        return v
    n = ctx.n_lanes
    rows = v[:, None].expand(n, x.shape[0] // n, *v.shape[1:])
    pad = (ndim or x.dim()) - v.dim()
    return rows.reshape(x.shape[0], *([1] * pad), *v.shape[1:])


def lane_matmul(ctx, x, w):
    """``x @ w`` for a leaf ``w`` a ctx has perturbed (``ctx.perturb``):
    under a user-axis ctx lane by lane, each lane's rows of x against its
    own ``w`` at the scalar path's shapes."""
    if not _batched(ctx):
        return x @ w
    return torch.cat([xu @ wu for xu, wu in zip(ctx.split_lanes(x),
                                                w.unbind(0))])


def lane_einsum(ctx, eq, *xs):
    """``torch.einsum(eq, *xs)`` over activations batched on axis 0; under
    a user-axis ctx lane by lane at the scalar path's shapes (a product
    the card might sum in another order at another batch size)."""
    if not _batched(ctx):
        return torch.einsum(eq, *xs)
    return torch.cat([torch.einsum(eq, *us) for us in
                      zip(*[ctx.split_lanes(x) for x in xs])])


def norm_apply(cfg, p, x, ctx=None):
    with span("model.norm"):
        if ctx is not None:
            p = {k: ctx.perturb(k, v) for k, v in p.items()}
        if _batched(ctx):
            if cfg.norm == "layernorm":
                return _lanes(ctx, x, layernorm, p["scale"], p["bias"])
            return _lanes(ctx, x, rmsnorm, p["scale"])
        if cfg.norm == "layernorm":
            return layernorm(x, p["scale"], p["bias"])
        return rmsnorm(x, p["scale"])


# ---------------------------------------------------------------------------
# rotary position embedding (full / partial per rope_pct)


def rope_cos_sin(positions, head_dim: int, rope_pct: float, theta: float):
    """positions: int tensor (...,). Returns cos/sin of shape (..., rot/2)."""
    rot = int(head_dim * rope_pct)
    rot -= rot % 2
    if rot == 0:
        return None
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    inv = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos_sin):
    """x: (..., S, H, hd); cos/sin: (..., S, rot/2) broadcast over H."""
    if cos_sin is None:
        return x
    cos, sin = cos_sin
    rot2 = cos.shape[-1]
    xr, xp = x[..., :2 * rot2], x[..., 2 * rot2:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# dense projections


def dense(p, x, ctx=None):
    """ctx=None is the plain forward (a quantized weight dequantizes at
    the use site); with a ctx the perturbation -- and for a frozen int8
    base the dequant too -- fuses into the matmul (``PerturbCtx.matmul``)."""
    y = x @ _deq(p["w"]) if ctx is None else ctx.matmul(x, p["w"], "w")
    if "b" in p:
        if _batched(ctx):
            return _lanes(ctx, y, torch.add, ctx.perturb("b", p["b"]))
        y = y + (p["b"] if ctx is None else ctx.perturb("b", p["b"]))
    return y


# ---------------------------------------------------------------------------
# attention


def _sdpa(q, k, v, mask, dtype):
    """q: (B, S, KV, G, hd); k/v: (B, T, KV, hd); mask broadcastable to
    (B, KV, G, S, T). Softmax in f32."""
    # 1/sqrt(hd) rounded in f32 arithmetic, as jnp computes it
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    scores = torch.einsum("bskgh,btkh->bkgst", q.to(torch.float32) * scale,
                          k.to(torch.float32))
    scores = scores.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkh->bskgh", probs.to(dtype), v)


def attention(q, k, v, *, causal: bool, q_offset=0,
              kv_mask: Optional[torch.Tensor] = None, chunk: int = 0):
    """GQA attention. q: (B, S, H, hd); k/v: (B, T, KV, hd).

    kv_mask is (B, T) key validity shared by every query row, or (B, S, T)
    with a mask per query row. chunk > 0 with S % chunk == 0 and S > chunk
    loops over query chunks so peak score memory is (B, H, chunk, T) --
    each query row's arithmetic is the same either way.
    """
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd)
    kv_pos = torch.arange(t, device=q.device)

    def block_mask(q_pos):
        if causal:
            m = q_pos[:, None] >= kv_pos[None, :]
        else:
            m = torch.ones((q_pos.shape[0], t), dtype=torch.bool,
                           device=q.device)
        m = m[None, None, None]                      # (1,1,1,S,T)
        if kv_mask is not None:
            if kv_mask.dim() == 3:                   # per-query-row masks
                rows = kv_mask[:, q_pos - q_offset]
                m = m & rows[:, None, None, :, :]    # (B,1,1,S,T)
            else:
                m = m & kv_mask[:, None, None, None, :]
        return m

    if chunk and s > chunk and s % chunk == 0:
        outs = []
        for c0 in range(0, s, chunk):
            q_pos = q_offset + c0 + torch.arange(chunk, device=q.device)
            outs.append(_sdpa(qg[:, c0:c0 + chunk], k, v, block_mask(q_pos),
                              q.dtype))
        return torch.cat(outs, dim=1).reshape(b, s, h, hd)
    q_pos = q_offset + torch.arange(s, device=q.device)
    out = _sdpa(qg, k, v, block_mask(q_pos), q.dtype)
    return out.reshape(b, s, h, hd)


def attn_project_qkv(cfg, p, x, ctx=None):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = shd.split_heads(dense(p["wq"], x, _sub(ctx, "wq")), cfg.n_heads, hd)
    k = shd.split_heads(dense(p["wk"], x, _sub(ctx, "wk")), cfg.n_kv_heads,
                        hd)
    v = shd.split_heads(dense(p["wv"], x, _sub(ctx, "wv")), cfg.n_kv_heads,
                        hd)
    if cfg.qk_norm:
        qn = p["q_norm"] if ctx is None else ctx.perturb("q_norm",
                                                         p["q_norm"])
        kn = p["k_norm"] if ctx is None else ctx.perturb("k_norm",
                                                         p["k_norm"])
        if _batched(ctx):
            return _lanes(ctx, q, rmsnorm, qn), _lanes(ctx, k, rmsnorm,
                                                       kn), v
        q = rmsnorm(q, qn)
        k = rmsnorm(k, kn)
    return q, k, v


def attn_apply(cfg, p, x, *, positions=None, kv_mask=None, causal=None,
               ctx=None):
    """Self-attention over x: (B, S, D). positions: (B, S) or None."""
    s = x.shape[1]
    q, k, v = attn_project_qkv(cfg, p, x, ctx)
    if cfg.pos == "rope":
        pos = (positions if positions is not None
               else torch.arange(s, device=x.device)[None])
        cs = rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_pct,
                          cfg.rope_theta)
        q, k = apply_rope(q, cs), apply_rope(k, cs)
    causal = cfg.causal if causal is None else causal
    if shd.is_dtensor(q):
        # under a mesh: this rank's heads (sharding.local_heads)
        if cfg.attn_impl == "flash" and kv_mask is None:
            out = shd.local_heads(
                lambda q_, k_, v_: kops.flash_attention(
                    q_.contiguous(), k_, v_, causal=causal), q, k, v)
        else:
            out = shd.local_heads(
                lambda q_, k_, v_, m_: attention(
                    q_, k_, v_, causal=causal, kv_mask=m_,
                    chunk=cfg.attn_chunk), q, k, v, kv_mask)
    elif cfg.attn_impl == "flash" and kv_mask is None:
        out = kops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal)
    elif _batched(ctx):
        # lane by lane: the products and softmax at the scalar shapes
        masks = (ctx.split_lanes(kv_mask) if kv_mask is not None
                 else [None] * ctx.n_lanes)
        out = torch.cat([
            attention(qu, ku, vu, causal=causal, kv_mask=mu,
                      chunk=cfg.attn_chunk)
            for qu, ku, vu, mu in zip(ctx.split_lanes(q),
                                      ctx.split_lanes(k),
                                      ctx.split_lanes(v), masks)])
    else:
        out = attention(q, k, v, causal=causal, kv_mask=kv_mask,
                        chunk=cfg.attn_chunk)
    return dense(p["wo"], shd.merge_heads(out), _sub(ctx, "wo"))


def cross_attn_apply(cfg, p, x, enc_kv, ctx=None):
    """Decoder cross-attention (whisper): K/V from the encoder output (the
    K/V projections perturb where the K/V are computed --
    ``blocks/cross_attention``)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dense(p["wq"], x, _sub(ctx, "wq")).reshape(b, s, cfg.n_heads, hd)
    k, v = enc_kv
    if _batched(ctx):
        # lane by lane: the products and softmax at the scalar shapes
        out = torch.cat([attention(qu, ku, vu, causal=False, chunk=0)
                         for qu, ku, vu in zip(ctx.split_lanes(q),
                                               ctx.split_lanes(k),
                                               ctx.split_lanes(v))])
    else:
        out = attention(q, k, v, causal=False, chunk=0)
    return dense(p["wo"], out.reshape(b, s, -1), _sub(ctx, "wo"))


# ---------------------------------------------------------------------------
# MLPs


def mlp_apply(cfg, p, x, ctx=None):
    if cfg.act in ("swiglu", "geglu"):
        # gated w_in is an interleaved (D, F, 2) leaf: its z-field spans 3
        # dims, so the 2-D zo_matmul does not apply -- transient perturb
        w_in = _deq(p["w_in"]["w"]) if ctx is None else \
            ctx.perturb("w_in/w", p["w_in"]["w"])
        if _batched(ctx):
            h = torch.cat([torch.einsum("...d,dfg->...fg", xu, wu)
                           for xu, wu in zip(ctx.split_lanes(x),
                                             w_in.unbind(0))])
        else:
            h = torch.einsum("...d,dfg->...fg", x, w_in)
        u, g = h[..., 0], h[..., 1]
        gate = (F.silu(g) if cfg.act == "swiglu"
                else F.gelu(g, approximate="tanh"))
        h = u * gate
    else:
        h = dense(p["w_in"], x, _sub(ctx, "w_in"))
        h = F.gelu(h, approximate="tanh") if cfg.act == "gelu" \
            else torch.relu(h)
    return dense(p["w_out"], h, _sub(ctx, "w_out"))


# ---------------------------------------------------------------------------
# embedding


def embed_apply(cfg, p, tokens, positions=None, ctx=None):
    """ctx (scoped to "embed") perturbs only the gathered rows: O(S*D)
    transient z, never the (V, D) table. Under a user-axis ctx each lane
    gathers its own perturbed token rows and its own perturbed position
    rows."""
    if _batched(ctx):
        x = ctx.take("tok", p["tok"], ctx.lane_view(tokens))
        if cfg.pos == "learned":
            pos = (positions if positions is not None
                   else torch.arange(tokens.shape[-1],
                                     device=tokens.device))
            pos = pos.expand(ctx.n_lanes, *pos.shape[-1:])
            x = x + ctx.take("pos", p["pos"], pos)[:, None]
        return x.reshape(*tokens.shape, x.shape[-1])
    x = _take_rows(p["tok"], tokens) if ctx is None else ctx.take(
        "tok", p["tok"], tokens)
    if cfg.pos == "learned":
        pos = (positions if positions is not None
               else torch.arange(tokens.shape[-1], device=tokens.device))
        x = x + (_take_rows(p["pos"], pos) if ctx is None
                 else ctx.take("pos", p["pos"], pos))
    return x


def unembed(cfg, embed_p, head_p, x, ctx=None):
    """Final projection to vocab logits (tied or untied). ctx is scoped to
    the param-tree ROOT here (the two branches touch different leaves)."""
    if cfg.tie_embeddings or head_p is None:
        if ctx is None:
            return x @ _deq(embed_p["tok"]).T
        # the tied head reads the embedding transposed; the row-major
        # z-field does not transpose into kernel tiles: perturb transiently
        tok = ctx.scope("embed").perturb("tok", embed_p["tok"])
        return lane_matmul(ctx, x, tok.transpose(-2, -1))
    return dense(head_p, x, _sub(ctx, "lm_head"))

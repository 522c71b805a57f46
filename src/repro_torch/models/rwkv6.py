"""RWKV-6 "Finch" layer: linear attention with data-dependent decay.

Port of the JAX package's ``models/rwkv6.py``. Time-mix state per head
is an (hd x hd) outer-product accumulator in f32 with a per-channel,
input-dependent decay w_t (a low-rank MLP on the shifted input, kept in
f32); channel-mix is the squared-ReLU RWKV FFN. The full-sequence form
scans over time in a Python loop (a few small launches a step on the
card); decode is the same cell applied once.

As in the reference, the token-shift interpolation factors (``mu``) are
static learned vectors and the decay LoRA is kept faithful. Every weight
use takes the ctx: projections through ``L.dense`` (``zo_matmul`` on the
card), the other leaves through ``ctx.perturb`` (``zo_add``).

Under a user-axis ctx (the multi-tenant step, lanes flattened in the
batch) each per-lane leaf meets only its own lane's rows
(``L.per_row``), the decay LoRA's products and the WKV cell's one
contraction a step run lane by lane at the scalar path's shapes, and the
rest of the scan, elementwise in the batch, runs over every lane at
once: each lane's bits are a lone forward's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.perturb_ctx import sub as _sub
from repro_torch.models import layers as L
from repro_torch.models import sharding as shd
from repro_torch.optim.quant import deq as _deq

_F32 = torch.float32


def _leaf(p, name, ctx):
    """p[name] + coeff*z under a PerturbCtx; the bare (dequantized) leaf
    without one."""
    return _deq(p[name]) if ctx is None else ctx.perturb(name, p[name])


def heads(cfg):
    hd = cfg.rwkv_head_dim
    assert cfg.d_model % hd == 0
    return cfg.d_model // hd, hd


def lora_rank(cfg) -> int:
    return 64 if cfg.d_model >= 512 else 16


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros / ``last`` at t=0). x: (B, S, D)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


def _mix(ctx, x, xx, mu):
    """The token-shift interpolations ``x + xx * mu[i]``, one for each row
    of ``mu`` ((k, D), per lane (n, k, D) under a user-axis ctx)."""
    return [x + xx * L.per_row(ctx, m, x) for m in mu.to(x.dtype).unbind(-2)]


def _timemix_inputs(cfg, p, x, x_prev, ctx=None):
    xx = x_prev - x
    xr, xk, xv, xw, xg = _mix(ctx, x, xx, _leaf(p, "mu", ctx))
    h, hd = heads(cfg)
    b, s, _ = x.shape
    r = L.dense(p["wr"], xr, _sub(ctx, "wr")).reshape(b, s, h, hd)
    k = L.dense(p["wk"], xk, _sub(ctx, "wk")).reshape(b, s, h, hd)
    v = L.dense(p["wv"], xv, _sub(ctx, "wv")).reshape(b, s, h, hd)
    g = F.silu(L.dense(p["wg"], xg, _sub(ctx, "wg")))
    # data-dependent per-channel decay in (0, 1), in f32; the LoRA's
    # products lane by lane under a user-axis ctx
    lora = L.lane_matmul(ctx, torch.tanh(L.lane_matmul(
        ctx, xw.to(_F32), _leaf(p, "w_lora_a", ctx))),
        _leaf(p, "w_lora_b", ctx))
    wlog = L.per_row(ctx, _leaf(p, "w0", ctx), lora) + lora
    w = torch.exp(-torch.exp(wlog)).reshape(b, s, h, hd)
    return r, k, v, g, w


def _wkv(ctx, r, k, v, w, bonus, state):
    """The WKV recurrence over (B, S, H, hd) inputs: y (B, S, H, hd) and
    the last state."""
    ys = []
    for t in range(r.shape[1]):                         # the WKV cell
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]   # (B, H, hd, hd)
        ys.append(L.lane_einsum(ctx, "bhk,bhkv->bhv", r[:, t],
                                state + bonus * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1), state


def _wkv_sharded(r, k, v, w, bonus, state):
    """:func:`_wkv` under a mesh, on this rank's batch rows and heads:
    the recurrence is independent a (row, head), so each rank runs it on
    its block (the batch as the inputs place it, the heads over
    ``model`` where they divide) and the results are placed back."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = r.device_mesh
    sizes = shd.axis_sizes(mesh)
    h = r.shape[2]
    tgt = []          # per mesh dim: "b" batch, "h" heads, None replicated
    for name, pl in zip(shd.axis_names(mesh), r.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            tgt.append("b")
        elif name == "model" and h % sizes[name] == 0:
            tgt.append("h")
        else:
            tgt.append(None)

    def local(t, b_dim, h_dim):
        if not shd.is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)
        pl = [Shard(b_dim) if g == "b" and b_dim is not None else
              Shard(h_dim) if g == "h" else Replicate() for g in tgt]
        return shd.settle(t).redistribute(mesh, pl).to_local(), pl

    (rl, pl4), (kl, _), (vl, _), (wl, _) = (local(t, 0, 2)
                                            for t in (r, k, v, w))
    sl, pl_state = local(state, 0, 1)
    bl, _ = local(bonus, None, 0)
    y, st = _wkv(None, rl, kl, vl, wl, bl, sl)
    shape_y = tuple(r.shape)
    y = DTensor.from_local(y, mesh, pl4, shape=shape_y,
                           stride=shd.contiguous_stride(shape_y))
    st = DTensor.from_local(st.contiguous(), mesh, pl_state,
                            shape=state.shape,
                            stride=shd.contiguous_stride(state.shape))
    return y, st


def timemix_apply(cfg, p, x, state=None, x_prev=None, ctx=None):
    """x: (B, S, D); state: (B, H, hd, hd) f32 keyed [k-dim, v-dim] or
    None. Returns y, (state, x_last)."""
    b, s, d = x.shape
    h, hd = heads(cfg)
    xp = _shift(x, x_prev)
    r, k, v, g, w = _timemix_inputs(cfg, p, x, xp, ctx)
    if state is None:
        state = torch.zeros((b, h, hd, hd), dtype=_F32, device=x.device)
    # the scan state head-sharded over the model axis under a mesh (the
    # reference's anchor against replicating the scan on every shard)
    state = shd.maybe_shard(state, None, "model", None, None)
    # (H, hd, 1): broadcast over the batch (and, per lane, over its rows)
    bonus = L.per_row(ctx, _leaf(p, "bonus", ctx), state, 3)[..., None]
    r, k, v = (t.to(_F32) for t in (r, k, v))
    if shd.is_dtensor(r):
        y, state = _wkv_sharded(r, k, v, w, bonus, state)
    else:
        y, state = _wkv(ctx, r, k, v, w, bonus, state)
    y = y.reshape(b, s, d)
    y = y.to(x.dtype)
    y = L.rmsnorm(y, L.per_row(ctx, _leaf(p, "ln_x", ctx), y)) * g
    return L.dense(p["wo"], y, _sub(ctx, "wo")), (state, x[:, -1:])


def channelmix_apply(cfg, p, x, x_prev=None, ctx=None):
    xp = _shift(x, x_prev)
    xx = xp - x
    xk, xr = _mix(ctx, x, xx, _leaf(p, "mu", ctx))
    r = torch.sigmoid(L.dense(p["wr"], xr, _sub(ctx, "wr")))
    k = torch.square(torch.relu(L.dense(p["wk"], xk, _sub(ctx, "wk"))))
    return r * L.dense(p["wv"], k, _sub(ctx, "wv")), x[:, -1:]

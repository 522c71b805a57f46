"""Mamba (selective SSM) layer -- the recurrent sublayer of jamba.

Port of the JAX package's ``models/mamba.py``. The selective scan runs
over time in a Python loop (ZO fine-tuning never backpropagates through
it); decode carries (conv window, ssm state) explicitly: the conv window
in the model dtype, the SSM state in f32.

The full-sequence apply threads an optional ``PerturbCtx``: dense
projections through ``ctx``-aware ``L.dense`` (``zo_matmul`` on the
card), the conv / SSM leaves through a transient ``ctx.perturb``
(``zo_add``) -- the hybrid family's fused ZO loss takes no transient
copy of the parameters. Under a user-axis ctx (lanes flattened in the
batch) the conv and SSM leaves meet only their own lane's rows
(``L.per_row``), ``dt_proj`` and the scan's one contraction a step run
lane by lane at the scalar path's shapes, and the rest of the selective
scan, elementwise in the batch, runs over every lane at once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.perturb_ctx import sub as _sub
from repro_torch.models import layers as L
from repro_torch.optim.quant import deq as _deq

_F32 = torch.float32


def _leaf(p, name, ctx):
    """p[name] + coeff*z under a ctx; the bare (dequantized) leaf
    without one."""
    return _deq(p[name]) if ctx is None else ctx.perturb(name, p[name])


def dims(cfg, d_model=None):
    """(d_model, d_inner, dt_rank)."""
    d = d_model or cfg.d_model
    return d, cfg.mamba_expand * d, max(1, d // 16)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as max(x, 0) + log1p(e^-|x|)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_inputs(cfg, p, xc, d_model=None, ctx=None):
    """xc: (B, S, di) post-conv. Returns dt, Bmat, Cmat (f32)."""
    _, _, dtr = dims(cfg, d_model)
    n = cfg.mamba_d_state
    proj = L.dense(p["x_proj"], xc, _sub(ctx, "x_proj")).to(_F32)
    dt_raw, bmat, cmat = torch.split(proj, [dtr, n, n], dim=-1)
    dtp = _sub(ctx, "dt_proj")
    dt = L.lane_matmul(ctx, dt_raw, _leaf(p["dt_proj"], "w", dtp).to(_F32))
    dt = _softplus(dt + L.per_row(ctx, _leaf(p["dt_proj"], "b", dtp),
                                  dt).to(_F32))
    return dt, bmat, cmat


def _scan_ssm(p, xc, dt, bmat, cmat, h0=None, ctx=None):
    """Selective scan. xc: (B, S, di); dt: (B, S, di); b/c: (B, S, n).
    Returns (y (B, S, di) in xc's dtype, final state (B, di, n) f32)."""
    a = -torch.exp(_leaf(p, "A_log", ctx))              # (di, n)
    bsz, s, di = xc.shape
    h = (torch.zeros((bsz, di, a.shape[-1]), dtype=_F32, device=xc.device)
         if h0 is None else h0)
    # the per-step decay and input, for every step at once (elementwise,
    # the same products the reference forms a step at a time)
    da = torch.exp(dt[..., None] * L.per_row(ctx, a, dt, 4))  # (B, S, di, n)
    dbx = (dt * xc.to(_F32))[..., None] * bmat[:, :, None, :]
    ys = []
    for t in range(s):
        h = da[:, t] * h + dbx[:, t]
        ys.append(L.lane_einsum(ctx, "bdn,bn->bd", h, cmat[:, t]))
    y = torch.stack(ys, dim=1) + xc.to(_F32) * L.per_row(
        ctx, _leaf(p, "D", ctx), xc)
    return y.to(xc.dtype), h


def _conv(p, window, s, d_conv, ctx=None):
    """Depthwise causal conv: output t reads window[t .. t + d_conv)."""
    conv_w = [L.per_row(ctx, w, window)
              for w in _leaf(p, "conv_w", ctx).unbind(-2)]
    out = window[:, 0:s] * conv_w[0]
    for i in range(1, d_conv):
        out = out + window[:, i:i + s] * conv_w[i]
    return out + L.per_row(ctx, _leaf(p, "conv_b", ctx), window)


def mamba_apply(cfg, p, x, d_model=None, ctx=None):
    """Full-sequence forward. x: (B, S, D) -> (B, S, D)."""
    d_conv = cfg.mamba_d_conv
    xz = L.dense(p["in_proj"], x, _sub(ctx, "in_proj"))
    xi, z = torch.chunk(xz, 2, dim=-1)
    window = F.pad(xi, (0, 0, d_conv - 1, 0))
    xc = F.silu(_conv(p, window, x.shape[1], d_conv, ctx))
    dt, bmat, cmat = _ssm_inputs(cfg, p, xc, d_model, ctx)
    y, _ = _scan_ssm(p, xc, dt, bmat, cmat, ctx=ctx)
    return L.dense(p["out_proj"], y * F.silu(z), _sub(ctx, "out_proj"))


def mamba_prefill(cfg, p, state, x, d_model=None):
    """Multi-token continuation from an explicit (conv, ssm) state:
    (out, new state after the last token); one token is the decode step
    (the reference's ``mamba_step``). From a zero state this equals
    ``mamba_apply``."""
    d_conv = cfg.mamba_d_conv
    s = x.shape[1]
    xz = L.dense(p["in_proj"], x)
    xi, z = torch.chunk(xz, 2, dim=-1)                  # (B, S, di)
    window = torch.cat([state["conv"].to(xi.dtype), xi], dim=1)
    xc = F.silu(_conv(p, window, s, d_conv))
    dt, bmat, cmat = _ssm_inputs(cfg, p, xc, d_model)
    y, h = _scan_ssm(p, xc, dt, bmat, cmat, h0=state["ssm"])
    out = L.dense(p["out_proj"], y * F.silu(z))
    return out, {"conv": window[:, s:, :], "ssm": h}

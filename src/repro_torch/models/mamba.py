"""Mamba (selective SSM) layer -- the recurrent sublayer of jamba.

Port of the JAX package's ``models/mamba.py``. The selective scan is
``kernels.ops.selective_scan``: on the card the ``selective_scan``
kernel, on the CPU its plain version, a Python loop over time (ZO
fine-tuning never backpropagates through it); decode carries (conv
window, ssm state) explicitly: the conv window in the model dtype, the
SSM state in f32. ``cfg.mamba_inner_norm`` (Jamba's mixer, which the JAX
package lacks) RMS-normalizes ``dt``'s low-rank input, B and C right
after ``x_proj``, each with a scale leaf of its own (``dt_norm``,
``b_norm``, ``c_norm``).

The full-sequence apply threads an optional ``PerturbCtx``: dense
projections through ``ctx``-aware ``L.dense`` (``zo_matmul`` on the
card), the conv / SSM leaves through a transient ``ctx.perturb``
(``zo_add``) -- the hybrid family's fused ZO loss takes no transient
copy of the parameters. Under a user-axis ctx (lanes flattened in the
batch) the conv and SSM leaves meet only their own lane's rows
(``L.per_row``), ``dt_proj`` runs lane by lane at the scalar path's
shapes, and the selective scan takes each lane's leaves for its rows: one
launch of the kernel over every lane on the card, the plain version lane
by lane on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.perturb_ctx import sub as _sub
from repro_torch.core.spans import span
from repro_torch.kernels import ops as kops
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


def _ssm_inputs(cfg, p, xc, d_model=None, ctx=None):
    """xc: (B, S, di) post-conv. Returns dt before its bias and softplus
    (f32), the ``dt_proj`` bias leaf, B and C (f32)."""
    _, _, dtr = dims(cfg, d_model)
    n = cfg.mamba_d_state
    proj = L.dense(p["x_proj"], xc, _sub(ctx, "x_proj")).to(_F32)
    dt_raw, bmat, cmat = torch.split(proj, [dtr, n, n], dim=-1)
    if cfg.mamba_inner_norm:
        dt_raw, bmat, cmat = (
            L.rmsnorm(t, L.per_row(ctx, _leaf(p[name], "scale",
                                              _sub(ctx, name)), t))
            for name, t in (("dt_norm", dt_raw), ("b_norm", bmat),
                            ("c_norm", cmat)))
    dtp = _sub(ctx, "dt_proj")
    dt = L.lane_matmul(ctx, dt_raw, _leaf(p["dt_proj"], "w", dtp).to(_F32))
    return dt, _leaf(p["dt_proj"], "b", dtp), bmat, cmat


def _scan_ssm(p, xc, z, dt, bias, bmat, cmat, h0=None, ctx=None):
    """The selective scan gated by ``silu(z)``: (y (B, S, di) in xc's
    dtype, final state (B, di, n) f32). Under a user-axis ctx the leaves
    come per lane, each lane's on its own rows."""
    with span("mamba.scan"):
        return kops.selective_scan(xc, dt, bias, _leaf(p, "A_log", ctx),
                                   bmat, cmat, _leaf(p, "D", ctx), z, h0)


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
    y, _ = _scan_ssm(p, xc, z, *_ssm_inputs(cfg, p, xc, d_model, ctx),
                     ctx=ctx)
    return L.dense(p["out_proj"], y, _sub(ctx, "out_proj"))


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
    y, h = _scan_ssm(p, xc, z, *_ssm_inputs(cfg, p, xc, d_model),
                     h0=state["ssm"])
    out = L.dense(p["out_proj"], y)
    return out, {"conv": window[:, s:, :], "ssm": h}

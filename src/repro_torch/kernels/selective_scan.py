"""Mamba-1's selective scan, forward only: plain version and CUDA launcher.

Replaces no Pallas kernel: the JAX package's ``models/mamba.py`` scans
with ``lax.scan``. For x (B, S, di), dt (B, S, di) before its bias and
softplus, B and C (B, S, n), the leaves ``dt_bias`` (di,), ``A_log``
(di, n) and ``D`` (di,), and z (B, S, di), both forms compute

    delta = softplus(dt + dt_bias)
    h_t   = exp(delta_t * A) * h_{t-1} + (delta_t * x_t) B_t,  A = -exp(A_log)
    y_t   = (C_t . h_t + D x_t) * silu(z_t)

from ``h0`` (B, di, n) f32 or zeros, and return (y in x's dtype, the
last h (B, di, n) f32).

:func:`selective_scan_ref` is the port's scan as the JAX package writes
it: the decay and the input of every step formed at once as
(B, S, di, n) f32 tensors, then a loop over time, ``C . h + D x`` rounded
to x's dtype before the gate ``silu(z)``. It is the CPU path and the
oracle.

Both take the three leaves either shared by every row or with a leading
lane axis (U lanes, each on B / U consecutive rows: the user-axis
forward's lanes, ``dt_bias`` (U, di), ``A_log`` (U, di, n), ``D`` (U,
di)). The plain version then runs lane by lane at one lane's shapes, so
that each lane computes as the shared form does on its rows alone.

:func:`selective_scan_cuda` launches ``csrc/selective_scan.cu``: one
thread a (b, d) channel holding its n states in f32 registers; no
(B, S, di, n) tensor. It rounds once, after the gate, and takes ``exp``
as ``ex2.approx``: within the f32 tolerance of ``tests/test_torch_gpu.py``
of the plain version, not bit for bit. A channel's arithmetic does not
depend on the batch, so a lane of a launch over U lanes equals the shared
form's launch on its rows bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import launch

_F32 = torch.float32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the state widths the kernel is built for
KERNEL_STATES = (4, 8, 16)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as max(x, 0) + log1p(e^-|x|)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def selective_scan_ref(x, dt, dt_bias, a_log, bmat, cmat, d, z, h0=None):
    """Plain version (module docstring)."""
    if a_log.dim() == 3:                        # lane by lane
        rows = x.shape[0] // _lanes(x, a_log)
        parts = [selective_scan_ref(*args) for args in zip(
            x.split(rows), dt.split(rows), dt_bias, a_log, bmat.split(rows),
            cmat.split(rows), d, z.split(rows),
            h0.split(rows) if h0 is not None else [None] * a_log.shape[0])]
        return (torch.cat([y for y, _ in parts]),
                torch.cat([h for _, h in parts]))
    dt = _softplus(dt + dt_bias.to(_F32))
    a = -torch.exp(a_log)
    bsz, s, di = x.shape
    h = (torch.zeros((bsz, di, a.shape[-1]), dtype=_F32, device=x.device)
         if h0 is None else h0)
    # the per-step decay and input, for every step at once (elementwise,
    # the same products the reference forms a step at a time)
    da = torch.exp(dt[..., None] * a)                      # (B, S, di, n)
    dbx = (dt * x.to(_F32))[..., None] * bmat[:, :, None, :]
    ys = []
    for t in range(s):
        h = da[:, t] * h + dbx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, t]))
    y = torch.stack(ys, dim=1) + x.to(_F32) * d
    return y.to(x.dtype) * F.silu(z), h


def _lanes(x, a_log) -> int:
    """The lanes of the leaves (1: shared), dividing x's batch."""
    u = a_log.shape[0] if a_log.dim() == 3 else 1
    if u < 1 or x.shape[0] % u:
        raise ValueError(f"selective_scan: {u} lanes of leaves for a batch "
                         f"of {x.shape[0]} rows")
    return u


def _rows(name, t, bsz, s, di):
    """The stride between (b, t) rows of an activation (B, S, di) whose
    last dim is dense and whose rows are evenly spaced."""
    if t.shape != (bsz, s, di) or t.stride(2) != 1 or (
            bsz > 1 and t.stride(0) != s * t.stride(1)):
        raise ValueError(f"selective_scan: {name} must be ({bsz}, {s}, "
                         f"{di}) with evenly spaced dense rows, got "
                         f"{tuple(t.shape)} strides {t.stride()}")
    return t.stride(1)


def selective_scan_cuda(x, dt, dt_bias, a_log, bmat, cmat, d, z, h0=None):
    """Launch the kernel on ``torch.cuda.current_stream()``: x and z of one
    dtype (float32 or bfloat16) with evenly spaced dense rows (z may be a
    view of in_proj's output), n in :data:`KERNEL_STATES`, the leaves
    shared or per lane; the leaves and B, C are made contiguous f32
    here."""
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan: x must be a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES or z.dtype != x.dtype:
        raise TypeError(f"selective_scan takes x and z of one dtype, "
                        f"float32 or bfloat16; got {x.dtype}, {z.dtype}")
    bsz, s, di = x.shape
    n = a_log.shape[-1]
    u = _lanes(x, a_log)
    lead = (u,) if a_log.dim() == 3 else ()
    if a_log.shape != lead + (di, n) or n not in KERNEL_STATES:
        raise ValueError(f"selective_scan: A_log must be {lead + (di,)} + "
                         f"(n,) with n in {KERNEL_STATES}, got "
                         f"{tuple(a_log.shape)}")
    x_stride = _rows("x", x, bsz, s, di)
    z_stride = _rows("z", z, bsz, s, di)
    for name, t, shape in (("dt", dt, (bsz, s, di)), ("B", bmat, (bsz, s, n)),
                           ("C", cmat, (bsz, s, n)),
                           ("dt_bias", dt_bias, lead + (di,)),
                           ("D", d, lead + (di,))):
        if t.shape != shape:
            raise ValueError(f"selective_scan: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if h0 is not None and h0.shape != (bsz, di, n):
        raise ValueError(f"selective_scan: h0 must be {(bsz, di, n)}, got "
                         f"{tuple(h0.shape)}")
    f32 = [t.to(_F32).contiguous() for t in (dt, dt_bias, a_log, bmat, cmat,
                                             d)]
    h0 = None if h0 is None else h0.to(_F32).contiguous()
    y = torch.empty((bsz, s, di), dtype=x.dtype, device=x.device)
    h = torch.empty((bsz, di, n), dtype=_F32, device=x.device)
    if y.numel() == 0:
        return y, h.copy_(h0) if h0 is not None else h.zero_()
    dtp, biasp, alogp, bp, cp, dp = (t.data_ptr() for t in f32)
    launch("selective_scan", "repro_selective_scan", x.data_ptr(), dtp,
           biasp, alogp, bp, cp, dp, z.data_ptr(),
           None if h0 is None else h0.data_ptr(), y.data_ptr(),
           h.data_ptr(), _DTYPES[x.dtype], bsz, s, di, n, bsz // u,
           x_stride, z_stride,
           torch.cuda.current_stream(x.device).cuda_stream)
    return y, h

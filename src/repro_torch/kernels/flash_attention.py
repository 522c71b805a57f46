"""Forward-only flash attention (GQA, causal or bidirectional): plain
version and CUDA launcher.

Port of the JAX package's ``kernels/flash_attention.py``. ZO training
has no backward pass, so the inference kernel is the training kernel.

Layout: q (B, S, H, hd); k/v (B, T, KV, hd); out (B, S, H, hd) in q's
dtype. Causal masking compares absolute positions from 0 on both sides
(query i reads keys <= i), as the Pallas kernel's block iotas do.

:func:`flash_attention_ref` is the plain version of ``_flash_kernel``'s
arithmetic: q cast to f32 and scaled by the f32 ``1 / sqrt(hd)``, f32
scores, ``-1e30`` masking, softmax numerator and ``p @ f32(v)`` in f32,
the ``max(l, 1e-30)`` denominator, then the cast to q's dtype. (The
plain ``layers.attention`` rounds the probabilities to the activation
dtype before ``p @ v``; this does not.) :func:`flash_attention_cuda`
launches ``csrc/flash_attention.cu``: bf16 takes its tensor-core body
(bf16 scores exact in f32, P rounded to bf16 for ``P @ V``, inside the
bf16 limit), f32 its SIMT body.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.build import body, launch
from repro_torch.kernels.flash_decode import _DTYPES, KERNEL_HEAD_DIMS

_NEG_INF = -1e30


def _scale(hd: int) -> float:
    """The reference's ``1.0 / float(hd) ** 0.5`` rounded to f32."""
    return float(np.float32(1.0 / float(hd) ** 0.5))


def flash_attention_ref(q, k, v, causal: bool = True):
    """Plain version: q (B, S, H, hd), k/v (B, T, KV, hd)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.to(torch.float32).reshape(b, s, kvh, g, hd) * _scale(hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qf, k.to(torch.float32))
    if causal:
        live = (torch.arange(s, device=q.device)[:, None]
                >= torch.arange(t, device=q.device)[None, :])
        scores = scores.masked_fill(~live, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.to(torch.float32))
    out = out / denom.permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, h, hd).to(q.dtype)


def flash_attention_cuda(q, k, v, causal: bool = True):
    """Launch the kernel on ``torch.cuda.current_stream()``: contiguous
    CUDA tensors of one dtype (float32 or bfloat16), H a multiple of KV,
    hd in :data:`KERNEL_HEAD_DIMS`."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} must be a CUDA "
                             f"tensor, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if x.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"{tuple(x.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes one dtype, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd
            or kvh == 0 or h % kvh):
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"{KERNEL_HEAD_DIMS}")
    out = torch.empty_like(q)
    if out.numel() == 0 or t == 0:
        return out.zero_()
    launch("flash_attention", "repro_flash_attention", q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b,
           s, t, h, kvh, hd, int(causal), _scale(hd),
           torch.cuda.current_stream(q.device).cuda_stream,
           body=body("repro_flash_attention_body", _DTYPES[q.dtype]))
    return out

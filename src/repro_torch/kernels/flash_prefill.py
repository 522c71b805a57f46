"""Chunked prefill attention into a paged KV cache: plain version and
CUDA launcher.

Port of the JAX package's ``kernels/flash_prefill.py``. A C-token prompt
chunk whose K/V the caller has already scattered into the slot's pages
attends to every cached position up to its own: chunk offset c of slot b
sits at position ``pos[b] + c`` and reads positions ``<= pos[b] + c``
(earlier chunks plus causal masking inside the chunk).

Layout: q (B, C, H, hd); k/v pools (n_pages, page_size, KV, hd); pages
(B, n_live); pos (B,) chunk-start positions. :func:`prefill_attn_ref` is
the plain version; at C = 1 it is the same math as ``paged_attn_ref``.
:func:`flash_prefill` launches ``csrc/flash_prefill.cu``: bf16 takes its
tensor-core body (bf16 scores exact in f32, P rounded to bf16 for
``P @ V`` as the plain version rounds it), f32 its SIMT body; the body
is counted in ``BODIES["flash_prefill/tc"]`` / ``.../simt``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import body, launch
from repro_torch.kernels.flash_decode import _DTYPES, check_paged_args


def flash_prefill(q, k_pages, v_pages, pages, pos):
    """q: (B, C, H, hd); pools (NP, ps, KV, hd); pages (B, n_live) int32;
    pos (B,) int32 -> (B, C, H, hd), launched on the current stream. The
    table must cover ``pos + C - 1``."""
    check_paged_args("flash_prefill", q, k_pages, v_pages, pages, pos, 4)
    b, c, h, hd = q.shape
    _, ps, kvh, _ = k_pages.shape
    out = torch.empty_like(q)
    launch("flash_prefill", "repro_flash_prefill", q.data_ptr(),
           k_pages.data_ptr(), v_pages.data_ptr(), pages.data_ptr(),
           pos.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, c, h, kvh,
           hd, ps, pages.shape[1], 1.0 / math.sqrt(hd),
           torch.cuda.current_stream(q.device).cuda_stream,
           body=body("repro_flash_prefill_body", _DTYPES[q.dtype]))
    return out


def prefill_attn_ref(q, k_pages, v_pages, pages, pos):
    """Plain version: gather the live pages into logical order and run
    masked GQA attention with a per-(slot, offset) limit
    ``k_pos <= pos + c`` as one 3-D kv_mask."""
    from repro_torch.models.layers import attention
    b, c, h, hd = q.shape
    _, ps, kvh, _ = k_pages.shape
    n_live = pages.shape[1]
    pages = pages.long()
    kk = k_pages[pages].reshape(b, n_live * ps, kvh, hd)
    vv = v_pages[pages].reshape(b, n_live * ps, kvh, hd)
    qpos = pos.long()[:, None] + torch.arange(c, device=q.device)[None, :]
    valid = (torch.arange(n_live * ps, device=q.device)[None, None, :]
             <= qpos[:, :, None])
    return attention(q, kk, vv, causal=False, kv_mask=valid, chunk=0)

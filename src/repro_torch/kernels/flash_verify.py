"""Short-window verify attention over a paged KV cache: plain version and
CUDA launcher.

Port of the JAX package's ``kernels/flash_verify.py``. Speculative
decoding scores a window of W = k + 1 candidate tokens per slot in one
call: window offset w of slot b sits at position ``pos[b] + w`` and
reads every cached position ``<= pos[b] + w`` (the page-table gather of
flash-decoding plus causal masking inside the window). The window's own
K/V has already been scattered into the slot's pages by the caller, so
the read is pure page reads.

Layout: q (B, W, H, hd); k/v pools (n_pages, page_size, KV, hd); pages
(B, n_live); pos (B,) each slot's first window position.
:func:`verify_attn_ref` is the plain version; at W = 1 it is the same
math as ``paged_attn_ref``. :func:`flash_verify` launches
``csrc/flash_verify.cu``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import launch
from repro_torch.kernels.flash_decode import _DTYPES, check_paged_args
from repro_torch.kernels.flash_prefill import prefill_attn_ref


def flash_verify(q, k_pages, v_pages, pages, pos):
    """q: (B, W, H, hd); pools (NP, ps, KV, hd); pages (B, n_live) int32;
    pos (B,) int32 -> (B, W, H, hd), launched on the current stream.
    Offset w of slot b reads positions <= pos[b] + w and nothing later
    (the rest of the window, the dead tail, trash-page table entries)."""
    check_paged_args("flash_verify", q, k_pages, v_pages, pages, pos, 4)
    b, w, h, hd = q.shape
    _, ps, kvh, _ = k_pages.shape
    out = torch.empty_like(q)
    launch("flash_verify", "repro_flash_verify", q.data_ptr(),
           k_pages.data_ptr(), v_pages.data_ptr(), pages.data_ptr(),
           pos.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, w, h, kvh,
           hd, ps, pages.shape[1], 1.0 / math.sqrt(hd),
           torch.cuda.current_stream(q.device).cuda_stream)
    return out


def verify_attn_ref(q, k_pages, v_pages, pages, pos):
    """Plain version: gather the live pages into logical order and run
    masked GQA attention with a per-(slot, offset) limit
    ``k_pos <= pos + w`` -- the chunk read of ``prefill_attn_ref``, whose
    mask is the same."""
    return prefill_attn_ref(q, k_pages, v_pages, pages, pos)

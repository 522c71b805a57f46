"""Flash-decoding over a paged KV cache: plain version and CUDA launcher.

Port of the JAX package's ``kernels/flash_decode.py``. Decode is
single-token attention: one query row per slot against everything that
slot has cached, read as fixed-size pages through a per-slot page table.

Layout: q (B, H, hd) -- one token per slot; k/v pools
(n_pages, page_size, KV, hd); pages (B, n_live) physical page ids; pos
(B,) each slot's current position. GQA: the G = H // KV query heads of
one KV head share a block. Positions > pos[b] are masked; pages past
``pos[b] // page_size`` are never read by the kernel.

:func:`paged_attn_ref` is the plain version (gather + masked softmax),
the CPU path and the kernel's yardstick on the card; :func:`flash_decode`
launches ``csrc/flash_decode.cu``. The TPU's MXU head-dim gate does not
carry over: the kernel is built for :data:`KERNEL_HEAD_DIMS`.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import launch

#: head dims the CUDA attention kernels are instantiated for
KERNEL_HEAD_DIMS = (16, 32, 64, 112, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_paged_args(kernel: str, q, k_pages, v_pages, pages, pos,
                     q_rank: int):
    """Validate the CUDA launchers' inputs; raise on anything the kernels
    do not take (never fall back)."""
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "pages": pages, "pos": pos}
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if name not in ("pages", "pos") and t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{kernel}: q must be float32/bfloat16, got "
                        f"{q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"{kernel}: q, k_pages and v_pages must share a "
                        f"dtype")
    if pages.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"{kernel}: pages and pos must be int32")
    if q.dim() != q_rank or k_pages.dim() != 4 or k_pages.shape != \
            v_pages.shape:
        raise ValueError(f"{kernel}: bad shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    b, h, hd = q.shape[0], q.shape[-2], q.shape[-1]
    kvh = k_pages.shape[2]
    if k_pages.shape[3] != hd or h % kvh:
        raise ValueError(f"{kernel}: q heads {h} x {hd} do not fit pools "
                         f"{tuple(k_pages.shape)}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {hd} not built; supported "
                         f"head dims: {list(KERNEL_HEAD_DIMS)}")
    if pages.dim() != 2 or pages.shape[0] != b or tuple(pos.shape) != (b,):
        raise ValueError(f"{kernel}: pages {tuple(pages.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {b}")


def flash_decode(q, k_pages, v_pages, pages, pos):
    """q: (B, H, hd); pools (NP, ps, KV, hd); pages (B, n_live) int32;
    pos (B,) int32 -> (B, H, hd), launched on the current stream."""
    check_paged_args("flash_decode", q, k_pages, v_pages, pages, pos, 3)
    b, h, hd = q.shape
    _, ps, kvh, _ = k_pages.shape
    out = torch.empty_like(q)
    launch("flash_decode", "repro_flash_decode", q.data_ptr(),
           k_pages.data_ptr(), v_pages.data_ptr(), pages.data_ptr(),
           pos.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, h, kvh, hd,
           ps, pages.shape[1], 1.0 / math.sqrt(hd),
           torch.cuda.current_stream(q.device).cuda_stream)
    return out


def paged_attn_ref(q, k_pages, v_pages, pages, pos):
    """Plain version: gather the live pages back into logical order and
    run masked GQA attention over them (n_live * ps keys, not S_max)."""
    from repro_torch.models.layers import attention
    b, h, hd = q.shape
    _, ps, kvh, _ = k_pages.shape
    n_live = pages.shape[1]
    pages = pages.long()
    kk = k_pages[pages].reshape(b, n_live * ps, kvh, hd)
    vv = v_pages[pages].reshape(b, n_live * ps, kvh, hd)
    valid = (torch.arange(n_live * ps, device=q.device)[None, :]
             <= pos.long()[:, None])
    out = attention(q[:, None], kk, vv, causal=False, kv_mask=valid,
                    chunk=0)
    return out[:, 0]

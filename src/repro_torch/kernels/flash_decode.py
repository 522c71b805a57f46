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

Two routes, by G = H // KV alone: G = 1 takes the slot route, one block
per (slot, KV head); G >= 2 the split route, flash-decoding: each slot's
positions in chunks of :func:`split_plan`'s length, a block per (slot, KV
head, chunk) writing the G rows' f32 partials (m, l, acc) to a workspace,
and a second kernel merging a row's chunks in chunk order. A chunk runs
on true-f32 SIMT FMAs, or for bf16 at G 8-16 on the tensor cores (P
rounded to bf16 for P V, as the plain version rounds it), as the C
side's ``repro_flash_decode_split_body`` picks.
:func:`paged_attn_split_ref` is the plain model of that split (its
chunking and merge order, in f32), held to the JAX kernel on the CPU.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import body, launch

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


def split_plan(hd: int, n_keys: int):
    """(chunk, n_chunks) of the split route: chunks of 64 * max(ceil(n_keys
    / 2048), min(256 // hd, ceil(n_keys / 128))) positions, a multiple of
    every tile. Up to 2048 positions a chunk holds about 64 KB of bf16 K/V
    (64 keys at hd 256, 128 at 112 and 128, 256 at 64), fewer at short
    tables (64 keys below 256 positions, so a short slot still spans 2
    blocks); past 2048, ceil(n_keys / chunk) <= 32 chunks. ``n_keys`` is
    the page table's width in positions (n_live * ps): the plan never
    depends on B, on ``pos``, on G or on the card."""
    chunk = 64 * max(-(-n_keys // 2048),
                     min(max(256 // hd, 1), -(-n_keys // 128)))
    return chunk, -(-n_keys // chunk)


def decode_route(h: int, kvh: int) -> str:
    """``"slot"`` for G = H // KV = 1 (one block per slot and KV head),
    ``"split"`` for every GQA / MQA layout."""
    return "slot" if h == kvh else "split"


def flash_decode(q, k_pages, v_pages, pages, pos):
    """q: (B, H, hd); pools (NP, ps, KV, hd); pages (B, n_live) int32;
    pos (B,) int32 -> (B, H, hd), launched on the current stream, on
    :func:`decode_route`'s route."""
    check_paged_args("flash_decode", q, k_pages, v_pages, pages, pos, 3)
    b, h, hd = q.shape
    _, ps, kvh, _ = k_pages.shape
    n_live = pages.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if decode_route(h, kvh) == "slot":
        launch("flash_decode", "repro_flash_decode", q.data_ptr(),
               k_pages.data_ptr(), v_pages.data_ptr(), pages.data_ptr(),
               pos.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, h, kvh,
               hd, ps, n_live, 1.0 / math.sqrt(hd), stream, body="slot")
        return out
    g = h // kvh
    chunk, n_chunks = split_plan(hd, n_live * ps)
    ws = torch.empty((b, kvh, n_chunks, g, hd + 2), dtype=torch.float32,
                     device=q.device)
    tc = body("repro_flash_decode_split_body", _DTYPES[q.dtype], g) == "tc"
    launch("flash_decode", "repro_flash_decode_split", q.data_ptr(),
           k_pages.data_ptr(), v_pages.data_ptr(), pages.data_ptr(),
           pos.data_ptr(), ws.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
           b, h, kvh, hd, ps, n_live, chunk, n_chunks, 1.0 / math.sqrt(hd),
           stream, body=("split", "split_tc") if tc else "split")
    return out


def paged_attn_split_ref(q, k_pages, v_pages, pages, pos, round_p=False):
    """Plain model of the split route, in f32 (the SIMT body's arithmetic;
    ``round_p``: the tensor-core body's, which rounds P to bf16 for P V
    and sums l from the unrounded P): each slot's positions
    0 .. min(pos, n_live * ps - 1) in :func:`split_plan`'s chunks, each
    chunk's partial (m, l, acc) over its keys alone (a chunk past ``pos``
    the empty partial: m -1e30, l 0, acc 0), then the chunks merged in
    chunk order -- m the max, weight exp(m_c - m) (0 for an empty chunk),
    l and acc summed in order -- and out = acc / max(l, 1e-30). Reads
    only the live positions (garbage elsewhere cannot reach the output).
    Returns f32 (B, H, hd) on q's device."""
    b, h, hd = q.shape
    _, ps, kvh, _ = k_pages.shape
    g = h // kvh
    n_live = pages.shape[1]
    dev = q.device
    chunk, n_chunks = split_plan(hd, n_live * ps)
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(b, kvh, g, hd)
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=dev)
    neg = torch.tensor(-1e30, device=dev)
    zero = torch.zeros((), device=dev)
    for i in range(b):
        last = min(int(pos[i]), n_live * ps - 1)
        t = torch.arange(last + 1, device=dev)
        phys = pages[i].long()[t // ps]
        kk = k_pages[phys, t % ps].float()               # (T, KV, hd)
        vv = v_pages[phys, t % ps].float()
        parts = []
        for c in range(n_chunks):
            t0 = c * chunk
            if t0 > last:
                parts.append((neg.expand(kvh, g),
                              torch.zeros(kvh, g, device=dev),
                              torch.zeros(kvh, g, hd, device=dev)))
                continue
            kc, vc = kk[t0:t0 + chunk], vv[t0:t0 + chunk]
            s = torch.einsum("kgd,tkd->kgt", qf[i], kc)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            pv = p.to(torch.bfloat16).float() if round_p else p
            parts.append((m, p.sum(-1),
                          torch.einsum("kgt,tkd->kgd", pv, vc)))
        mm = torch.stack([m for m, _, _ in parts]).amax(0)
        den = torch.zeros(kvh, g, device=dev)
        acc = torch.zeros(kvh, g, hd, device=dev)
        for m, l, a in parts:
            w = torch.where(m == neg, zero, torch.exp(m - mm))
            den = den + w * l
            acc = acc + w[..., None] * a
        out[i] = acc / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(b, h, hd)


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

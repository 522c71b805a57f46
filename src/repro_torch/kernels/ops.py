"""Kernel dispatch: the device of the input decides.

Each wrapper takes the plain PyTorch version for a tensor on the CPU and
launches the hand-written CUDA kernel (``src/repro_torch/csrc``) for a
tensor on a CUDA device -- never a fallback: a CUDA input the kernel
does not take, a failed build or a failed launch raises. Launches are
counted in :data:`LAUNCHES` (``LAUNCHES["zo_add"]`` and so on), and
the two-body kernels' launches by body in :data:`BODIES`
(``BODIES["zo_matmul/tc"]``: bf16 tensor cores, of them the Hopper
body's launches also in ``.../tc_tma``; ``.../simt``; also
``flash_attention``, ``flash_prefill`` and ``flash_verify``).

A DTensor (the sharded step: ``models/sharding.py``; the tensor-level
helpers are ``core/dtensor.py``'s) takes the local form of ``zo_add``
and ``zo_matmul``: the kernel (or its plain version) runs on this rank's
shard at the shard's global offsets, so its z is
the unsharded z's slice, and the result is wrapped back as a DTensor.
``zo_matmul`` takes the two Megatron placements of W on a mesh dim --
column-parallel (``Shard(1)``: the output ``Shard(-1)``) and row-parallel
(``Shard(0)``: X sharded on the contraction, or replicated and sliced
locally; the output ``Partial()``, reduced once where it is read) -- and
a replicated W with X replicated or batch-sharded; any other placement
raises, as do the int8 and user-batched kernels on a DTensor.
"""

from __future__ import annotations

import torch

from repro_torch.core.dtensor import (contiguous_stride, is_dtensor,
                                      local_offsets)
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import flash_verify as _fv
from repro_torch.kernels import selective_scan as _ss
from repro_torch.kernels import zo_perturb as _zo
from repro_torch.kernels.build import BODIES, LAUNCHES, reset_launches

__all__ = ["BODIES", "LAUNCHES", "reset_launches", "zo_add", "zo_matmul",
           "zo_add_users", "zo_matmul_users", "flash_attention",
           "paged_decode_attn", "paged_prefill_attn", "paged_verify_attn",
           "selective_scan"]


def _on_cpu(kernel: str, t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{kernel}: no kernel for device {t.device}")


def _no_partial(t, kernel: str):
    from torch.distributed.tensor import Partial
    if any(isinstance(p, Partial) for p in t.placements):
        raise ValueError(f"{kernel}: a Partial DTensor has no local form "
                         f"({t.placements})")


def _zo_add_sharded(w, seed, salt, coeff, dist, prime_offset, prehashed,
                    out):
    """:func:`zo_add` of a DTensor leaf: this rank's shard at its global
    offsets, wrapped back with the leaf's placements (in place into
    ``out``'s shard, if given)."""
    from torch.distributed.tensor import DTensor
    _no_partial(w, "zo_add")
    dst = None
    if out is not None:
        if not is_dtensor(out) or out.placements != w.placements:
            raise ValueError("zo_add: out must be a DTensor placed as w")
        dst = out._local_tensor
    res = zo_add(w._local_tensor, seed, salt, coeff, dist, prime_offset,
                 prehashed, out=dst, offsets=local_offsets(w))
    if out is not None:
        return out
    return DTensor.from_local(res, w.device_mesh, w.placements,
                              shape=w.shape,
                              stride=contiguous_stride(w.shape))


def zo_add(w, seed, salt: int, coeff, dist: str = "rademacher",
           prime_offset: int = 0, prehashed: bool = False, out=None,
           scale=None, offsets=None):
    """``w + coeff * z(seed, salt)`` in ``w``'s dtype, for a leaf of any
    rank (the kernel masks its own edges; no alignment gate). ``out``
    (may be ``w`` itself) receives the result. ``offsets``: ``w``'s
    global position as a shard of a larger leaf (default zeros); a
    DTensor ``w`` supplies its own (module docstring).

    ``scale`` (f32, ``w.shape[:-2] + (N,)``) marks ``w`` as an int8 base:
    the result is then the f32 ``w * scale + coeff * z``, from the
    ``zo_add_q`` kernel on the card (counted as ``zo_add_q``)."""
    if is_dtensor(w):
        if scale is not None or offsets is not None:
            raise ValueError("zo_add: a DTensor leaf takes neither scale= "
                             "nor offsets=")
        return _zo_add_sharded(w, seed, salt, coeff, dist, prime_offset,
                               prehashed, out)
    if scale is not None:
        if offsets is not None and any(offsets):
            raise ValueError("zo_add(scale=): the int8 kernel takes no "
                             "shard offsets")
        if out is not None:
            raise ValueError("zo_add(scale=) returns a new f32 tensor; "
                             "out= is not taken")
        if _on_cpu("zo_add_q", w):
            return _zo.zo_add_q_ref(w, scale, seed, salt, coeff, dist,
                                    prime_offset, prehashed)
        return _zo.zo_add_q_cuda(w, scale, seed, salt, coeff, dist,
                                 prime_offset, prehashed)
    if _on_cpu("zo_add", w):
        res = _zo.zo_add_ref(w, seed, salt, coeff, dist, prime_offset,
                             prehashed, offsets=offsets)
        return res if out is None else out.copy_(res)
    return _zo.zo_add_cuda(w, seed, salt, coeff, dist, prime_offset,
                           prehashed, out=out, offsets=offsets)


def zo_matmul_sharded(x, w, seed, salt: int, coeff, dist: str = "rademacher",
                      prime_offset: int = 0, prehashed: bool = False):
    """``x @ (w + coeff * z)`` for a DTensor W (K, N) and x (..., K) (a
    DTensor, or a plain tensor taken as replicated): the kernel on this
    rank's shards at W's global offsets, the result a DTensor (..., N)
    placed by the rule in the module docstring."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    _no_partial(w, "zo_matmul")
    mesh = w.device_mesh
    if is_dtensor(x):
        if x.device_mesh != mesh:
            raise ValueError("zo_matmul: x and w on different meshes")
        _no_partial(x, "zo_matmul")
        xl, xps = x._local_tensor, x.placements
    else:
        xl, xps = x, (Replicate(),) * mesh.ndim
    wl = w._local_tensor
    row0, col0 = local_offsets(w)
    last = x.dim() - 1
    out_pl = []
    for wp, xp in zip(w.placements, xps):
        x_shards_k = isinstance(xp, Shard) and xp.dim % x.dim() == last
        if isinstance(wp, Replicate):
            if x_shards_k:
                raise ValueError(f"zo_matmul: x sharded on the contraction "
                                 f"with W replicated ({xps}, {w.placements})")
            out_pl.append(xp)
        elif isinstance(wp, Shard) and wp.dim % 2 == 1:    # column-parallel
            if not isinstance(xp, Replicate):
                raise ValueError(f"zo_matmul: column-parallel W needs x "
                                 f"replicated on its mesh dim ({xps})")
            out_pl.append(Shard(last))
        elif isinstance(wp, Shard):                        # row-parallel
            if not (x_shards_k or isinstance(xp, Replicate)):
                raise ValueError(f"zo_matmul: row-parallel W needs x "
                                 f"sharded on the contraction ({xps})")
            out_pl.append(Partial())
        else:
            raise ValueError(f"zo_matmul: no local form for W placed "
                             f"{w.placements}")
    k_loc = wl.shape[0]
    if xl.shape[-1] != k_loc:             # replicated x: this rank's slice
        xl = xl[..., row0:row0 + k_loc]
    lead = xl.shape[:-1]
    y = zo_matmul(xl.reshape(-1, k_loc).contiguous(), wl, seed, salt, coeff,
                  dist, prime_offset, prehashed, offsets=(row0, col0))
    y = y.reshape(*lead, wl.shape[1])
    shape = tuple(x.shape[:-1]) + (w.shape[1],)
    return DTensor.from_local(y, mesh, out_pl, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def zo_matmul(x, w, seed, salt: int, coeff, dist: str = "rademacher",
              prime_offset: int = 0, prehashed: bool = False, scale=None,
              offsets=None):
    """``x @ (w + coeff * z(seed, salt))`` for x (M, K), w (K, N), the
    Pallas kernel's true-f32 dot, result in ``x``'s dtype (any shape, no
    alignment gate). On the card, bf16 x with Rademacher z runs the
    tensor-core body (``x @ w + coeff * (x @ z)``, exact term by term on
    these inputs), anything else the SIMT body of the f32 perturbed
    weight.

    ``scale`` (f32, (N,)) marks ``w`` as an int8 base: ``x @ (w * scale +
    coeff * z)``, the ``zo_matmul_q`` kernel on the card (counted as
    ``zo_matmul_q``). ``offsets=(row0, col0)``: w's global origin as a
    shard of a larger weight (default zeros); a DTensor w goes through
    :func:`zo_matmul_sharded`."""
    if is_dtensor(w):
        if scale is not None or offsets is not None:
            raise ValueError("zo_matmul: a DTensor w takes neither scale= "
                             "nor offsets=")
        return zo_matmul_sharded(x, w, seed, salt, coeff, dist,
                                 prime_offset, prehashed)
    if scale is not None:
        if offsets is not None and any(offsets):
            raise ValueError("zo_matmul(scale=): the int8 kernel takes no "
                             "shard offsets")
        if _on_cpu("zo_matmul_q", x):
            return _zo.zo_matmul_q_ref(x, w, scale, seed, salt, coeff, dist,
                                       prime_offset, prehashed)
        return _zo.zo_matmul_q_cuda(x, w, scale, seed, salt, coeff, dist,
                                    prime_offset, prehashed)
    if _on_cpu("zo_matmul", x):
        return _zo.zo_matmul_ref(x, w, seed, salt, coeff, dist,
                                 prime_offset, prehashed, offsets=offsets)
    return _zo.zo_matmul_cuda(x, w, seed, salt, coeff, dist, prime_offset,
                              prehashed, offsets=offsets)


def zo_add_users(w, seeds, salt: int, coeffs, dist: str = "rademacher",
                 prime_offset: int = 0, prehashed: bool = False, out=None,
                 lanes=None):
    """User-batched :func:`zo_add`: ``out[l] = w[l] + coeffs[i] *
    z(seeds[i], salt)`` for each lane ``l = lanes[i]`` (default: every
    lane in order) of a user-stacked leaf w (U, *leaf_shape), each lane
    bit for bit a lone ``zo_add``. ``out`` (may be ``w``) is required
    with ``lanes``; its other lanes stay as they are."""
    if _on_cpu("zo_add_users", w):
        if lanes is None:
            res = _zo.zo_add_users_ref(w, seeds, salt, coeffs, dist,
                                       prime_offset, prehashed)
            return res if out is None else out.copy_(res)
        if out is None:
            raise ValueError("zo_add_users: lanes= needs out=")
        seeds = _zo._lane_seeds(seeds)
        coeffs = _zo._lane_coeffs(coeffs, len(seeds))
        for lane, s, c in zip(lanes, seeds, coeffs):
            out[lane] = _zo.zo_add_ref(w[lane], s, salt, c, dist,
                                       prime_offset, prehashed)
        return out
    return _zo.zo_add_users_cuda(w, seeds, salt, coeffs, dist, prime_offset,
                                 prehashed, out=out, lanes=lanes)


def zo_matmul_users(x, w, seeds, salt: int, coeffs,
                    dist: str = "rademacher", prime_offset: int = 0,
                    prehashed: bool = False, scale=None):
    """User-batched :func:`zo_matmul`: ``y[i] = x[i] @ (W_i + coeffs[i] *
    z(seeds[i], salt))`` for x (U, M, K); ``W_i`` is one shared w (K, N)
    or lane ``i % P`` of a stacked w (P, K, N). ``scale`` (N,) marks a
    shared int8 w (the ``zo_matmul_users_q`` kernel on the card). Each
    lane equals a lone ``zo_matmul`` bit for bit."""
    if _on_cpu("zo_matmul_users", x):
        return _zo.zo_matmul_users_ref(x, w, seeds, salt, coeffs, dist,
                                       prime_offset, prehashed, scale)
    return _zo.zo_matmul_users_cuda(x, w, seeds, salt, coeffs, dist,
                                    prime_offset, prehashed, scale)


def flash_attention(q, k, v, causal: bool = True):
    """Forward-only GQA attention, q (B, S, H, hd), k/v (B, T, KV, hd).

    It has no backward, on either device: inputs that need a gradient
    raise, as differentiating the reference's Pallas kernel does (its
    ``pallas_call`` has no differentiation rule); a gradient through
    attention needs ``attn_impl="chunked"``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward (nor has the reference's "
            "Pallas kernel): differentiate a config with "
            "attn_impl='chunked'")
    if _on_cpu("flash_attention", q):
        return _fa.flash_attention_ref(q, k, v, causal)
    return _fa.flash_attention_cuda(q, k, v, causal)


def paged_decode_attn(q, k_pages, v_pages, pages, pos):
    """Single-token attention over a paged KV pool (q: (B, H, hd))."""
    if _on_cpu("flash_decode", q):
        return _fd.paged_attn_ref(q, k_pages, v_pages, pages, pos)
    return _fd.flash_decode(q, k_pages, v_pages, pages, pos)


def paged_prefill_attn(q, k_pages, v_pages, pages, pos):
    """Chunk attention over a paged KV pool (q: (B, C, H, hd)), chunk
    offset c reading positions <= pos + c."""
    if _on_cpu("flash_prefill", q):
        return _fp.prefill_attn_ref(q, k_pages, v_pages, pages, pos)
    return _fp.flash_prefill(q, k_pages, v_pages, pages, pos)


def paged_verify_attn(q, k_pages, v_pages, pages, pos):
    """Speculative-verify window attention over a paged KV pool (q: (B, W,
    H, hd)), window offset w reading positions <= pos + w."""
    if _on_cpu("flash_verify", q):
        return _fv.verify_attn_ref(q, k_pages, v_pages, pages, pos)
    return _fv.flash_verify(q, k_pages, v_pages, pages, pos)


def selective_scan(x, dt, dt_bias, a_log, bmat, cmat, d, z, h0=None):
    """Mamba-1's selective scan (``kernels/selective_scan.py``): x, z (B,
    S, di), dt (B, S, di) before its bias and softplus, B, C (B, S, n),
    leaves dt_bias (di,), A_log (di, n), D (di,) or each with a leading
    lane axis (U lanes of B / U rows), optional h0 (B, di, n) f32 -> (y in
    x's dtype, the last state f32). Forward only."""
    if _on_cpu("selective_scan", x):
        return _ss.selective_scan_ref(x, dt, dt_bias, a_log, bmat, cmat, d,
                                      z, h0)
    return _ss.selective_scan_cuda(x, dt, dt_bias, a_log, bmat, cmat, d, z,
                                   h0)

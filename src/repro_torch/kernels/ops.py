"""Kernel dispatch: the device of the input decides.

Each wrapper takes the plain PyTorch version for a tensor on the CPU and
launches the hand-written CUDA kernel (``src/repro_torch/csrc``) for a
tensor on a CUDA device -- never a fallback: a CUDA input the kernel
does not take, a failed build or a failed launch raises. Launches are
counted in :data:`LAUNCHES` (``LAUNCHES["zo_add"]`` and so on), and
the two-body kernels' launches by body in :data:`BODIES`
(``BODIES["zo_matmul/tc"]``: bf16 tensor cores; ``.../simt``; also
``flash_attention`` and ``flash_prefill``).
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import flash_verify as _fv
from repro_torch.kernels import zo_perturb as _zo
from repro_torch.kernels.build import BODIES, LAUNCHES, reset_launches

__all__ = ["BODIES", "LAUNCHES", "reset_launches", "zo_add", "zo_matmul",
           "zo_add_users", "zo_matmul_users", "flash_attention",
           "paged_decode_attn", "paged_prefill_attn", "paged_verify_attn"]


def _on_cpu(kernel: str, t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{kernel}: no kernel for device {t.device}")


def zo_add(w, seed, salt: int, coeff, dist: str = "rademacher",
           prime_offset: int = 0, prehashed: bool = False, out=None,
           scale=None):
    """``w + coeff * z(seed, salt)`` in ``w``'s dtype, for a leaf of any
    rank (the kernel masks its own edges; no alignment gate). ``out``
    (may be ``w`` itself) receives the result.

    ``scale`` (f32, ``w.shape[:-2] + (N,)``) marks ``w`` as an int8 base:
    the result is then the f32 ``w * scale + coeff * z``, from the
    ``zo_add_q`` kernel on the card (counted as ``zo_add_q``)."""
    if scale is not None:
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
                             prehashed)
        return res if out is None else out.copy_(res)
    return _zo.zo_add_cuda(w, seed, salt, coeff, dist, prime_offset,
                           prehashed, out=out)


def zo_matmul(x, w, seed, salt: int, coeff, dist: str = "rademacher",
              prime_offset: int = 0, prehashed: bool = False, scale=None):
    """``x @ (w + coeff * z(seed, salt))`` for x (M, K), w (K, N), the
    Pallas kernel's true-f32 dot, result in ``x``'s dtype (any shape, no
    alignment gate). On the card, bf16 x with Rademacher z runs the
    tensor-core body (``x @ w + coeff * (x @ z)``, exact term by term on
    these inputs), anything else the SIMT body of the f32 perturbed
    weight.

    ``scale`` (f32, (N,)) marks ``w`` as an int8 base: ``x @ (w * scale +
    coeff * z)``, the ``zo_matmul_q`` kernel on the card (counted as
    ``zo_matmul_q``)."""
    if scale is not None:
        if _on_cpu("zo_matmul_q", x):
            return _zo.zo_matmul_q_ref(x, w, scale, seed, salt, coeff, dist,
                                       prime_offset, prehashed)
        return _zo.zo_matmul_q_cuda(x, w, scale, seed, salt, coeff, dist,
                                    prime_offset, prehashed)
    if _on_cpu("zo_matmul", x):
        return _zo.zo_matmul_ref(x, w, seed, salt, coeff, dist,
                                 prime_offset, prehashed)
    return _zo.zo_matmul_cuda(x, w, seed, salt, coeff, dist, prime_offset,
                              prehashed)


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
    """Forward-only GQA attention, q (B, S, H, hd), k/v (B, T, KV, hd)."""
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

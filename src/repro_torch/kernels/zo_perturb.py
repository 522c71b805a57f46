"""W + coeff * z(seed) and X @ (W + coeff * z(seed)), plain and CUDA.

Port of the JAX package's ``kernels/zo_perturb.py`` (``_tile_z``,
``zo_add`` and ``zo_matmul`` without ``scale=``) and ``kernels/ref.py``
(``zo_add_ref``, ``zo_matmul_ref``). The CUDA kernels are
``csrc/zo_add.cu`` (the seed-replay sweep) and ``csrc/zo_matmul.cu``
(the fused perturbed matmul); their hash lives in ``csrc/zo_hash.cuh``.
Both reproduce :func:`repro_torch.core.rng.z_field` element for element:
bit for bit with Rademacher z, to the last ulps of ``log``/``cos`` with
Gaussian z.

``zo_matmul`` has the Pallas kernel's arithmetic: the perturbed weight
``f32(W) + f32(c) * z`` stays in f32 and is dotted in f32 with
``f32(X)``; the result is cast to ``X``'s dtype. For bf16 leaves that
differs from the JAX package's jnp fallback, which rounds ``W + c*z``
back to bf16 before the dot; in f32 the two agree.

Seed conventions (the Pallas kernel's): ``prehashed=False`` takes the
step seed and folds the leaf ``salt`` in; ``prehashed=True`` takes a base
already folded (``rng.leaf_base`` / ``rng.fold_leading``) and ignores
``salt``. ``prime_offset`` selects the per-dimension primes, so a slice
of a stacked leaf reproduces that slice of the whole field.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import rng as zrng
from repro_torch.kernels.build import launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DISTS = {"rademacher": 0, "gaussian": 1}


def _base(seed, salt: int, prehashed: bool) -> int:
    return zrng._u32(seed) if prehashed else zrng.leaf_base(seed, salt)


def tile_z(seed, salt: int, shape, row0: int, col0: int, dist: str,
           prime_offset: int = 0, prehashed: bool = False, device=None):
    """f32 z tile of 2-D ``shape`` at absolute offset (row0, col0)."""
    return zrng.z_field(None, 0, shape, torch.float32, dist,
                        offsets=(row0, col0), prime_offset=prime_offset,
                        base=_base(seed, salt, prehashed), device=device)


def zo_add_ref(w: torch.Tensor, seed, salt: int, coeff, dist="rademacher",
               prime_offset: int = 0, prehashed: bool = False):
    """Plain version: ``(f32(w) + f32(coeff) * z).to(w.dtype)`` for a leaf
    of any rank, on any device."""
    z = zrng.z_field(None, 0, w.shape, torch.float32, dist,
                     prime_offset=prime_offset,
                     base=_base(seed, salt, prehashed), device=w.device)
    c = torch.as_tensor(coeff, dtype=torch.float32, device=w.device)
    return (w.to(torch.float32) + c * z).to(w.dtype)


def zo_add_cuda(w: torch.Tensor, seed, salt: int, coeff,
                dist="rademacher", prime_offset: int = 0,
                prehashed: bool = False, out=None):
    """Launch the ``zo_add`` kernel on ``torch.cuda.current_stream()``.

    ``w``: a contiguous f32 or bf16 CUDA tensor of rank 0..8; ``out``
    (optional, may be ``w`` itself) receives the result.
    """
    if w.device.type != "cuda":
        raise ValueError(f"zo_add kernel needs a CUDA tensor, got {w.device}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"zo_add kernel takes float32/bfloat16, got {w.dtype}")
    if dist not in _DISTS:
        raise ValueError(f"unknown zo distribution: {dist}")
    if not w.is_contiguous():
        raise ValueError("zo_add kernel needs a contiguous tensor")
    if w.dim() + prime_offset > len(zrng._DIM_PRIMES):
        raise ValueError(f"leaf rank {w.dim()} + offset {prime_offset} > "
                         f"{len(zrng._DIM_PRIMES)} unsupported")
    if out is None:
        out = torch.empty_like(w)
    elif (out.shape != w.shape or out.dtype != w.dtype
          or out.device != w.device or not out.is_contiguous()):
        raise ValueError("zo_add: out must match w (shape, dtype, device) "
                         "and be contiguous")
    if w.numel() == 0:
        return out
    dims = (ctypes.c_int64 * max(w.dim(), 1))(*w.shape)
    vectorized = int(w.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    coeff_f32 = float(torch.as_tensor(coeff, dtype=torch.float32))
    launch("zo_add", "repro_zo_add", w.data_ptr(), out.data_ptr(),
           w.numel(), _DTYPES[w.dtype], dims, w.dim(),
           _base(seed, salt, prehashed), prime_offset, coeff_f32,
           _DISTS[dist], vectorized,
           torch.cuda.current_stream(w.device).cuda_stream)
    return out


def zo_matmul_ref(x: torch.Tensor, w: torch.Tensor, seed, salt: int,
                  coeff, dist="rademacher", prime_offset: int = 0,
                  prehashed: bool = False):
    """Plain version: ``(f32(x) @ (f32(w) + f32(coeff) * z)).to(x.dtype)``
    for x (M, K), w (K, N), z over the whole (K, N) field."""
    z = tile_z(seed, salt, w.shape, 0, 0, dist, prime_offset, prehashed,
               device=w.device)
    c = torch.as_tensor(coeff, dtype=torch.float32, device=w.device)
    wp = w.to(torch.float32) + c * z
    return (x.to(torch.float32) @ wp).to(x.dtype)


def zo_matmul_cuda(x: torch.Tensor, w: torch.Tensor, seed, salt: int,
                   coeff, dist="rademacher", prime_offset: int = 0,
                   prehashed: bool = False):
    """Launch the ``zo_matmul`` kernel on ``torch.cuda.current_stream()``.

    ``x`` (M, K) and ``w`` (K, N): contiguous CUDA tensors of one dtype,
    float32 or bfloat16. Returns (M, N) in that dtype. ``seed`` is a host
    int and ``coeff`` a host number, so a launch never waits for the
    device.
    """
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda":
            raise ValueError(f"zo_matmul kernel needs CUDA tensors, {name} "
                             f"is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"zo_matmul kernel needs a contiguous {name}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"zo_matmul kernel takes x and w of one dtype, "
                        f"float32 or bfloat16; got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"zo_matmul: bad shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if dist not in _DISTS:
        raise ValueError(f"unknown zo distribution: {dist}")
    if prime_offset + 2 > len(zrng._DIM_PRIMES):
        raise ValueError(f"prime_offset {prime_offset} unsupported")
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    coeff_f32 = float(torch.as_tensor(coeff, dtype=torch.float32))
    launch("zo_matmul", "repro_zo_matmul", x.data_ptr(), w.data_ptr(),
           out.data_ptr(), _DTYPES[x.dtype], m, k, n,
           _base(seed, salt, prehashed), prime_offset, coeff_f32,
           _DISTS[dist], torch.cuda.current_stream(x.device).cuda_stream)
    return out

"""Counter-based hash RNG for seed-replay perturbations (torch port).

The perturbation ``z`` is never stored: element ``(i0, i1, ...)`` of a
leaf's field is a pure function of ``(seed, leaf salt, coords)``, so the
plain version here, the CUDA ``zo_add`` kernel (``csrc/zo_hash.cuh``)
and the JAX package all produce the same bits.

All arithmetic is uint32 with wraparound. torch on the CPU has no ``>>``
for ``torch.uint32``, so fields are computed in int64 and masked with
``& 0xFFFFFFFF`` after every product: the int64 product may wrap, but
its low 32 bits are the uint32 product's. Scalars (seeds, salts, bases)
are plain Python ints; every function here also accepts int64 tensors.
"""

from __future__ import annotations

import math
import zlib

import torch

# Distinct odd multipliers per dimension (first 8 dims supported).
_DIM_PRIMES = (
    0x9E3779B1,  # golden-ratio prime
    0x85EBCA77,
    0xC2B2AE3D,
    0x27D4EB2F,
    0x165667B1,
    0xD3A2646D,
    0xFD7046C5,
    0xB55A4F09,
)
_M = 0xFFFFFFFF
GAUSS_SALT = 0x68E31DA4


def _u32(x):
    """Python int (numpy scalars included) or int64 tensor, masked."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M
    return int(x) & _M


def avalanche(x):
    """Final xxhash32-style avalanche: full-period bijection on uint32."""
    x = _u32(x)
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M
    x = x ^ (x >> 12)
    x = (x * 0x297A2D39) & _M
    x = x ^ (x >> 15)
    return x


def leaf_salt(path: str) -> int:
    """Stable per-leaf salt from the ``/``-joined parameter path."""
    return zlib.crc32(path.encode("utf-8")) & _M


def fold_seed(seed, k):
    """Derive a sub-seed (e.g. per perturbation direction k)."""
    return avalanche(_u32(seed) ^ ((_u32(k) * _DIM_PRIMES[1]) & _M))


def leaf_base(seed, salt: int):
    """Pre-hashed starting state of a leaf's field: avalanche(seed ^ salt)."""
    return avalanche(_u32(seed) ^ _u32(salt))


def fold_leading(base, idx, dim: int = 0):
    """Advance a pre-hashed base past one leading coordinate, so that

      z_field(seed, salt, (L, *s))[l]
        == z_field(None, 0, s, base=fold_leading(leaf_base(seed, salt), l),
                   prime_offset=1)
    """
    return avalanche(_u32(base) ^ ((_u32(idx) * _DIM_PRIMES[dim]) & _M))


def _coord_hash(seed, salt: int, shape, offsets=None, prime_offset: int = 0,
                base=None, device=None):
    """int64 tensor of uint32 hashes over an index grid of ``shape``.

    offsets: optional per-dim start indices; prime_offset: index of the
    prime used for dim 0; base: pre-hashed state (seed/salt ignored).
    Dimensions fold outermost-first, each a broadcast iota, so the hash
    grows one axis at a time instead of materializing every coordinate.
    """
    shape = tuple(int(n) for n in shape)
    if len(shape) + prime_offset > len(_DIM_PRIMES):
        raise ValueError(
            f"leaf rank {len(shape)} + offset {prime_offset} > "
            f"{len(_DIM_PRIMES)} unsupported")
    h = leaf_base(seed, salt) if base is None else _u32(base)
    if not isinstance(h, torch.Tensor):
        h = torch.tensor(h, dtype=torch.int64, device=device)
    if len(shape) == 0:
        # a true scalar leaf gets one extra avalanche; a rank-0 *slice*
        # (prime_offset > 0, base pre-folded past the leading dims) must not
        return avalanche(h) if prime_offset == 0 else h
    nd = len(shape)
    for d, n in enumerate(shape):
        iota = torch.arange(n, dtype=torch.int64, device=h.device)
        if offsets is not None:
            iota = (iota + _u32(offsets[d])) & _M
        iota = iota.reshape((n,) + (1,) * (nd - d - 1))
        h = avalanche(h ^ ((iota * _DIM_PRIMES[prime_offset + d]) & _M))
    return h.expand(shape)


def _bits_rademacher(bits, dtype):
    return (1.0 - 2.0 * (bits >> 31).to(torch.float32)).to(dtype)


def _bits_gaussian(h1, dtype):
    h2 = avalanche(h1 ^ GAUSS_SALT)
    # uniforms in (0, 1]: top 24 bits, plus 1 ulp to avoid log(0)
    u1 = ((h1 >> 8).to(torch.float32) + 1.0) * (1.0 / 16777216.0)
    u2 = (h2 >> 8).to(torch.float32) * (1.0 / 16777216.0)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * math.pi) * u2
    return (r * torch.cos(theta)).to(dtype)


def rademacher_field(seed, salt: int, shape, dtype=torch.float32,
                     offsets=None, prime_offset: int = 0, base=None,
                     device=None):
    """±1 field, one hash per element (default ZO perturbation)."""
    bits = _coord_hash(seed, salt, shape, offsets, prime_offset, base, device)
    return _bits_rademacher(bits, dtype)


def gaussian_field(seed, salt: int, shape, dtype=torch.float32,
                   offsets=None, prime_offset: int = 0, base=None,
                   device=None):
    """N(0,1) field via Box-Muller on two decorrelated hash fields."""
    h1 = _coord_hash(seed, salt, shape, offsets, prime_offset, base, device)
    return _bits_gaussian(h1, dtype)


def z_field(seed, salt: int, shape, dtype=torch.float32,
            dist: str = "rademacher", offsets=None, prime_offset: int = 0,
            base=None, device=None):
    if dist == "rademacher":
        return rademacher_field(seed, salt, shape, dtype, offsets,
                                prime_offset, base, device)
    if dist == "gaussian":
        return gaussian_field(seed, salt, shape, dtype, offsets,
                              prime_offset, base, device)
    raise ValueError(f"unknown zo distribution: {dist}")


def z_rows(base, row_ids, n_cols: int, dtype=torch.float32,
           dist: str = "rademacher", prime_offset: int = 0):
    """z rows of an ``(R, n_cols)`` leaf gathered at ``row_ids``.

    Equal element for element to ``z_field(..., (R, n_cols))[row_ids]``
    (``base`` pre-hashed, as ``z_field(base=...)`` takes it) without
    building the whole table: an embedding's perturbation costs
    O(tokens * d), not O(vocab * d). ``row_ids`` (an int tensor) may have
    any shape; the result appends a trailing ``n_cols`` axis on the ids'
    device.
    """
    ids = torch.as_tensor(row_ids).to(torch.int64) & _M
    h = avalanche(_u32(base) ^ ((ids * _DIM_PRIMES[prime_offset]) & _M))
    cols = torch.arange(n_cols, dtype=torch.int64, device=ids.device)
    h = avalanche(h[..., None]
                  ^ ((cols * _DIM_PRIMES[prime_offset + 1]) & _M))
    if dist == "rademacher":
        return _bits_rademacher(h, dtype)
    if dist == "gaussian":
        return _bits_gaussian(h, dtype)
    raise ValueError(f"unknown zo distribution: {dist}")

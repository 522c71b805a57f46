"""Frozen copy of the counter-hash perturbation ``z`` (Rademacher).

Element ``(i0, i1, ...)`` of a leaf's field is a pure function of the
direction seed, the crc32 of the leaf's ``/``-joined path and the
coordinates: ``h = avalanche(seed ^ salt)``, then per dimension ``d``
``h = avalanche(h ^ (i_d * PRIME[d]))``, and ``z = 1 - 2 * (h >> 31)``.
A layer of a stacked ``(L, ...)`` leaf is the same field with its
leading coordinate folded in first. All arithmetic is uint32 with
wraparound, done in int64 and masked after every product.

Step seeds follow the trainer's schedule: step ``t`` of a run seeded
``s`` uses ``fold_seed(s, t)``, and its direction ``k`` uses
``fold_seed(fold_seed(s, t), k)``.
"""

from __future__ import annotations

import zlib

import torch

PRIMES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
          0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09)
M32 = 0xFFFFFFFF


def _u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return int(x) & M32


def avalanche(x):
    x = _u32(x)
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & M32
    x = x ^ (x >> 12)
    x = (x * 0x297A2D39) & M32
    return x ^ (x >> 15)


def salt(path: str) -> int:
    return zlib.crc32(path.encode("utf-8")) & M32


def fold_seed(seed, k) -> int:
    return avalanche(_u32(seed) ^ ((_u32(k) * PRIMES[1]) & M32))


def direction_seed(run_seed, step: int, k: int = 0) -> int:
    """Seed of direction ``k`` of step ``step`` (0-based)."""
    return fold_seed(fold_seed(run_seed, step), k)


def leaf_base(seed, path: str, layer=None) -> int:
    """Hash state of a leaf's field, past its layer coordinate if given."""
    h = avalanche(_u32(seed) ^ salt(path))
    if layer is not None:
        h = avalanche(h ^ ((int(layer) * PRIMES[0]) & M32))
    return h


def field(base: int, shape, first_dim: int, device, rows=None):
    """Rademacher z (f32) of ``shape`` from hash state ``base`` whose
    first coordinate takes prime ``first_dim``. ``rows``: ids of the
    first coordinate (a gather of rows) in place of ``arange``."""
    shape = tuple(int(n) for n in shape)
    if not shape:
        return (1.0 - 2.0 * (avalanche(base) >> 31)) * torch.ones(
            (), dtype=torch.float32, device=device)
    h = torch.tensor(base, dtype=torch.int64, device=device)
    nd = len(shape)
    for d, n in enumerate(shape):
        if d == 0 and rows is not None:
            iota = rows.to(device=device, dtype=torch.int64) & M32
            iota = iota.reshape(iota.shape + (1,) * (nd - 1))
        else:
            iota = torch.arange(n, dtype=torch.int64, device=device)
            iota = iota.reshape((n,) + (1,) * (nd - d - 1))
        h = avalanche(h ^ ((iota * PRIMES[first_dim + d]) & M32))
    if rows is not None:
        shape = tuple(rows.shape) + shape[1:]
    z = 1.0 - 2.0 * (h.expand(shape) >> 31).to(torch.float32)
    return z


def leaf_z(seed, path: str, shape, device, layer=None, rows=None):
    """z of a whole leaf (``layer`` None) or of layer ``layer`` of a
    stacked leaf, ``shape`` being the layer's shape; ``rows`` gathers
    rows of a 2-D table."""
    base = leaf_base(seed, path, layer)
    return field(base, shape, 0 if layer is None else 1, device, rows)

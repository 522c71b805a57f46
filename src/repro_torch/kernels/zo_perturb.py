"""W + coeff * z(seed) and X @ (W + coeff * z(seed)), plain and CUDA.

Port of the JAX package's ``kernels/zo_perturb.py`` (``_tile_z``,
``zo_add``, ``zo_matmul``, ``zo_add_users`` and ``zo_matmul_users``, with
and without ``scale=``) and ``kernels/ref.py`` (``zo_add_ref``,
``zo_matmul_ref``). The CUDA kernels
are ``csrc/zo_add.cu`` (the seed-replay sweep, and ``zo_add_q``: an int8
leaf dequantized with its per-column scales, ``q*s + c*z`` in f32) and
``csrc/zo_matmul.cu`` (the fused perturbed matmul, and ``zo_matmul_q``:
``X @ (q*s + c*z)`` over an int8 weight) -- each with a user-batched
twin that runs one lane per (seed, coeff) pair, each lane's bits those
of a lone scalar launch; their hash lives in
``csrc/zo_hash.cuh``. All reproduce :func:`repro_torch.core.rng.z_field`
element for element: bit for bit with Rademacher z, to the last ulps of
``log``/``cos`` with Gaussian z. The quantized variants form
``q*s + c*z`` as the plain versions do -- ``q*s`` exact (power-of-two
scales), then one rounding of ``c*z`` and one of the sum -- so their
perturbed weights equal the plain versions' bit for bit with Rademacher
z.

``zo_matmul`` has the Pallas kernel's arithmetic: the perturbed weight
``f32(W) + f32(c) * z`` stays in f32 and is dotted in f32 with
``f32(X)``; the result is cast to ``X``'s dtype. For bf16 leaves that
differs from the JAX package's jnp fallback, which rounds ``W + c*z``
back to bf16 before the dot; in f32 the two agree. On the card the
kernel has two bodies (``csrc/zo_matmul.cu``): bf16 ``X`` with
Rademacher z takes bf16 tensor cores, ``X @ W + c * (X @ z)`` (``X @
q`` times the column scales for an int8 W), which is that true-f32 dot
up to summation order because every product of these inputs is exact
in f32; f32 ``X`` or Gaussian z takes the SIMT body of the f32 W', whose
tile (:data:`SIMT_TILES`, :func:`simt_tile`) the launcher picks from the
shape, the lane count and the card's SMs -- each output one f32 FMA
chain in k order whatever the tile. The tensor cores have two routes
(:data:`MM_BODIES`): the Hopper body -- TMA loads, 128 x 128 tiles on
2-CTA clusters that hash z once per 256 rows, one n256 ``wgmma`` over
the joint [W | z] tile -- wherever TMA can load X and a bf16 W (K, N
and W's lane stride multiples of 8, 16-byte bases), and the 256 x 64
body for an int8 q or ragged or unaligned rows. Neither M nor the lane
count decides the body, and both routes take the same k16 steps in the
same order, so a user lane still equals a lone launch bit for bit.

Seed conventions (the Pallas kernel's): ``prehashed=False`` takes the
step seed and folds the leaf ``salt`` in; ``prehashed=True`` takes a base
already folded (``rng.leaf_base`` / ``rng.fold_leading``) and ignores
``salt``. ``prime_offset`` selects the per-dimension primes, so a slice
of a stacked leaf reproduces that slice of the whole field.

Shards: ``zo_add`` takes ``offsets`` (one per dimension) and ``zo_matmul``
``offsets=(row0, col0)``, the global position of a shard of a larger
leaf, whose z is then that leaf's slice (the reference's counter hash is
over global coordinates; GSPMD partitions its iota the same way). Zero
offsets are the whole leaf, bit for bit as without them. The int8 and
user-batched kernels take no offsets: the sharded path runs neither.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import rng as zrng
from repro_torch.kernels.build import launch, library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DISTS = {"rademacher": 0, "gaussian": 1}

#: the ``BODIES`` names of each body ``repro_zo_matmul_body`` returns: the
#: SIMT body, the 256 x 64 tensor-core body, the Hopper one (tensor cores
#: too, so counted under ``"tc"`` as well)
MM_BODIES = ("simt", "tc", ("tc", "tc_tma"))


def _mm_body(x_ptr: int, w: torch.Tensor, dist: str, dtype: torch.dtype,
             k: int, n: int, w_stride: int = 0, w_ptr=None):
    """The ``zo_matmul`` body a launch runs, as ``BODIES`` names it
    (``csrc/zo_matmul.cu``'s rule): the tensor cores for bf16 x with
    Rademacher z -- the Hopper body where TMA can load X and a bf16 W
    (K, N and W's lane stride multiples of 8, 16-byte bases) -- else the
    SIMT body."""
    return MM_BODIES[library().repro_zo_matmul_body(
        _DTYPES[dtype], _DISTS[dist], int(w.dtype == torch.int8), k, n,
        w_stride, x_ptr, w.data_ptr() if w_ptr is None else w_ptr)]


#: the SIMT body's output tiles (BM, BN), as ``csrc/zo_matmul.cu``'s
#: ``pick_tile`` indexes them
SIMT_TILES = ((256, 128), (128, 128), (128, 64), (64, 64))


def simt_tile(m: int, n: int, lanes: int = 1, sms: int = 0):
    """(BM, BN) of the tile the SIMT body takes for ``m`` x ``n`` outputs
    a lane on ``lanes`` lanes over ``sms`` SMs (0: the current card's);
    builds the kernels on first use."""
    i = library().repro_zo_matmul_simt_tile(m, n, lanes, sms)
    if i < 0:
        raise ValueError(f"no SIMT tile for m {m}, n {n}, lanes {lanes}, "
                         f"sms {sms}")
    return SIMT_TILES[i]


def _base(seed, salt: int, prehashed: bool) -> int:
    return zrng._u32(seed) if prehashed else zrng.leaf_base(seed, salt)


def tile_z(seed, salt: int, shape, row0: int, col0: int, dist: str,
           prime_offset: int = 0, prehashed: bool = False, device=None):
    """f32 z tile of 2-D ``shape`` at absolute offset (row0, col0)."""
    return zrng.z_field(None, 0, shape, torch.float32, dist,
                        offsets=(row0, col0), prime_offset=prime_offset,
                        base=_base(seed, salt, prehashed), device=device)


def _offsets(offsets, nd: int, kernel: str):
    """``offsets`` as nd non-negative ints (None: zeros)."""
    if offsets is None:
        return (0,) * nd
    offsets = tuple(int(o) for o in offsets)
    if len(offsets) != nd or min(offsets, default=0) < 0:
        raise ValueError(f"{kernel}: offsets {offsets} for rank {nd}")
    return offsets


def zo_add_ref(w: torch.Tensor, seed, salt: int, coeff, dist="rademacher",
               prime_offset: int = 0, prehashed: bool = False,
               offsets=None):
    """Plain version: ``(f32(w) + f32(coeff) * z).to(w.dtype)`` for a leaf
    of any rank, on any device; z at the global ``offsets``."""
    z = zrng.z_field(None, 0, w.shape, torch.float32, dist,
                     offsets=_offsets(offsets, w.dim(), "zo_add"),
                     prime_offset=prime_offset,
                     base=_base(seed, salt, prehashed), device=w.device)
    c = torch.as_tensor(coeff, dtype=torch.float32, device=w.device)
    return (w.to(torch.float32) + c * z).to(w.dtype)


def zo_add_cuda(w: torch.Tensor, seed, salt: int, coeff,
                dist="rademacher", prime_offset: int = 0,
                prehashed: bool = False, out=None, offsets=None):
    """Launch the ``zo_add`` kernel on ``torch.cuda.current_stream()``.

    ``w``: a contiguous f32 or bf16 CUDA tensor of rank 0..8; ``out``
    (optional, may be ``w`` itself) receives the result; ``offsets``: the
    global offsets of a shard (default zeros).
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
    offs = _offsets(offsets, w.dim(), "zo_add")
    if w.numel() == 0:
        return out
    dims = (ctypes.c_int64 * max(w.dim(), 1))(*w.shape)
    offs = (ctypes.c_int64 * max(w.dim(), 1))(*offs)
    vectorized = int(w.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    coeff_f32 = float(torch.as_tensor(coeff, dtype=torch.float32))
    launch("zo_add", "repro_zo_add", w.data_ptr(), out.data_ptr(),
           w.numel(), _DTYPES[w.dtype], dims, w.dim(), offs,
           _base(seed, salt, prehashed), prime_offset, coeff_f32,
           _DISTS[dist], vectorized,
           torch.cuda.current_stream(w.device).cuda_stream)
    return out


def zo_matmul_ref(x: torch.Tensor, w: torch.Tensor, seed, salt: int,
                  coeff, dist="rademacher", prime_offset: int = 0,
                  prehashed: bool = False, offsets=None):
    """Plain version: ``(f32(x) @ (f32(w) + f32(coeff) * z)).to(x.dtype)``
    for x (M, K), w (K, N), z over the (K, N) field at the global
    ``offsets=(row0, col0)`` (default the whole field)."""
    row0, col0 = _offsets(offsets, 2, "zo_matmul")
    z = tile_z(seed, salt, w.shape, row0, col0, dist, prime_offset,
               prehashed, device=w.device)
    c = torch.as_tensor(coeff, dtype=torch.float32, device=w.device)
    wp = w.to(torch.float32) + c * z
    return (x.to(torch.float32) @ wp).to(x.dtype)


def zo_matmul_cuda(x: torch.Tensor, w: torch.Tensor, seed, salt: int,
                   coeff, dist="rademacher", prime_offset: int = 0,
                   prehashed: bool = False, offsets=None):
    """Launch the ``zo_matmul`` kernel on ``torch.cuda.current_stream()``.

    ``x`` (M, K) and ``w`` (K, N): contiguous CUDA tensors of one dtype,
    float32 or bfloat16. Returns (M, N) in that dtype. ``seed`` is a host
    int and ``coeff`` a host number, so a launch never waits for the
    device. ``offsets=(row0, col0)``: w's global origin as a shard of a
    larger weight (default zeros).
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
    row0, col0 = _offsets(offsets, 2, "zo_matmul")
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    coeff_f32 = float(torch.as_tensor(coeff, dtype=torch.float32))
    launch("zo_matmul", "repro_zo_matmul", x.data_ptr(), w.data_ptr(),
           out.data_ptr(), _DTYPES[x.dtype], m, k, n,
           _base(seed, salt, prehashed), prime_offset, coeff_f32,
           _DISTS[dist], row0, col0,
           torch.cuda.current_stream(x.device).cuda_stream,
           body=_mm_body(x.data_ptr(), w, dist, x.dtype, k, n))
    return out


# ---------------------------------------------------------------------------
# int8 bases: q * scale (+ c * z), scale per column, shape q.shape[:-2] + (N,)


def _check_scale(q: torch.Tensor, scale: torch.Tensor, kernel: str):
    if q.dim() < 2:
        raise ValueError(f"{kernel}: an int8 leaf has rank >= 2, got "
                         f"{tuple(q.shape)}")
    want = tuple(q.shape[:-2]) + (q.shape[-1],)
    if tuple(scale.shape) != want:
        raise ValueError(f"{kernel}: scale shape {tuple(scale.shape)} != "
                         f"{want} for q {tuple(q.shape)}")


def zo_add_q_ref(q: torch.Tensor, scale: torch.Tensor, seed, salt: int,
                 coeff, dist="rademacher", prime_offset: int = 0,
                 prehashed: bool = False) -> torch.Tensor:
    """Plain version: f32 ``q * scale + f32(coeff) * z`` for an int8 leaf
    of any rank >= 2, ``scale`` of shape ``q.shape[:-2] + (N,)``."""
    _check_scale(q, scale, "zo_add_q")
    z = zrng.z_field(None, 0, q.shape, torch.float32, dist,
                     prime_offset=prime_offset,
                     base=_base(seed, salt, prehashed), device=q.device)
    c = torch.as_tensor(coeff, dtype=torch.float32, device=q.device)
    return q.to(torch.float32) * scale.unsqueeze(-2) + c * z


def zo_add_q_cuda(q: torch.Tensor, scale: torch.Tensor, seed, salt: int,
                  coeff, dist="rademacher", prime_offset: int = 0,
                  prehashed: bool = False) -> torch.Tensor:
    """Launch the ``zo_add_q`` kernel: a new f32 tensor of ``q``'s shape.

    ``q``: a contiguous int8 CUDA tensor of rank 2..8; ``scale``: a
    contiguous f32 CUDA tensor of shape ``q.shape[:-2] + (N,)``.
    """
    for name, t, dt in (("q", q, torch.int8), ("scale", scale,
                                               torch.float32)):
        if t.device.type != "cuda":
            raise ValueError(f"zo_add_q kernel needs CUDA tensors, {name} "
                             f"is on {t.device}")
        if t.dtype != dt:
            raise TypeError(f"zo_add_q kernel: {name} must be {dt}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"zo_add_q kernel needs a contiguous {name}")
    _check_scale(q, scale, "zo_add_q")
    if dist not in _DISTS:
        raise ValueError(f"unknown zo distribution: {dist}")
    if q.dim() + prime_offset > len(zrng._DIM_PRIMES):
        raise ValueError(f"leaf rank {q.dim()} + offset {prime_offset} > "
                         f"{len(zrng._DIM_PRIMES)} unsupported")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out
    dims = (ctypes.c_int64 * q.dim())(*q.shape)
    vectorized = int(q.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    coeff_f32 = float(torch.as_tensor(coeff, dtype=torch.float32))
    launch("zo_add_q", "repro_zo_add_q", q.data_ptr(), scale.data_ptr(),
           out.data_ptr(), q.numel(), dims, q.dim(),
           _base(seed, salt, prehashed), prime_offset, coeff_f32,
           _DISTS[dist], vectorized,
           torch.cuda.current_stream(q.device).cuda_stream)
    return out


def zo_matmul_q_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    seed, salt: int, coeff, dist="rademacher",
                    prime_offset: int = 0, prehashed: bool = False):
    """Plain version: ``(f32(x) @ (q * scale + f32(coeff) * z)).to(x.dtype)``
    for x (M, K), int8 q (K, N), scale (N,)."""
    wp = zo_add_q_ref(q, scale, seed, salt, coeff, dist, prime_offset,
                      prehashed)
    return (x.to(torch.float32) @ wp).to(x.dtype)


def zo_matmul_q_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                     seed, salt: int, coeff, dist="rademacher",
                     prime_offset: int = 0, prehashed: bool = False):
    """Launch the ``zo_matmul_q`` kernel on ``torch.cuda.current_stream()``.

    ``x`` (M, K) float32 or bfloat16, ``q`` (K, N) int8, ``scale`` (N,)
    float32: contiguous CUDA tensors. Returns (M, N) in ``x``'s dtype.
    """
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if t.device.type != "cuda":
            raise ValueError(f"zo_matmul_q kernel needs CUDA tensors, {name} "
                             f"is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"zo_matmul_q kernel needs a contiguous {name}")
    if x.dtype not in _DTYPES or q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"zo_matmul_q kernel takes float32/bfloat16 x, int8 "
                        f"q and float32 scale; got {x.dtype}, {q.dtype}, "
                        f"{scale.dtype}")
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"zo_matmul_q: bad shapes x {tuple(x.shape)}, "
                         f"q {tuple(q.shape)}")
    _check_scale(q, scale, "zo_matmul_q")
    if dist not in _DISTS:
        raise ValueError(f"unknown zo distribution: {dist}")
    if prime_offset + 2 > len(zrng._DIM_PRIMES):
        raise ValueError(f"prime_offset {prime_offset} unsupported")
    m, k = x.shape
    n = q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    coeff_f32 = float(torch.as_tensor(coeff, dtype=torch.float32))
    launch("zo_matmul_q", "repro_zo_matmul_q", x.data_ptr(), q.data_ptr(),
           scale.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], m, k, n,
           _base(seed, salt, prehashed), prime_offset, coeff_f32,
           _DISTS[dist], torch.cuda.current_stream(x.device).cuda_stream,
           body=_mm_body(x.data_ptr(), q, dist, x.dtype, k, n))
    return out


# ---------------------------------------------------------------------------
# user-batched: one (seed, coeff) pair a lane, every lane in one launch

#: lanes one launch takes (the CUDA side's kMaxLanes); more are split
MAX_LANES = 64


def _lane_seeds(seeds) -> list:
    """Host ints from a sequence, numpy array or CPU tensor of seeds."""
    if isinstance(seeds, torch.Tensor):
        seeds = seeds.cpu().numpy()
    return [int(s) for s in np.asarray(seeds, dtype=np.int64).reshape(-1)]


def _lane_coeffs(coeffs, n: int) -> list:
    """n f32 coefficients (as Python floats) from a scalar or (n,)."""
    c = torch.as_tensor(coeffs, dtype=torch.float32).reshape(-1).cpu()
    if c.numel() == 1:
        c = c.expand(n)
    if c.numel() != n:
        raise ValueError(f"{c.numel()} coefficients for {n} seeds")
    return c.tolist()


def _lane_view_ok(t: torch.Tensor) -> bool:
    """Each lane t[i] is a contiguous block (any lane stride)."""
    want = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != want:
            return False
        want *= size
    return True


def zo_add_users_ref(w: torch.Tensor, seeds, salt: int, coeffs,
                     dist="rademacher", prime_offset: int = 0,
                     prehashed: bool = False) -> torch.Tensor:
    """Plain version: ``out[i] = zo_add_ref(w[i], seeds[i], salt,
    coeffs[i])`` for w (U, *leaf_shape) and U seeds."""
    seeds = _lane_seeds(seeds)
    if w.shape[0] != len(seeds):
        raise ValueError(f"zo_add_users: {len(seeds)} seeds for "
                         f"{w.shape[0]} lanes")
    coeffs = _lane_coeffs(coeffs, len(seeds))
    return torch.stack([zo_add_ref(w[i], s, salt, c, dist, prime_offset,
                                   prehashed)
                        for i, (s, c) in enumerate(zip(seeds, coeffs))])


def zo_add_users_cuda(w: torch.Tensor, seeds, salt: int, coeffs,
                      dist="rademacher", prime_offset: int = 0,
                      prehashed: bool = False, out=None, lanes=None):
    """Launch the ``zo_add_users`` kernel on the current stream.

    ``w``: (U, *leaf_shape), f32 or bf16 on the card, each lane a
    contiguous block at any lane stride (a layer slice of a stacked leaf;
    stride 0 for one leaf expanded over the lanes). Lane ``lanes[i]``
    (default ``i``) of ``out`` becomes ``w[lanes[i]] + coeffs[i] *
    z(seeds[i])``; ``out`` (may be ``w`` itself) is required when
    ``lanes`` is given, and its other lanes are left as they are.
    """
    if w.device.type != "cuda":
        raise ValueError(f"zo_add_users kernel needs a CUDA tensor, got "
                         f"{w.device}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"zo_add_users kernel takes float32/bfloat16, got "
                        f"{w.dtype}")
    if dist not in _DISTS:
        raise ValueError(f"unknown zo distribution: {dist}")
    if w.dim() < 1 or not _lane_view_ok(w):
        raise ValueError("zo_add_users kernel needs W (U, *leaf) with "
                         "contiguous lanes")
    if w.dim() - 1 + prime_offset > len(zrng._DIM_PRIMES):
        raise ValueError(f"leaf rank {w.dim() - 1} + offset {prime_offset} "
                         f"> {len(zrng._DIM_PRIMES)} unsupported")
    seeds = _lane_seeds(seeds)
    n_lanes = len(seeds)
    coeffs = _lane_coeffs(coeffs, n_lanes)
    u = w.shape[0]
    if lanes is None:
        if n_lanes != u:
            raise ValueError(f"zo_add_users: {n_lanes} seeds for {u} lanes")
        lanes = range(u)
    else:
        lanes = [int(i) for i in lanes]
        if out is None:
            raise ValueError("zo_add_users: lanes= needs out=")
        if len(lanes) != n_lanes or not all(0 <= i < u for i in lanes):
            raise ValueError(f"zo_add_users: bad lanes {lanes} for {u} "
                             f"lanes and {n_lanes} seeds")
    if out is None:
        out = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    elif (out.shape != w.shape or out.dtype != w.dtype
          or out.device != w.device or not _lane_view_ok(out)):
        raise ValueError("zo_add_users: out must match w (shape, dtype, "
                         "device) with contiguous lanes")
    leaf = tuple(w.shape[1:])
    n = int(np.prod(leaf, dtype=np.int64))
    if n == 0 or n_lanes == 0:
        return out
    dims = (ctypes.c_int64 * max(len(leaf), 1))(*leaf)
    item = w.element_size()
    ws, os_ = w.stride(0), out.stride(0)
    vectorized = int(w.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
                     and (ws * item) % 16 == 0 and (os_ * item) % 16 == 0)
    lanes = list(lanes)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    for c0 in range(0, n_lanes, MAX_LANES):
        c1 = min(c0 + MAX_LANES, n_lanes)
        k = c1 - c0
        bases = (ctypes.c_uint32 * k)(*[_base(s, salt, prehashed)
                                        for s in seeds[c0:c1]])
        cf = (ctypes.c_float * k)(*coeffs[c0:c1])
        idx = (ctypes.c_int * k)(*lanes[c0:c1])
        launch("zo_add_users", "repro_zo_add_users", w.data_ptr(),
               out.data_ptr(), n, ws, os_, _DTYPES[w.dtype], dims,
               len(leaf), bases, cf, idx, k, prime_offset, _DISTS[dist],
               vectorized, stream)
    return out


def _users_w(w: torch.Tensor, n_lanes: int, what: str):
    """(W lanes P, lane stride) of a shared (K, N) or stacked (P, K, N)
    weight for ``n_lanes`` lanes (lane i multiplies by W lane i % P)."""
    if w.dim() == 2:
        return 1, 0
    if w.dim() != 3:
        raise ValueError(f"{what}: W must be (K, N) or (P, K, N), got "
                         f"{tuple(w.shape)}")
    p = w.shape[0]
    if p == 0 or n_lanes % p:
        raise ValueError(f"{what}: {n_lanes} lanes over {p} W lanes")
    return p, w.stride(0)


def _lane_chunks(n_lanes: int, p: int):
    """(first lane, end lane, W lanes) of each launch: at most MAX_LANES
    lanes, every chunk's lane j multiplying by W lane (first + j) % P --
    a chunk starts at a multiple of P (P <= MAX_LANES) or stays inside
    one run of P lanes."""
    if p <= MAX_LANES:
        step = (MAX_LANES // p) * p
        return [(c0, min(c0 + step, n_lanes), p)
                for c0 in range(0, n_lanes, step)]
    return [(c0, min(c0 + MAX_LANES, r0 + p), min(MAX_LANES, r0 + p - c0))
            for r0 in range(0, n_lanes, p)
            for c0 in range(r0, r0 + p, MAX_LANES)]


def zo_matmul_users_ref(x: torch.Tensor, w: torch.Tensor, seeds, salt: int,
                        coeffs, dist="rademacher", prime_offset: int = 0,
                        prehashed: bool = False, scale=None):
    """Plain version: ``out[i] = zo_matmul_ref(x[i], W_i, seeds[i], salt,
    coeffs[i])`` (or ``zo_matmul_q_ref`` with ``scale``) for x (U, M, K);
    ``W_i`` is the shared w (K, N) or lane ``i % P`` of a stacked
    (P, K, N) w."""
    seeds = _lane_seeds(seeds)
    if x.dim() != 3 or x.shape[0] != len(seeds):
        raise ValueError(f"zo_matmul_users: x {tuple(x.shape)} for "
                         f"{len(seeds)} seeds")
    coeffs = _lane_coeffs(coeffs, len(seeds))
    p, _ = _users_w(w, len(seeds), "zo_matmul_users")
    outs = []
    for i, (s, c) in enumerate(zip(seeds, coeffs)):
        wi = w if w.dim() == 2 else w[i % p]
        if scale is None:
            outs.append(zo_matmul_ref(x[i], wi, s, salt, c, dist,
                                      prime_offset, prehashed))
        else:
            outs.append(zo_matmul_q_ref(x[i], wi, scale, s, salt, c, dist,
                                        prime_offset, prehashed))
    return torch.stack(outs)


def zo_matmul_users_cuda(x: torch.Tensor, w: torch.Tensor, seeds,
                         salt: int, coeffs, dist="rademacher",
                         prime_offset: int = 0, prehashed: bool = False,
                         scale=None):
    """Launch ``zo_matmul_users`` (or, with ``scale``, ``zo_matmul_users_q``)
    on the current stream.

    ``x`` (U, M, K) contiguous, float32 or bfloat16; ``w`` a shared (K, N)
    weight of x's dtype or a stacked (P, K, N) one (U % P == 0, each lane
    contiguous at any lane stride); with ``scale`` (N,) float32, ``w`` is
    a shared int8 (K, N). Returns (U, M, N) in x's dtype.
    """
    kernel = "zo_matmul_users" if scale is None else "zo_matmul_users_q"
    ts = [("x", x), ("w", w)] + ([] if scale is None else [("scale", scale)])
    for name, t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{kernel} kernel needs CUDA tensors, {name} "
                             f"is on {t.device}")
    if not x.is_contiguous() or (scale is not None
                                 and not scale.is_contiguous()):
        raise ValueError(f"{kernel} kernel needs a contiguous x and scale")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{kernel} kernel takes float32/bfloat16 x, got "
                        f"{x.dtype}")
    if scale is None and w.dtype != x.dtype:
        raise TypeError(f"{kernel} kernel takes x and w of one dtype; got "
                        f"{x.dtype}, {w.dtype}")
    if scale is not None:
        if w.dtype != torch.int8 or scale.dtype != torch.float32 \
                or w.dim() != 2:
            raise TypeError(f"{kernel} kernel takes a shared int8 (K, N) w "
                            f"and float32 scale; got {w.dtype} "
                            f"{tuple(w.shape)}, {scale.dtype}")
        _check_scale(w, scale, kernel)
    seeds = _lane_seeds(seeds)
    n_lanes = len(seeds)
    coeffs = _lane_coeffs(coeffs, n_lanes)
    if x.dim() != 3 or x.shape[0] != n_lanes:
        raise ValueError(f"{kernel}: x {tuple(x.shape)} for {n_lanes} seeds")
    p, w_stride = _users_w(w, n_lanes, kernel)
    wl = w if w.dim() == 2 else w[0]
    if not _lane_view_ok(w if w.dim() == 3 else w[None]) \
            or x.shape[2] != wl.shape[0]:
        raise ValueError(f"{kernel}: bad shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} (or W lanes not contiguous)")
    if dist not in _DISTS:
        raise ValueError(f"unknown zo distribution: {dist}")
    if prime_offset + 2 > len(zrng._DIM_PRIMES):
        raise ValueError(f"prime_offset {prime_offset} unsupported")
    _, m, k = x.shape
    n = wl.shape[1]
    out = torch.empty((n_lanes, m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for c0, c1, w_lanes in _lane_chunks(n_lanes, p):
        cnt = c1 - c0
        bases = (ctypes.c_uint32 * cnt)(*[_base(s, salt, prehashed)
                                          for s in seeds[c0:c1]])
        cf = (ctypes.c_float * cnt)(*coeffs[c0:c1])
        xp = x.data_ptr() + c0 * m * k * x.element_size()
        yp = out.data_ptr() + c0 * m * n * out.element_size()
        if scale is None:
            wp = w.data_ptr() + (c0 % p) * w_stride * w.element_size()
            launch(kernel, "repro_zo_matmul_users", xp, wp, yp,
                   _DTYPES[x.dtype], m, k, n, w_stride, w_lanes, bases, cf,
                   cnt, prime_offset, _DISTS[dist], stream,
                   body=_mm_body(xp, w, dist, x.dtype, k, n, w_stride, wp))
        else:
            launch(kernel, "repro_zo_matmul_users_q", xp, w.data_ptr(),
                   scale.data_ptr(), yp, _DTYPES[x.dtype], m, k, n, bases,
                   cf, cnt, prime_offset, _DISTS[dist], stream,
                   body=_mm_body(xp, w, dist, x.dtype, k, n))
    return out

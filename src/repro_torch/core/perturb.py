"""Seed-replay perturbation of a flat parameter dict: theta + c * z(seed).

Port of the JAX package's ``core/perturb.py``. Parameters are a flat
``dict[str, Tensor]`` keyed by the JAX package's ``/``-joined leaf paths
(``blocks/attn/wq/w``); a leaf's z-field salt is the crc32 of that path,
and z spans the leaf's whole (stacked) shape. A
:class:`~repro_torch.optim.quant.QuantizedLeaf` is atomic: its salt is
the leaf's path (never ``.../q``), the update lands in its f32 ``delta``
while the int8 values and scales stay frozen, and a delta-less leaf (a
frozen base) passes through untouched.

:func:`add_scaled_z_users` is the multi-tenant counterpart: over a
user-stacked dict (``core.batching``: a leading lane axis on every plain
leaf and every delta) it adds ``coeffs[i] * z(seeds[i])`` to lane
``lanes[i]`` of every leaf, one ``zo_add_users`` launch a leaf.

Dispatch follows the device: a CUDA leaf goes through the hand-written
``zo_add`` kernel -- every floating leaf, of any shape, since the kernel
masks its own edges -- and a CPU leaf through its plain version. The
values are the same either way (bit for bit with Rademacher z).

:func:`dot_with_z` is ``<tangent, z(seed)>``, the estimator cross-check:
autograd's gradient projected on the z a direction perturbs along.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import rng as zrng
from repro_torch.kernels import ops as kops
from repro_torch.optim.quant import is_quantized

Params = Dict[str, torch.Tensor]


def _path_str(path) -> str:
    """``/``-join a key path (strings, ints or objects with ``key``/``idx``,
    as JAX's tree paths carry them)."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def leaf_salts(params: Params) -> Dict[str, int]:
    """Per-leaf salts (python ints), keyed like ``params``."""
    return {path: zrng.leaf_salt(path) for path in params}


def is_perturbable(path_str: str) -> bool:
    """The JAX package's filter of the leaves that receive ZO noise, which
    passes every one. The port keeps no filter: :func:`add_scaled_z`,
    the user-axis sweep and :class:`~repro_torch.core.PerturbCtx` perturb
    every floating leaf, and :func:`dot_with_z` projects on those."""
    return True


def add_scaled_z(params: Params, seed, coeff, dist: str = "rademacher",
                 use_kernel: bool = False, inplace: bool = False) -> Params:
    """theta + coeff * z(seed), leaf-wise, z regenerated (never stored).

    ``coeff`` is rounded to float32 once, as the JAX package does.
    ``use_kernel`` mirrors the JAX signature and has no effect: the
    leaf's device picks the kernel or the plain version. ``inplace``
    writes every leaf in place and returns ``params`` itself (the walk
    estimator's sweeps: peak memory stays one copy of the parameters,
    what the JAX package gets by donating them).
    """
    del use_kernel
    coeff = torch.as_tensor(coeff, dtype=torch.float32)
    out = params if inplace else {}
    for path, leaf in params.items():
        if is_quantized(leaf):
            if leaf.delta is not None:
                d = kops.zo_add(leaf.delta, seed, zrng.leaf_salt(path),
                                coeff, dist=dist,
                                out=leaf.delta if inplace else None)
                leaf = leaf if inplace else dataclasses.replace(leaf,
                                                                delta=d)
            out[path] = leaf
            continue
        if not leaf.is_floating_point():
            out[path] = leaf
            continue
        out[path] = kops.zo_add(leaf, seed, zrng.leaf_salt(path), coeff,
                                dist=dist, out=leaf if inplace else None)
    return out


def add_scaled_z_users(params: Params, seeds, coeffs,
                       dist: str = "rademacher", lanes=None,
                       inplace: bool = False) -> Params:
    """Lane ``lanes[i]`` (default ``i``) of every user-stacked leaf plus
    ``coeffs[i] * z(seeds[i])``: each lane bit for bit the scalar
    :func:`add_scaled_z` with that lane's (seed, coeff), one
    ``zo_add_users`` launch a leaf. Lanes not listed keep their bits;
    ``inplace`` writes the leaves (and deltas) in place and returns
    ``params`` itself."""
    out = params if inplace else {}
    for path, leaf in params.items():
        salt = zrng.leaf_salt(path)
        if is_quantized(leaf):
            if leaf.delta is not None:
                dst = leaf.delta if inplace else (
                    None if lanes is None else leaf.delta.clone())
                d = kops.zo_add_users(leaf.delta, seeds, salt, coeffs,
                                      dist=dist, out=dst, lanes=lanes)
                leaf = leaf if inplace else dataclasses.replace(leaf,
                                                                delta=d)
            out[path] = leaf
            continue
        if not leaf.is_floating_point():
            out[path] = leaf
            continue
        dst = leaf if inplace else (None if lanes is None else leaf.clone())
        out[path] = kops.zo_add_users(leaf, seeds, salt, coeffs, dist=dist,
                                      out=dst, lanes=lanes)
    return out


def dot_with_z(params_like: Params, seed, tangent: Params,
               dist: str = "rademacher") -> torch.Tensor:
    """``<tangent, z(seed)>`` as an f32 0-dim tensor on the tangents'
    device: each floating leaf of ``params_like`` salts z by its path, as
    :func:`add_scaled_z` does, and its tangent (keyed alike; a
    :class:`~repro_torch.optim.quant.QuantizedLeaf` dequantized to f32)
    is dotted with it in f32. Non-floating leaves are skipped."""
    acc = None
    for path, leaf in params_like.items():
        if not leaf.dtype.is_floating_point:
            continue
        t = tangent[path]
        t = t.dequantize_f32() if is_quantized(t) else t.to(torch.float32)
        z = zrng.z_field(seed, zrng.leaf_salt(path), tuple(leaf.shape),
                         torch.float32, dist, device=t.device)
        d = torch.dot(t.reshape(-1), z.reshape(-1))
        acc = d if acc is None else acc + d
    return acc if acc is not None else torch.zeros((), dtype=torch.float32)

"""Perturbed-forward execution context (the fused MeZO path).

Port of the JAX package's ``core/perturb_ctx.py``. The unperturbed
parameters flow into the forward with a :class:`PerturbCtx` carrying
``(seed, coeff, dist)``, and each consumer applies its leaf's
perturbation at the point of use:

  * dense projections (Q/K/V/O, MLP up/down, the LM head) compute
    ``X @ (W + coeff*z)`` through ``kernels.ops.zo_matmul`` -- on the
    card the ``zo_matmul`` kernel, z regenerated per tile, never in
    device memory. Every floating 2-D weight takes it (the kernel masks
    its own edges; there is no alignment gate);
  * embedding gathers perturb only the gathered rows (``rng.z_rows``);
  * small leaves (norm scales, biases) take ``kernels.ops.zo_add`` into
    a transient -- the ``zo_add`` kernel on the card, the same bits as
    the JAX package's jnp expression.

Semantics of the perturbed matmul: the Pallas kernel's. ``W + coeff*z``
stays in f32 and is dotted in f32 with ``f32(X)``; the product is cast
to X's dtype. The JAX package has a second semantics, its jnp fallback
(taken off the TPU kernel path), which rounds ``W + coeff*z`` back to
the leaf's dtype before the dot. The two agree in f32 (the reduced
configs, RoBERTa-large) and the port matches both there; in bf16
(full-width OPT-1.3B) the port follows the kernel, on the CPU and on
the card alike.

Quantized bases (``optim/quant.py``): every primitive takes a
``QuantizedLeaf`` in place of a tensor, in the JAX package's dispatch. A
frozen (delta-less) leaf takes the int8 kernels: ``matmul`` is
``zo_matmul(scale=)`` (``X @ (q*s + coeff*z)``, f32 W' and f32 dot) and
``perturb`` is ``zo_add(scale=)`` rounded to the leaf's logical dtype. A
leaf with a delta (training) takes the reference's fallback:
``perturb`` forms f32 ``q*s + delta``, adds ``coeff*z`` in place through
``zo_add`` and rounds to the logical dtype, and ``matmul`` is ``x @
perturb(w)`` -- a bf16 W' and a bf16 product at full width, as the JAX
package computes that branch. ``take`` dequantizes only the gathered
rows.

**User-axis mode**: a sequence of n seeds (``coeff`` one number or n)
batches the ctx over n lanes -- the multi-tenant step's users, both
signs of each user's direction in one forward. Activations carry the
lanes flattened into the batch (``(n * B, ...)``); the parameters are
user-stacked as ``core.batching`` lays them out: every plain leaf and
every delta carries a leading axis of P lanes (n a multiple of P; lane i
reads leaf lane ``i % P``), a ``QuantizedLeaf``'s ``q`` and ``scale``
stay the one shared int8 base, and a frozen leaf has no lane axis. One
base shared by every lane is its one-lane view (P = 1, ``v[None]``).
Each primitive returns its
result with a leading lane axis: ``matmul`` is one ``zo_matmul_users``
launch a projection (``zo_matmul_users(scale=)`` over a frozen int8
leaf), ``perturb`` one ``zo_add_users`` launch (a leaf with deltas forms
its per-lane f32 W' = q*s + delta[i] and perturbs it in place), and a
leaf with deltas multiplies lane by lane at the scalar path's shapes, so
every lane is bit for bit a scalar ctx with that lane's (seed, coeff).

**Sharded mode**: a leaf that is a DTensor (``models/sharding.py``)
takes the kernels' local forms (``kernels/ops.py``): ``perturb`` and
``matmul`` run on this rank's shard at its global offsets, so every
shard's z is the unsharded z's slice; ``take`` of a vocab-sharded table
gathers the ids this rank owns and sums the rows over the mesh, the
Megatron vocab-parallel embedding.

Salts are the crc32 of the leaf's ``/``-joined path in the stacked
parameter tree (``blocks/attn/wq/w``), and a layer's slice of a stacked
``(L, ...)`` leaf folds the layer index into the pre-hashed base with
``prime_offset=1`` -- so every leaf sees exactly the z-field that
``add_scaled_z`` applies to the whole tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import rng as zrng
from repro_torch.core.batching import user_lanes
from repro_torch.core.dtensor import (contiguous_stride, is_dtensor,
                                      local_offsets, settle)
from repro_torch.kernels import ops as kops
from repro_torch.optim.quant import is_quantized, take_rows_f32


@dataclasses.dataclass(frozen=True)
class PerturbCtx:
    """theta + coeff * z(seed), applied lazily at each parameter's use.

    ``seed`` is the direction seed (a host int), ``coeff`` the host f32
    value ``+eps`` or ``-eps``: a kernel launch never waits for the
    device. ``prefix`` is the parameter path of the current scope and
    ``layer`` the bound index into stacked ``(L, ...)`` leaves. A
    sequence of seeds switches on the user-axis mode (see the module
    docstring).
    """
    seed: Any
    coeff: Any
    dist: str = "rademacher"
    prefix: str = ""
    layer: Optional[int] = None

    def __post_init__(self):
        if np.ndim(self.seed) == 1:        # user-axis mode: host scalars
            seeds = tuple(int(s) for s in np.asarray(
                torch.as_tensor(self.seed).cpu(), np.int64))
            c = torch.as_tensor(self.coeff, dtype=torch.float32).reshape(-1)
            if c.numel() == 1:
                c = c.expand(len(seeds))
            if c.numel() != len(seeds):
                raise ValueError(f"{c.numel()} coefficients for "
                                 f"{len(seeds)} lanes")
            object.__setattr__(self, "seed", seeds)
            object.__setattr__(self, "coeff", tuple(c.cpu().tolist()))

    # -- scope plumbing ----------------------------------------------------

    def scope(self, name: str) -> "PerturbCtx":
        """Descend into a param sub-dict (extends the salt path)."""
        p = f"{self.prefix}/{name}" if self.prefix else name
        return dataclasses.replace(self, prefix=p)

    def at_layer(self, idx: int) -> "PerturbCtx":
        """Bind the leading index of stacked (L, ...) leaves."""
        return dataclasses.replace(self, layer=int(idx))

    def _leaf(self, name: str):
        """(pre-hashed base, prime offset) of a named leaf's z-field."""
        path = f"{self.prefix}/{name}" if self.prefix else name
        base = zrng.leaf_base(self.seed, zrng.leaf_salt(path))
        if self.layer is None:
            return base, 0
        return zrng.fold_leading(base, self.layer, dim=0), 1

    def _leaf_users(self, name: str):
        """:meth:`_leaf` in user-axis mode: (per-lane bases, offset)."""
        path = f"{self.prefix}/{name}" if self.prefix else name
        salt = zrng.leaf_salt(path)
        bases = [zrng.leaf_base(s, salt) for s in self.seed]
        if self.layer is None:
            return bases, 0
        return [zrng.fold_leading(b, self.layer, dim=0) for b in bases], 1

    # -- user axis ---------------------------------------------------------

    @property
    def batched(self) -> bool:
        """True in user-axis mode (a sequence of lane seeds)."""
        return isinstance(self.seed, tuple)

    @property
    def n_lanes(self) -> int:
        return len(self.seed) if self.batched else 1

    def _lane(self, seed, coeff) -> "PerturbCtx":
        """The scalar ctx of one lane (each lane's bits are its)."""
        return dataclasses.replace(self, seed=int(seed), coeff=coeff)

    def lanes(self):
        """The scalar ctx of every lane, in lane order: what a block that
        runs its lanes one at a time (the MoE dispatch) perturbs with."""
        return [self._lane(s, c) for s, c in zip(self.seed, self.coeff)]

    def _by_lane(self, t: torch.Tensor, p: Optional[int]) -> torch.Tensor:
        """A shared leaf (p None) or a (p, ...) per-user one as an
        (n, ...) tensor whose lane i is leaf lane i % p: a stride-0 view,
        the leaf itself, or (n = R * p) a copy."""
        n = self.n_lanes
        if p is None:
            t, p = t[None], 1
        if n % p:
            raise ValueError(f"{n} lanes over a leaf of {p} lanes")
        if p == 1:
            return t.expand(n, *t.shape[1:])
        return t if p == n else t.repeat(n // p, *([1] * (t.dim() - 1)))

    def _lane_f32(self, leaf) -> torch.Tensor:
        """(n, ...) f32 effective weight of a quantized leaf with a delta,
        ``q*s + delta[i % P]``: a fresh tensor the caller may write."""
        return leaf.base_f32() + self._by_lane(leaf.delta, user_lanes(leaf))

    def lane_view(self, x: torch.Tensor) -> torch.Tensor:
        """``(n * B, ...)`` activations as ``(n, B, ...)``."""
        return x.reshape(self.n_lanes, -1, *x.shape[1:])

    def split_lanes(self, x: torch.Tensor):
        """The lanes of an activation batch ``(n * B, ...)``: n views of
        the scalar path's shape ``(B, ...)``."""
        return self.lane_view(x).unbind(0)

    def _perturb_users(self, name: str, leaf) -> torch.Tensor:
        bases, off = self._leaf_users(name)
        if is_quantized(leaf):
            if leaf.delta is None:
                # a frozen leaf: q*s is exact in f32, so adding c*z to it
                # is zo_add_q's value bit for bit
                w = self._by_lane(leaf.base_f32(), None)
                w = kops.zo_add_users(w, bases, 0, self.coeff,
                                      dist=self.dist, prime_offset=off,
                                      prehashed=True)
            else:
                w = self._lane_f32(leaf)
                kops.zo_add_users(w, bases, 0, self.coeff, dist=self.dist,
                                  prime_offset=off, prehashed=True, out=w)
            return w.to(leaf.dtype)
        if not leaf.is_floating_point():
            return leaf
        return kops.zo_add_users(self._by_lane(leaf, user_lanes(leaf)),
                                 bases, 0, self.coeff, dist=self.dist,
                                 prime_offset=off, prehashed=True)

    def _matmul_users(self, x: torch.Tensor, w, name: str) -> torch.Tensor:
        """x (n * B, ..., K): one ``zo_matmul_users`` launch over a shared
        or per-lane W (``zo_matmul_users(scale=)`` over a frozen int8
        leaf); a leaf with deltas takes the reference's fallback lane by
        lane at the scalar path's shapes."""
        if is_quantized(w) and w.delta is not None:
            wp = self._perturb_users(name, w)
            return torch.cat([xu @ wu for xu, wu in
                              zip(self.split_lanes(x), wp.unbind(0))])
        if not is_quantized(w) and not w.is_floating_point():
            return x @ w
        bases, off = self._leaf_users(name)
        n = self.n_lanes
        k = x.shape[-1]
        xl = x.reshape(n, -1, k).contiguous()
        wt, scale = (w.q, w.scale) if is_quantized(w) else (w, None)
        y = kops.zo_matmul_users(xl, wt, bases, 0, self.coeff,
                                 dist=self.dist, prime_offset=off,
                                 prehashed=True, scale=scale)
        return y.reshape(*x.shape[:-1], y.shape[-1])

    def _take_users(self, name: str, table, ids: torch.Tensor):
        """ids (n, ...): lane i gathers from table lane i % P."""
        n = self.n_lanes
        bases, off = self._leaf_users(name)
        lane = (torch.arange(n, device=ids.device)
                .reshape((n,) + (1,) * (ids.dim() - 1)))
        p = user_lanes(table)
        if is_quantized(table):
            rows = table.q[ids].to(torch.float32) * table.scale
            if table.delta is not None:
                rows = rows + (table.delta[ids] if p is None
                               else table.delta[lane % p, ids])
        else:
            rows = (table[ids] if p is None
                    else table[lane % p, ids]).to(torch.float32)
        base = host_to(bases, torch.int64, ids.device).reshape(lane.shape)
        z = zrng.z_rows(base, ids, table.shape[-1], torch.float32,
                        self.dist, prime_offset=off)
        c = host_to(self.coeff, torch.float32, ids.device).reshape(
            lane.shape + (1,))
        return (rows + c * z).to(table.dtype)

    def _coeff(self) -> torch.Tensor:
        return torch.as_tensor(self.coeff, dtype=torch.float32)

    # -- perturbation primitives ------------------------------------------

    def perturb(self, name: str, leaf) -> torch.Tensor:
        """leaf + coeff*z into a transient, in the leaf's (logical)
        dtype; in user-axis mode with a leading lane axis."""
        if self.batched:
            return self._perturb_users(name, leaf)
        base, off = self._leaf(name)
        if is_quantized(leaf):
            if leaf.delta is None:
                w = kops.zo_add(leaf.q, base, 0, self._coeff(),
                                dist=self.dist, prime_offset=off,
                                prehashed=True, scale=leaf.scale)
            else:
                w = leaf.dequantize_f32()
                kops.zo_add(w, base, 0, self._coeff(), dist=self.dist,
                            prime_offset=off, prehashed=True, out=w)
            return w.to(leaf.dtype)
        if not leaf.is_floating_point():
            return leaf
        return kops.zo_add(leaf, base, 0, self._coeff(), dist=self.dist,
                           prime_offset=off, prehashed=True)

    def matmul(self, x: torch.Tensor, w, name: str = "w") -> torch.Tensor:
        """x @ (w + coeff*z) for x (..., K), w (K, N) (in user-axis mode
        x (n * B, ..., K), w shared or per-lane)."""
        if self.batched:
            return self._matmul_users(x, w, name)
        if is_dtensor(w):
            base, off = self._leaf(name)
            return kops.zo_matmul(x, w, base, 0, self._coeff(),
                                  dist=self.dist, prime_offset=off,
                                  prehashed=True)
        if is_quantized(w) and w.delta is not None:
            return x @ self.perturb(name, w)
        if not is_quantized(w) and not w.is_floating_point():
            return x @ w
        base, off = self._leaf(name)
        k, n = w.shape
        lead = x.shape[:-1]
        wt, scale = (w.q, w.scale) if is_quantized(w) else (w, None)
        y = kops.zo_matmul(x.reshape(-1, k).contiguous(), wt, base, 0,
                           self._coeff(), dist=self.dist, prime_offset=off,
                           prehashed=True, scale=scale)
        return y.reshape(*lead, n)

    def take(self, name: str, table, ids: torch.Tensor) -> torch.Tensor:
        """(table + coeff*z)[ids], perturbing only the gathered rows:
        O(tokens * d) transient z, never O(vocab * d); a quantized table
        dequantizes only those rows. In user-axis mode ``ids`` carries a
        leading lane axis."""
        if not is_quantized(table) and not table.is_floating_point():
            return table[ids]
        if self.batched:
            return self._take_users(name, table, ids)
        base, off = self._leaf(name)
        if is_dtensor(table):
            return take_sharded(table, ids, base, off, self._coeff(),
                                self.dist)
        rows = take_rows_f32(table, ids)
        z = zrng.z_rows(base, ids, table.shape[1], torch.float32, self.dist,
                        prime_offset=off)
        c = host_to(self.coeff, torch.float32, rows.device)
        return (rows + c * z).to(table.dtype)

    def materialize(self, subtree: Dict[str, Any],
                    name: str = "") -> Dict[str, torch.Tensor]:
        """Perturb every leaf of a param subtree -- a flat ``/``-keyed
        dict or a nested one (a block's sub-dict, as the MoE block takes
        it) -- into a transient copy of the same layout. Scoped at the
        root it is the parity oracle the fused forward is held
        against."""
        ctx = self.scope(name) if name else self
        return {path: ctx.materialize(leaf, path) if isinstance(leaf, dict)
                else ctx.perturb(path, leaf)
                for path, leaf in subtree.items()}


def take_sharded(table, ids, base=None, off: int = 0, coeff=None,
                 dist: str = "rademacher"):
    """``(table + coeff * z)[ids]`` (without ``base``: ``table[ids]``) for
    a DTensor table whose rows are sharded on at most one mesh dim: each
    rank gathers the ids in its row block (its rows' z by their global
    ids), zeros elsewhere, and the sum over that mesh dim (one all-reduce
    of the gathered rows) is the result (``ids`` replicated there)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ids_l = ids._local_tensor if is_dtensor(ids) else ids
    ids_pl = (ids.placements if is_dtensor(ids)
              else (Replicate(),) * table.device_mesh.ndim)
    local = table._local_tensor
    r0 = local_offsets(table)[0]
    n_rows = local.shape[0]
    pl = []
    sharded = False
    for tp, ip in zip(table.placements, ids_pl):
        if isinstance(tp, Shard) and tp.dim == 0:
            if not isinstance(ip, Replicate) or sharded:
                raise ValueError(f"take: rows sharded as {table.placements} "
                                 f"with ids placed {ids_pl}")
            sharded = True
            pl.append(Partial())
        elif isinstance(tp, Replicate):
            pl.append(ip)
        else:
            raise ValueError(f"take: no local form for a table placed "
                             f"{table.placements}")
    mine = (ids_l >= r0) & (ids_l < r0 + n_rows)
    rows = local[torch.where(mine, ids_l - r0, 0)].to(torch.float32)
    if base is not None:
        z = zrng.z_rows(base, ids_l, table.shape[1], torch.float32, dist,
                        prime_offset=off)
        rows = rows + host_to(coeff, torch.float32, rows.device) * z
    rows = torch.where(mine[..., None], rows, 0.0).to(table.dtype)
    shape = tuple(ids.shape) + (table.shape[1],)
    return settle(DTensor.from_local(rows, table.device_mesh, pl,
                                     shape=torch.Size(shape),
                                     stride=contiguous_stride(shape)))


def host_to(values, dtype, device) -> torch.Tensor:
    """Host numbers as a tensor on ``device``: on the card through pinned
    memory without waiting for the stream (a plain host-to-device copy
    would synchronize it)."""
    t = torch.as_tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def sub(ctx: Optional[PerturbCtx], name: str) -> Optional[PerturbCtx]:
    """ctx.scope(name), passing None through (unperturbed forward)."""
    return None if ctx is None else ctx.scope(name)

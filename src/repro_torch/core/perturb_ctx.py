"""Perturbed-forward execution context (the fused MeZO path).

Port of the JAX package's ``core/perturb_ctx.py`` in scalar mode (the
user-axis mode comes with the multi-tenant slice). The unperturbed
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

Salts are the crc32 of the leaf's ``/``-joined path in the stacked
parameter tree (``blocks/attn/wq/w``), and a layer's slice of a stacked
``(L, ...)`` leaf folds the layer index into the pre-hashed base with
``prime_offset=1`` -- so every leaf sees exactly the z-field that
``add_scaled_z`` applies to the whole tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core import rng as zrng
from repro_torch.kernels import ops as kops
from repro_torch.optim.quant import is_quantized, take_rows_f32


@dataclasses.dataclass(frozen=True)
class PerturbCtx:
    """theta + coeff * z(seed), applied lazily at each parameter's use.

    ``seed`` is the direction seed (a host int), ``coeff`` the host f32
    value ``+eps`` or ``-eps``: a kernel launch never waits for the
    device. ``prefix`` is the parameter path of the current scope and
    ``layer`` the bound index into stacked ``(L, ...)`` leaves.
    """
    seed: Any
    coeff: Any
    dist: str = "rademacher"
    prefix: str = ""
    layer: Optional[int] = None

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

    def _coeff(self) -> torch.Tensor:
        return torch.as_tensor(self.coeff, dtype=torch.float32)

    # -- perturbation primitives ------------------------------------------

    def perturb(self, name: str, leaf) -> torch.Tensor:
        """leaf + coeff*z into a transient, in the leaf's (logical)
        dtype."""
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
        """x @ (w + coeff*z) for x (..., K), w (K, N)."""
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
        dequantizes only those rows."""
        if not is_quantized(table) and not table.is_floating_point():
            return table[ids]
        base, off = self._leaf(name)
        rows = take_rows_f32(table, ids)
        z = zrng.z_rows(base, ids, table.shape[1], torch.float32, self.dist,
                        prime_offset=off)
        return (rows + self._coeff().to(rows.device) * z).to(table.dtype)

    def materialize(self, subtree: Dict[str, Any],
                    name: str = "") -> Dict[str, torch.Tensor]:
        """Perturb every leaf of a flat ``/``-keyed param subtree into a
        transient copy (scoped at the root: the parity oracle the fused
        forward is held against)."""
        ctx = self.scope(name) if name else self
        return {path: ctx.perturb(path, leaf)
                for path, leaf in subtree.items()}


def sub(ctx: Optional[PerturbCtx], name: str) -> Optional[PerturbCtx]:
    """ctx.scope(name), passing None through (unperturbed forward)."""
    return None if ctx is None else ctx.scope(name)

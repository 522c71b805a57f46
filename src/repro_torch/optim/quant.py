"""int8 quantization: the quantized-base runtime and the int8 helpers.

Port of the JAX package's ``optim/quant.py``. PocketLLM's headline claim
is memory, and the resident base weights are its last lever: this module
holds the quantized-base representation the port threads through.

* :class:`QuantizedLeaf` -- one parameter leaf as int8 values plus
  per-channel f32 scales (absmax over the contraction axis ``-2``,
  rounded up to a power of two so ``q*scale`` is exact in f32; a
  ``(K, N)`` projection carries an ``(N,)`` scale and a stacked
  ``(L, K, N)`` leaf an ``(L, N)`` one). An optional f32 ``delta``
  carries the accumulated ZO updates: the int8 base stays frozen and
  training writes only the additive side. A leaf sits in the flat
  ``/``-keyed parameter dict at its own path (never at ``.../q``), so
  its z-field salt is that of the unquantized leaf.
* :func:`quantize_tree` -- one-shot, deterministic round-to-nearest base
  quantization, with the scale computed in the reference's arithmetic:
  ``absmax * f32(1/127)``, ``log(a) * f32(1/ln 2)``, ceil, a power of
  two; subnormal ``a`` (which the reference flushes to zero) and
  non-finite ones get 1.0.
* use-site helpers (:func:`deq`, :func:`take_rows`,
  :func:`dequantize_tree`) that pass plain tensors through, so the model
  code has one path for quantized and full-precision bases.

The per-tensor stochastic ``int8_quantize`` / ``int8_dequantize`` (the
adapter store's compact delta form) draw their uniforms from the
``core.rng`` coordinate hash (seed ``0x51CA``, salt ``0xC0DE``), as the
reference does; deterministic per-channel quantization (the base) and
stochastic per-tensor quantization (wire deltas) are different codes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

_F32 = torch.float32
#: the reference divides by the constant 127 and by the constant log(2)
#: as multiplications by their f32 reciprocals; so does the port
_INV_127 = float(np.float32(1.0) / np.float32(127.0))
_INV_LN2 = float(np.float32(1.0) / np.log(np.float32(2.0)))
_TINY = float(np.finfo(np.float32).tiny)     # smallest normal f32

#: supported --quant modes ("none" is the full-precision passthrough)
QUANT_MODES = ("none", "int8")


def check_quant_mode(mode: str) -> str:
    """Validate a quantization mode name (mirrors the engine's
    estimator/update registry errors)."""
    if mode not in QUANT_MODES:
        raise ValueError(
            f"unknown quantization mode {mode!r}; supported modes: "
            f"{list(QUANT_MODES)}")
    return mode


# ---------------------------------------------------------------------------
# per-tensor stochastic int8 (the adapter store's compact delta form)


def int8_quantize(g: torch.Tensor, seed: int = 0x51CA):
    """(int8 values, f32 0-dim scale on ``g``'s device): stochastic
    rounding of ``g / scale`` with uniforms from the coordinate hash.
    The division is by a tensor on ``g``'s device, so it is a true
    division on the card too (a CUDA division by a host scalar would
    multiply by its reciprocal)."""
    from repro_torch.core import rng as zrng  # core imports this module
    gf = g.to(_F32)
    scale = (gf.abs().amax() * torch.tensor(_INV_127, device=g.device)
             + torch.tensor(1e-30, dtype=_F32, device=g.device))
    x = gf / scale
    bits = zrng._coord_hash(seed, 0xC0DE, g.shape, device=g.device)
    u = (bits >> 8).to(_F32) * (1.0 / 16777216.0)
    q = torch.clamp(torch.floor(x + u), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale, dtype=_F32) -> torch.Tensor:
    s = torch.as_tensor(scale, dtype=_F32, device=q.device)
    return (q.to(_F32) * s).to(dtype)


# ---------------------------------------------------------------------------
# the quantized-base leaf


@dataclasses.dataclass(frozen=True, eq=False)
class QuantizedLeaf:
    """One frozen int8 base leaf (+ optional f32 adapter delta).

    Effective weight: ``q * expand(scale) (+ delta)``. ``scale`` is f32
    of shape ``shape[:-2] + (shape[-1],)``; ``delta`` is ``None`` (a
    frozen base: ``add_scaled_z`` passes it through) or a full-shape f32
    tensor. ``orig_dtype`` is the logical dtype, the one a
    full-precision base would carry.
    """
    q: torch.Tensor
    scale: torch.Tensor
    delta: Optional[torch.Tensor] = None
    orig_dtype: torch.dtype = _F32

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def dtype(self) -> torch.dtype:
        """The logical dtype (what a full-precision base would be)."""
        return self.orig_dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        n = tensor_bytes(self.q) + tensor_bytes(self.scale)
        return n + (tensor_bytes(self.delta) if self.delta is not None
                    else 0)

    def to(self, device) -> "QuantizedLeaf":
        """The leaf on ``device``: q, scale and delta moved together (a
        tensor's ``.to(device)``, so a parameter dict moves leaf by
        leaf)."""
        return QuantizedLeaf(
            q=self.q.to(device), scale=self.scale.to(device),
            delta=None if self.delta is None else self.delta.to(device),
            orig_dtype=self.orig_dtype)

    def layer(self, i: int) -> "QuantizedLeaf":
        """Layer ``i`` of a stacked ``(L, ...)`` leaf: q, scale and delta
        sliced together (views)."""
        return QuantizedLeaf(
            q=self.q[i], scale=self.scale[i],
            delta=None if self.delta is None else self.delta[i],
            orig_dtype=self.orig_dtype)

    def base_f32(self) -> torch.Tensor:
        """The frozen base alone, ``q*scale``, in f32 (exact: int8 times
        a power-of-two scale)."""
        return self.q.to(_F32) * _expand(self.scale)

    def dequantize_f32(self) -> torch.Tensor:
        """``q*scale (+ delta)`` in f32."""
        w = self.base_f32()
        if self.delta is not None:
            w = w + self.delta
        return w

    def dequantize(self) -> torch.Tensor:
        """Effective weight in the logical dtype."""
        return self.dequantize_f32().to(self.orig_dtype)


def is_quantized(x) -> bool:
    return isinstance(x, QuantizedLeaf)


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def leaf_nbytes(leaf) -> int:
    """Resident bytes of a plain tensor or a :class:`QuantizedLeaf`."""
    return leaf.nbytes if is_quantized(leaf) else tensor_bytes(leaf)


def _expand(scale: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-channel scale back over the reduced axis -2."""
    return scale.unsqueeze(-2)


def quantize_leaf(w: torch.Tensor, with_delta: bool = False
                  ) -> QuantizedLeaf:
    """Deterministic symmetric per-channel int8 quantization of one
    rank >= 2 leaf: round to nearest (even), clipped to [-127, 127], with
    the per-channel absmax / 127 rounded up to a power of two, so that
    ``q * scale`` is exact in f32 and a fused dequant + perturbation
    equals the materialized one under any contraction. Zero and
    subnormal channels get scale 1.0 and round-trip to zeros."""
    wf = w.to(_F32)
    a = wf.abs().amax(dim=-2) * _INV_127
    pow2 = torch.exp2(torch.ceil(torch.log(a) * _INV_LN2))
    scale = torch.where((a >= _TINY) & torch.isfinite(pow2), pow2,
                        torch.ones_like(pow2))
    q = torch.clamp(torch.round(wf / _expand(scale)), -127, 127).to(
        torch.int8)
    delta = torch.zeros_like(wf) if with_delta else None
    return QuantizedLeaf(q=q, scale=scale, delta=delta, orig_dtype=w.dtype)


def default_quantizable(path: str, leaf) -> bool:
    """Which leaves the one-shot base quantization touches: floating
    leaves of rank >= 2 at top level (embeddings, heads) and of rank >= 3
    under a stacked scope (``*blocks``), where a rank-2 leaf is a
    per-layer vector (norm scale, bias). MoE router weights stay
    full-precision (top-k routing is discrete)."""
    if is_quantized(leaf):
        return False
    min_rank = 3 if path.split("/", 1)[0].endswith("blocks") else 2
    if leaf.dim() < min_rank or not leaf.is_floating_point():
        return False
    return not path.endswith("router")


Params = Dict[str, object]


def quantize_tree(params: Params, mode: str = "int8",
                  with_delta: bool = False, quantizable=None) -> Params:
    """One-shot base quantization of a flat parameter dict.

    Mode ``"none"`` returns ``params`` itself; unknown modes raise.
    ``with_delta=True`` attaches a zero f32 delta to every quantized leaf
    (any tree that will be trained needs one: a delta-less leaf is a
    frozen base)."""
    check_quant_mode(mode)
    if mode == "none":
        return params
    pred = quantizable or default_quantizable
    return {path: quantize_leaf(leaf, with_delta) if pred(path, leaf)
            else leaf for path, leaf in params.items()}


# ---------------------------------------------------------------------------
# use-site helpers (plain tensors pass through untouched)


def deq(w):
    """Effective weight: dequantized if quantized, as it is otherwise."""
    return w.dequantize() if is_quantized(w) else w


def take_rows_f32(table, ids: torch.Tensor) -> torch.Tensor:
    """Row gather in f32 that never materializes a dequantized table
    (O(rows * cols) work); the plain forward (:func:`take_rows`) and the
    perturbed one (``PerturbCtx.take``) both build on it."""
    if not is_quantized(table):
        return table[ids].to(_F32)
    rows = table.q[ids].to(_F32) * table.scale
    if table.delta is not None:
        rows = rows + table.delta[ids]
    return rows


def take_rows(table, ids: torch.Tensor) -> torch.Tensor:
    """Row gather in the table's logical dtype (a row-sharded DTensor
    table: ``perturb_ctx.take_sharded``'s local gather)."""
    if not is_quantized(table):
        from torch.distributed.tensor import DTensor
        if isinstance(table, DTensor):
            from repro_torch.core.perturb_ctx import take_sharded
            return take_sharded(table, ids)
        return table[ids]
    return take_rows_f32(table, ids).to(table.dtype)


def dequantize_tree(params: Params) -> Params:
    """Full-precision view of a parameter dict, flat or nested."""
    return {path: dequantize_tree(leaf) if isinstance(leaf, dict)
            else deq(leaf) for path, leaf in params.items()}


def with_delta(params: Params) -> Params:
    """Attach zero f32 deltas to delta-less quantized leaves (the int8
    values and scales are shared, not copied)."""
    return {path: dataclasses.replace(
                leaf, delta=torch.zeros(leaf.shape, dtype=_F32,
                                        device=leaf.device))
            if is_quantized(leaf) and leaf.delta is None else leaf
            for path, leaf in params.items()}


def tree_is_quantized(params: Params) -> bool:
    return any(is_quantized(leaf) for leaf in params.values())


def quantized_bytes(params: Params):
    """(resident bytes, f32-equivalent bytes) of a parameter dict:
    resident counts int8 values + f32 scales (+ deltas when attached);
    the f32 equivalent counts every floating leaf at 4 bytes an
    element."""
    resident = f32_eq = 0
    for leaf in params.values():
        resident += leaf_nbytes(leaf)
        if is_quantized(leaf) or leaf.is_floating_point():
            f32_eq += 4 * int(np.prod(tuple(leaf.shape)))
        else:
            f32_eq += tensor_bytes(leaf)
    return resident, f32_eq

"""int8 gradient compression for the derivative-based (Adam) baseline.

Port of the JAX package's ``optim/compression.py``. A distributed-
optimization trick for the *gradient* arm only: MeZO's cross-pod traffic
is already K scalars a step, so compression there is moot -- which is
the paper's systems advantage at scale.

Per-leaf symmetric int8 quantization with an f32 absmax scale and
stochastic rounding (unbiased), through the helpers of
:mod:`repro_torch.optim.quant`, re-exported here.
"""

from __future__ import annotations

from repro_torch.optim.quant import int8_dequantize, int8_quantize

__all__ = ["int8_compress_tree", "int8_dequantize", "int8_quantize"]


def int8_compress_tree(grads):
    """Quantize->dequantize each floating leaf of a flat dict of
    gradients (simulates on-the-wire int8); 0-dim and non-floating
    leaves pass through."""
    def roundtrip(g):
        if not g.is_floating_point() or g.ndim == 0:
            return g
        q, s = int8_quantize(g)
        return int8_dequantize(q, s, g.dtype)
    return {k: roundtrip(g) for k, g in grads.items()}

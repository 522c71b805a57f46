"""Slot-axis batching helper shared by the serving engine.

Port of :func:`masked_merge` from the JAX package's ``core/batching.py``
for unquantized leaves (the int8 base comes with a later slice).
"""

from __future__ import annotations

import torch


def masked_merge(old, new, mask, axis: int = 0):
    """Per-slot select: ``new`` where ``mask``, ``old`` elsewhere.

    ``old``/``new`` are tensors or (nested) dicts of tensors; ``mask`` is
    an (n_slots,) bool tensor and ``axis`` the slot axis of every leaf.
    """
    if isinstance(old, dict):
        return {k: masked_merge(old[k], new[k], mask, axis) for k in old}
    m = mask.reshape((1,) * axis + (-1,) + (1,) * (old.dim() - axis - 1))
    return torch.where(m, new, old)

"""Tensor-level DTensor helpers shared by the kernels, the perturbation
context and the sharding plan (``models/sharding.py``): whether a tensor
is a DTensor, the global offsets of this rank's shard, a contiguous
global stride, and the reduction of ``Partial()`` placements. They read
a tensor and its placements only, never a spec or a rule table, so the
kernel layer can take a sharded leaf without depending on the model
layer."""

from __future__ import annotations

from typing import Tuple

import torch


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_offsets(x) -> Tuple[int, ...]:
    """Global per-dimension offsets of this rank's block of a DTensor
    (zeros for a plain tensor), from the mesh coordinate alone (no tensor
    op: it runs under ``FakeTensorMode`` too). A dim sharded over several
    mesh dims is split in mesh-dim order, each split in ``torch.chunk``'s
    blocks, as DTensor's ``Shard`` splits it."""
    if not is_dtensor(x):
        return (0,) * x.dim()
    from torch.distributed.tensor import Shard
    coord = x.device_mesh.get_coordinate()
    sizes = tuple(x.device_mesh.mesh.shape)
    offs = [0] * x.dim()
    lens = list(x.shape)
    for i, pl in enumerate(x.placements):
        if not isinstance(pl, Shard):
            continue
        d = pl.dim % x.dim()
        chunk = -(-lens[d] // sizes[i])
        start = min(coord[i] * chunk, lens[d])
        offs[d] += start
        lens[d] = max(0, min(chunk, lens[d] - start))
    return tuple(offs)


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The row-major strides of ``shape`` (a DTensor's global stride as
    ``from_local`` takes it for a contiguous result)."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(n)
    return tuple(reversed(stride))


def settle(x):
    """Reduce the ``Partial()`` placements of a DTensor (a row-parallel
    block output) to ``Replicate()``: the one all-reduce Megatron pays
    where a block's output joins the residual stream. Plain tensors and
    DTensors without a Partial pass through."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate
    if not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in x.placements])

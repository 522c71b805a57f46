"""On-disk parameter store, in the JAX package's format.

Port of the JAX package's ``checkpoint/store.py``:
``<dir>/step_<N>/arrays.npz`` + ``manifest.json``, one npz entry per leaf
keyed by its ``::``-joined path, written atomically (tmp dir + rename).
Parameters here are a flat ``dict[str, Tensor]`` keyed by the ``/``
paths, so a checkpoint that either package wrote loads into the other.

bfloat16 leaves: numpy has no bfloat16 of its own. The JAX package's npz
carries them as 2-byte (ml_dtypes) records, which load here bit for bit;
this module writes them as float32, which is exact and which the JAX
loader rounds back to the same bfloat16 values.

An int8 :class:`~repro_torch.optim.quant.QuantizedLeaf` at path ``p`` is
stored as ``p::q``, ``p::scale`` and (when it has one) ``p::delta`` --
the keys the JAX package writes for its registered pytree -- and its
logical dtype comes from ``like`` on load, as in JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.optim.quant import QuantizedLeaf, is_quantized

_SEP = "::"
_QPARTS = ("q", "scale", "delta")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and (a.dtype.kind == "V"
                                  or a.dtype.name == "bfloat16"):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_to_numpy(params: Dict[str, object]) -> Dict[str, np.ndarray]:
    """Flat torch params -> flat numpy arrays, same ``/`` keys; a
    quantized leaf at ``p`` becomes ``p/q``, ``p/scale`` (and
    ``p/delta``)."""
    out = {}
    for k, v in params.items():
        if is_quantized(v):
            for part in _QPARTS:
                t = getattr(v, part)
                if t is not None:
                    out[f"{k}/{part}"] = _to_numpy(t)
        else:
            out[k] = _to_numpy(v)
    return out


def params_from_numpy(flat: Dict[str, np.ndarray], device,
                      orig_dtypes: Optional[Dict[str, torch.dtype]] = None
                      ) -> Dict[str, object]:
    """Flat numpy arrays (e.g. JAX parameters, ``/``-keyed) -> flat torch
    params on ``device``.

    A JAX int8 tree flattens to ``p/q``, ``p/scale`` (and ``p/delta``)
    for a quantized leaf at ``p``; those arrays become one
    :class:`QuantizedLeaf` at ``p``, whose logical dtype is
    ``orig_dtypes[p]`` (float32 when not given, the JAX leaf's default).
    """
    orig_dtypes = orig_dtypes or {}
    quant = {k[:-len("/q")] for k in flat
             if k.endswith("/q") and k[:-len("/q")] + "/scale" in flat}
    out = {}
    for k, a in flat.items():
        head, _, part = k.rpartition("/")
        if head in quant and part in _QPARTS:
            continue
        out[k] = _to_tensor(a).to(device)
    for p in sorted(quant):
        delta = flat.get(f"{p}/delta")
        out[p] = QuantizedLeaf(
            q=_to_tensor(flat[f"{p}/q"]).to(device),
            scale=_to_tensor(flat[f"{p}/scale"]).to(device),
            delta=None if delta is None else _to_tensor(delta).to(device),
            orig_dtype=orig_dtypes.get(p, torch.float32))
    return out


def save_params(ckpt_dir: str, step: int, params: Dict[str, torch.Tensor],
                extra: Optional[dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_save_")
    arrays = {k.replace("/", _SEP): v
              for k, v in params_to_numpy(params).items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def load_params(ckpt_dir: str, step: int, like: Dict[str, object]
                ) -> Dict[str, object]:
    """Restore into the keys, shapes, dtypes and devices of ``like``; a
    quantized leaf of ``like`` reads its q, scale (and delta) entries."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")

    def read(data, path, leaf):
        key = path.replace("/", _SEP)
        if key not in data.files:
            raise KeyError(f"checkpoint {d} has no leaf {key!r}")
        t = _to_tensor(data[key])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)}"
                             f" != {tuple(leaf.shape)}")
        return t.to(dtype=leaf.dtype, device=leaf.device)

    out = {}
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for path, leaf in like.items():
            if is_quantized(leaf):
                parts = {part: read(data, f"{path}/{part}",
                                    getattr(leaf, part))
                         for part in _QPARTS
                         if getattr(leaf, part) is not None}
                out[path] = QuantizedLeaf(orig_dtype=leaf.orig_dtype,
                                          **parts)
            else:
                out[path] = read(data, path, leaf)
    return out


def load_manifest(ckpt_dir: str, step: int) -> dict:
    """The ``manifest.json`` of snapshot ``step`` (keys, dtypes, shapes,
    extra), as either package wrote it."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)

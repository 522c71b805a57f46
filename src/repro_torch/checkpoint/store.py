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
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

_SEP = "::"


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


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Flat torch params -> flat numpy arrays, same ``/`` keys."""
    return {k: _to_numpy(v) for k, v in params.items()}


def params_from_numpy(flat: Dict[str, np.ndarray], device
                      ) -> Dict[str, torch.Tensor]:
    """Flat numpy arrays (e.g. JAX parameters, ``/``-keyed) -> flat torch
    params on ``device``."""
    return {k: _to_tensor(a).to(device) for k, a in flat.items()}


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


def load_params(ckpt_dir: str, step: int, like: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """Restore into the keys, shapes, dtypes and devices of ``like``."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    out = {}
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for path, leaf in like.items():
            key = path.replace("/", _SEP)
            if key not in data.files:
                raise KeyError(f"checkpoint {d} has no leaf {key!r}")
            t = _to_tensor(data[key])
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)}"
                                 f" != {tuple(leaf.shape)}")
            out[path] = t.to(dtype=leaf.dtype, device=leaf.device)
    return out


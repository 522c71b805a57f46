"""Fake-tensor inputs for every (arch x shape) dry-run cell.

Port of the JAX package's ``launch/specs.py``. ``SHAPES`` and
``cell_supported`` are the reference's word for word. Where the reference
builds ``ShapeDtypeStruct`` stand-ins with ``NamedSharding``s attached,
:func:`cell_inputs` builds the params (by the port's own init, at full
width), the batch, the cache, the tokens and the seed as fake tensors --
it must be called under a ``FakeTensorMode``, so nothing is allocated --
distributed by the sharding plan (``models/sharding.py``) as DTensors on
the given mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import build_model
from repro_torch.models import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of

# The assigned input-shape set (LM family: seq_len x global_batch).
SHAPES: Dict[str, dict] = {
    "train_4k":    dict(mode="train",   seq=4096,   batch=256),
    "prefill_32k": dict(mode="prefill", seq=32768,  batch=32),
    "decode_32k":  dict(mode="decode",  seq=32768,  batch=128),
    "long_500k":   dict(mode="decode",  seq=524288, batch=1),
}


def cell_supported(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    """None if supported, else a skip reason (recorded in EXPERIMENTS.md)."""
    if shape_name == "long_500k" and not cfg.is_sub_quadratic:
        return ("pure full-attention arch: 524k decode requires "
                "sub-quadratic attention (skip per assignment)")
    if SHAPES[shape_name]["mode"] == "decode" and cfg.family == "encoder":
        return "encoder-only arch has no decode step"
    return None


def _data_axes(mesh, cfg=None):
    axes = ["pod", "data"]
    if cfg is not None and not cfg.use_tp:
        axes.append("model")     # no TP: the model axis joins DP
    return [a for a in axes if a in shd.axis_names(mesh)]


def _distribute_flat(tree: Dict[str, torch.Tensor], specs, mesh):
    return {k: shd.distribute(v, mesh, shd.fit_spec(tuple(v.shape),
                                                    specs[k], mesh))
            for k, v in tree.items()}


def _distribute_nested(tree, specs, mesh):
    return {k: _distribute_nested(v, specs[k], mesh) if isinstance(v, dict)
            else shd.distribute(v, mesh, specs[k])
            for k, v in tree.items()}


def batch_struct(cfg: ModelConfig, seq: int, batch: int,
                 device="cpu") -> Dict[str, Any]:
    """A train/prefill batch for this architecture (zeros)."""
    b: Dict[str, Any] = {
        "tokens": torch.zeros((batch, seq), dtype=torch.int64,
                              device=device),
        "targets": torch.zeros((batch, seq), dtype=torch.int64,
                               device=device),
        "loss_mask": torch.ones((batch, seq), dtype=torch.float32,
                                device=device),
    }
    dt = dtype_of(cfg)
    if cfg.family == "encdec":
        b["enc_embeds"] = torch.zeros((batch, cfg.enc_len, cfg.d_model),
                                      dtype=dt, device=device)
    if cfg.num_patches:
        b["patch_embeds"] = torch.zeros((batch, cfg.num_patches,
                                         cfg.d_model), dtype=dt,
                                        device=device)
    return b


def cell_inputs(cfg: ModelConfig, shape_name: str, mesh, seed: int = 0):
    """dict(mode, model, params, ...) of the cell: ``batch`` and ``seed``
    (train / prefill) or ``cache``, ``tokens`` and ``pos`` (decode), every
    tensor a DTensor on ``mesh`` placed by the plan. Call it under a
    ``FakeTensorMode``."""
    reason = cell_supported(cfg, shape_name)
    if reason:
        raise ValueError(f"unsupported cell: {reason}")
    sh = SHAPES[shape_name]
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")
    params = _distribute_flat(params, shd.param_specs(
        params, mesh, fsdp=cfg.fsdp_params, use_tp=cfg.use_tp), mesh)
    daxes = _data_axes(mesh, cfg)

    if sh["mode"] in ("train", "prefill"):
        batch = batch_struct(cfg, sh["seq"], sh["batch"])
        batch = _distribute_flat(
            batch, shd.batch_spec(batch, mesh, data_axes=daxes), mesh)
        return dict(mode=sh["mode"], model=model, params=params,
                    batch=batch, seed=seed)

    # decode
    cache = model.init_cache(sh["batch"], sh["seq"], device="cpu")
    cache = _distribute_nested(cache, shd.cache_spec(cache, mesh), mesh)
    tok_spec = shd._fit(mesh, sh["batch"], *daxes)
    tokens = shd.distribute(torch.zeros((sh["batch"], 1), dtype=torch.int64),
                            mesh, shd.P(tok_spec, None))
    return dict(mode="decode", model=model, params=params, cache=cache,
                tokens=tokens, pos=sh["seq"] - 1)

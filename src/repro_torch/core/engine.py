"""The ZO update rule the serving slice replays: ``sgd``.

Port of the subset of the JAX package's ``core/engine.py`` that adapter
replay runs: :class:`MezoConfig`, the shared f32 update tail
(:func:`_direction_coeffs`, :func:`_apply_direction_updates`,
:func:`_decay` for unquantized leaves), :func:`_sgd_update` and the
:data:`SGD` rule. The direction estimators (walk / vmapdir / fused) and
the other update rules come with later slices.

Every coefficient is computed on float32 tensors, never on Python floats:
float64 arithmetic would fork the last ulp from the JAX package and
replay would stop being bit-exact.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core import rng as zrng
from repro_torch.core.perturb import add_scaled_z

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MezoConfig:
    """The JAX package's MezoConfig, field for field. ``use_kernel`` has
    no effect in the port: each leaf's device decides between the
    ``zo_add`` kernel (CUDA) and its plain version (CPU)."""
    eps: float = 1e-3
    lr: float = 1e-6
    n_directions: int = 1          # K: SPSA directions averaged per step
    dist: str = "rademacher"       # or "gaussian" (MeZO-repo default)
    use_kernel: bool = False       # no effect here (see the docstring)
    momentum: float = 0.0          # ZO momentum (training slice)
    momentum_window: int = 8
    weight_decay: float = 0.0
    staleness_decay: float = 0.8   # async fleet (fleet slice)


@dataclasses.dataclass(frozen=True)
class UpdateRule:
    """Turns a logged ``(seed, gs)`` pair into a parameter update."""
    name: str
    init_fn: Callable[[MezoConfig], Any]
    update_fn: Callable[..., Tuple[Any, Any]]


def _f32(value, default: float) -> torch.Tensor:
    """f32 scalar from a value or, for ``None``, the config constant."""
    return torch.as_tensor(default if value is None else value, dtype=_F32)


def _direction_coeffs(kk: int, lr, direction_mask) -> torch.Tensor:
    """Per-direction coefficients: ``-lr * f32(1/K)`` (multiply by the f32
    reciprocal, as the JAX engine does), or with a straggler mask
    ``-lr * m_k / max(sum(m), 1)``."""
    lr = torch.as_tensor(lr, dtype=_F32)
    if direction_mask is None:
        return (-lr * torch.tensor(1.0 / kk, dtype=_F32)).expand(kk)
    m = torch.as_tensor(direction_mask, dtype=_F32).reshape(kk)
    return -lr * m / torch.clamp(m.sum(), min=1.0)


def _apply_direction_updates(params, seed, gs, coeffs, cfg: MezoConfig):
    """theta += sum_k coeffs[k] * gs[k] * z_k, z_k regenerated per k."""
    for k in range(gs.shape[0]):
        params = add_scaled_z(params, zrng.fold_seed(seed, k),
                              coeffs[k] * gs[k], dist=cfg.dist)
    return params


def _decay(params, wd_coeff):
    """Weight decay ``p * (1 - wd)`` in f32, rounded to each leaf's dtype."""
    if wd_coeff is None:
        return params
    keep = (1.0 - torch.as_tensor(wd_coeff, dtype=_F32))
    out = {}
    for path, p in params.items():
        out[path] = ((p.to(_F32) * keep.to(p.device)).to(p.dtype)
                     if p.is_floating_point() else p)
    return out


def _sgd_init(cfg: MezoConfig):
    return {}


def _sgd_update(params, opt, seed, gs, direction_mask, cfg: MezoConfig,
                lr=None):
    seed = zrng._u32(seed)
    gs = torch.as_tensor(gs, dtype=_F32).reshape(-1)
    lr = _f32(lr, cfg.lr)
    coeffs = _direction_coeffs(gs.shape[0], lr, direction_mask)
    if cfg.weight_decay:
        params = _decay(params, lr * torch.tensor(cfg.weight_decay,
                                                  dtype=_F32))
    return _apply_direction_updates(params, seed, gs, coeffs, cfg), opt


SGD = UpdateRule(name="sgd", init_fn=_sgd_init, update_fn=_sgd_update)

_LATER = {"momentum": "the training slice (fused MeZO)",
          "stale-sgd": "the fleet slice"}


def update_rule(name: str) -> UpdateRule:
    """Resolve an update rule by name; only ``sgd`` is ported so far."""
    if name == "sgd":
        return SGD
    if name in _LATER:
        raise NotImplementedError(
            f"update rule {name!r} is not ported yet; it lands with "
            f"{_LATER[name]}")
    raise ValueError(f"unknown update rule {name!r}; known: "
                     f"{['sgd', *_LATER]}")


def check_rule(rule: Optional[UpdateRule]) -> UpdateRule:
    """``None`` -> SGD; any other rule than SGD raises (not ported)."""
    if rule is None or rule is SGD:
        return SGD
    return update_rule(getattr(rule, "name", str(rule)))

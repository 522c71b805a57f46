"""Adam / SGD baselines -- the derivative-based arm PocketLLM compares
against (Table 1/2: Adam runs out of memory at batch 64 on the phone;
MeZO does not).

Port of the JAX package's ``optim/adam.py``. The gradient comes from
``torch.autograd`` over the plain forward (no kernel has a backward: the
JAX package's Pallas kernels have no differentiation rule either). State
is kept in f32 -- two moments, updates computed in f32 and cast back to
each leaf's dtype -- the memory model the paper's argument rests on:
Adam memory = params + grads + 2 f32 moments (+ activations linear in
batch). A step updates parameters and moments in place under
``no_grad``, what the reference's donated buffers amount to.

:class:`AdamState` snapshots in the reference's layout: ``mu``, ``nu``
and ``count`` are the pytree children 0, 1 and 2, so a checkpoint
manager key reads ``opt/0/<leaf path>``, ``opt/1/<leaf path>`` and
``opt/2`` (:meth:`AdamState.flat`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

Params = Dict[str, Any]
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0          # 0 = off
    compress_grads: bool = False    # int8 all-reduce (optim/compression.py)


@dataclasses.dataclass
class AdamState:
    mu: Params                       # f32 first moments, keyed like params
    nu: Params                       # f32 second moments
    count: torch.Tensor              # int32 0-dim step count, on the host

    def flat(self) -> Dict[str, torch.Tensor]:
        """The reference's snapshot keys: ``0/<path>`` (mu), ``1/<path>``
        (nu), ``2`` (count)."""
        out = {f"0/{k}": v for k, v in self.mu.items()}
        out.update({f"1/{k}": v for k, v in self.nu.items()})
        out["2"] = self.count
        return out

    @classmethod
    def from_flat(cls, flat: Dict[str, torch.Tensor], like: "AdamState"
                  ) -> "AdamState":
        return cls(mu={k: flat[f"0/{k}"] for k in like.mu},
                   nu={k: flat[f"1/{k}"] for k in like.nu},
                   count=flat["2"])


def adam_init(params: Params) -> AdamState:
    """Zero f32 moments beside each floating leaf (a non-floating leaf's
    moment is the leaf itself, as in the reference's tree map)."""
    zeros = {k: (torch.zeros(p.shape, dtype=_F32, device=p.device)
                 if p.is_floating_point() else p)
             for k, p in params.items()}
    return AdamState(mu=zeros,
                     nu={k: v.clone() if v.is_floating_point() else v
                         for k, v in zeros.items()},
                     count=torch.zeros((), dtype=torch.int32))


def _bias_correction(b: float, count: torch.Tensor) -> torch.Tensor:
    """f32 ``1 - b ** count`` on the host."""
    return 1.0 - torch.pow(torch.tensor(b, dtype=_F32), count.to(_F32))


@torch.no_grad()
def adam_update(params: Params, grads: Params, state: AdamState,
                cfg: AdamConfig):
    """One Adam step over the floating leaves, in place: ``params``,
    ``state.mu`` and ``state.nu`` are written and returned. Returns
    ``(params, state)``."""
    count = state.count + 1
    b1c = _bias_correction(cfg.b1, count)
    b2c = _bias_correction(cfg.b2, count)

    if cfg.grad_clip:
        gnorm = torch.sqrt(sum(torch.sum(g.to(_F32) * g.to(_F32)).cpu()
                               for g in grads.values()))
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        grads = {k: g.to(_F32) * scale.to(g.device)
                 for k, g in grads.items()}

    for k, p in params.items():
        if not p.is_floating_point():
            continue
        g = grads[k].to(_F32)
        m, v = state.mu[k], state.nu[k]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        step = cfg.lr * (m / b1c.to(p.device)) / (
            torch.sqrt(v / b2c.to(p.device)) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.lr * cfg.weight_decay * p.to(_F32)
        p.copy_((p.to(_F32) - step).to(p.dtype))
    return params, AdamState(mu=state.mu, nu=state.nu, count=count)


def value_and_grad(loss_fn: Callable, params: Params, batch: Any):
    """``(loss, grads)`` of ``loss_fn(params, batch)`` through autograd,
    one gradient per floating leaf, zeros for a leaf the loss does not
    read (the parameters are left as they were: no leaf keeps
    ``requires_grad``)."""
    keys = [k for k, p in params.items() if p.is_floating_point()]
    for k in keys:
        params[k].requires_grad_(True)
    try:
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                    allow_unused=True)
    finally:
        for k in keys:
            params[k].requires_grad_(False)
    # a leaf the loss does not read has a zero gradient, as in jax.grad
    return loss.detach(), {k: torch.zeros_like(params[k]) if g is None
                           else g for k, g in zip(keys, grads)}


def grad_train_step(loss_fn: Callable, params: Params, batch: Any,
                    state: AdamState, cfg: AdamConfig):
    """One gradient step: autograd, optional int8 gradient compression,
    Adam in place. Returns ``(params, state, loss)``."""
    loss, grads = value_and_grad(loss_fn, params, batch)
    if cfg.compress_grads:
        from repro_torch.optim.compression import int8_compress_tree
        grads = int8_compress_tree(grads)
    params, state = adam_update(params, grads, state, cfg)
    return params, state, loss


def sgd_train_step(loss_fn: Callable, params: Params, batch: Any,
                   lr: float = 1e-4):
    """Plain gradient descent in f32, in place. Returns ``(params,
    loss)``."""
    loss, grads = value_and_grad(loss_fn, params, batch)
    with torch.no_grad():
        for k, g in grads.items():
            p = params[k]
            p.copy_((p.to(_F32) - lr * g.to(_F32)).to(p.dtype))
    return params, loss

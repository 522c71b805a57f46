"""MeZO: memory-efficient zeroth-order fine-tuning (PocketLLM's method).

Port of the JAX package's ``core/mezo.py``: the historical step-function
entry points as thin wrappers over registered strategies of
:mod:`repro_torch.core.engine`, plus replay and analysis helpers:

* ``mezo_step``          -> strategy ``walk + sgd``    ("mezo")
* ``mezo_step_vmapdir``  -> strategy ``vmapdir + sgd`` ("mezo-parallel")
* ``mezo_step_fused``    -> strategy ``fused + sgd``   ("mezo-fused")
* ``mezo_momentum_step`` -> strategy ``vmapdir + momentum``

Each returns the new params plus a :class:`MezoAux` whose ``(seed, gs)``
pair is what the replay-log checkpointer persists. ``mezo_step`` and
``mezo_step_fused`` update the params they are given in place (their
estimators donate, as in the JAX package).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import rng as zrng
from repro_torch.core.engine import (  # noqa: F401  (re-exported API)
    SGD, LossFn, MezoAux, MezoConfig, Params, TrainState, build_strategy,
    get_strategy, momentum_history_init)
from repro_torch.core.perturb import add_scaled_z


def _run(name: str, loss_fn: LossFn, params: Params, batch: Any, seed,
         cfg: MezoConfig, direction_mask=None):
    strat = get_strategy(name)
    state, aux = strat.step(loss_fn, strat.init_state(params, cfg), batch,
                            seed, cfg, direction_mask)
    return state.params, aux


def mezo_step(loss_fn: LossFn, params: Params, batch: Any, seed,
              cfg: MezoConfig, direction_mask=None):
    """Paper-faithful sequential MeZO step (in-place walk).

    direction_mask: optional (K,) 0/1 floats -- the update renormalizes
    over the surviving directions."""
    return _run("mezo", loss_fn, params, batch, seed, cfg, direction_mask)


def mezo_step_vmapdir(loss_fn: LossFn, params: Params, batch: Any, seed,
                      cfg: MezoConfig, direction_mask=None):
    """Direction-parallel MeZO step (strategy ``vmapdir + sgd``)."""
    return _run("mezo-parallel", loss_fn, params, batch, seed, cfg,
                direction_mask)


def mezo_step_fused(loss_fn: LossFn, params: Params, batch: Any, seed,
                    cfg: MezoConfig, direction_mask=None):
    """Fused perturbed-forward MeZO step: 0 param sweeps per direction.
    ``loss_fn`` must accept a ``perturb=`` keyword (``Model.loss`` does).
    """
    return _run("mezo-fused", loss_fn, params, batch, seed, cfg,
                direction_mask)


def mezo_momentum_step(loss_fn: LossFn, params: Params, batch: Any, seed,
                       cfg: MezoConfig, hist):
    """ZO-momentum step (strategy ``vmapdir + momentum``). ``hist`` is the
    window from :func:`momentum_history_init` or the previous call's;
    a window without the per-entry ``coeffs`` row gets the ``-lr/K``
    coefficient the old step function applied to every row. Returns
    (params, aux, new_hist)."""
    if "coeffs" not in hist:
        gs = torch.as_tensor(hist["gs"], dtype=torch.float32)
        hist = dict(hist, coeffs=torch.full_like(
            gs, float(-torch.tensor(cfg.lr, dtype=torch.float32)
                      / gs.shape[1])))
    strat = build_strategy("vmapdir", "momentum")
    state = TrainState(params=params, step=0, opt=hist)
    state, aux = strat.step(loss_fn, state, batch, seed, cfg)
    return state.params, aux, state.opt


def replay_update(params, seed, gs, cfg: MezoConfig, direction_mask=None):
    """Recovery path of the replay-log checkpointer and of adapter
    materialization: the engine's sgd update rule, identical f32
    arithmetic to the live step, hence bit-exact replay."""
    params, _ = SGD.update_fn(params, {}, seed, gs, direction_mask, cfg)
    return params


def spsa_gradient_estimate(loss_fn: LossFn, params: Params, batch: Any,
                           seed, cfg: MezoConfig) -> Params:
    """Materialized SPSA gradient estimate: mean_k g_k * z_k. Only for
    tests and analysis -- the training paths never materialize z."""
    seed = zrng._u32(seed)
    eps = torch.tensor(cfg.eps, dtype=torch.float32)
    grads = []
    for k in range(cfg.n_directions):
        s = zrng.fold_seed(seed, k)
        lp = loss_fn(add_scaled_z(params, s, eps, dist=cfg.dist), batch)
        lm = loss_fn(add_scaled_z(params, s, -eps, dist=cfg.dist), batch)
        g = ((lp - lm) / (2.0 * eps).to(lp.device)).to("cpu")
        zero = {p: torch.zeros_like(v) for p, v in params.items()}
        grads.append(add_scaled_z(zero, s, g, dist=cfg.dist))
    return {p: sum(g[p] for g in grads) / len(grads) for p in params}

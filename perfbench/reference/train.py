"""Plain MeZO-SGD steps, followed from the same weights, batches and
seed as the program's first steps.

Step ``t`` (0-based) of a run seeded ``s`` draws ``z`` from
``direction_seed(s, t, k)``, evaluates ``l+ = L(theta + eps z)`` and
``l- = L(theta - eps z)``, takes ``gs = (l+ - l-) / (2 eps)`` and the
step's loss ``(l+ + l-) / 2``, and updates every leaf as
``theta <- theta - (lr / K) * gs * z``, in f32 and rounded to the leaf's
stored dtype. ``eps``, ``lr`` and the coefficient are f32 numbers.

The estimator says where ``theta +- eps z`` lives: ``fused`` evaluates
it inside the forward, in f32, without touching the weights; ``walk``
(the MeZO paper's Algorithm 1) moves the stored weights in place, by
``+eps z``, ``-2 eps z`` and ``+eps z``, each sweep rounded to the
stored dtype, and evaluates the plain forward between the sweeps.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from perfbench.reference import model as M
from perfbench.reference import zhash

F32 = torch.float32


def _f32(x) -> float:
    return float(torch.tensor(x, dtype=F32))


def leaf_layers(path: str, t: torch.Tensor):
    """(layer, view) pairs of a leaf: each layer of a stacked block leaf,
    or the whole leaf once (layer None)."""
    if path.startswith("blocks/"):
        return [(li, t[li]) for li in range(t.shape[0])]
    return [(None, t)]


def sgd_update(params, seed: int, coeff: float) -> None:
    """``theta += coeff * z(seed)`` on every leaf, in place."""
    for path, p in params.items():
        for li, view in leaf_layers(path, p):
            z = zhash.leaf_z(seed, path, view.shape, view.device, li)
            view.copy_((view.to(F32) + coeff * z).to(view.dtype))


def change_norms(before, after) -> Dict[str, float]:
    """Per leaf, the f32 norm of ``after - before``."""
    out = {}
    for path, a in after.items():
        acc = 0.0
        for (_, va), (_, vb) in zip(leaf_layers(path, a),
                                    leaf_layers(path, before[path])):
            acc += float(((va.to(F32) - vb.to(F32)) ** 2).sum())
        out[path] = acc ** 0.5
    return out


def _losses(model, params, batch, s, eps, estimator, precision,
            half_batch):
    """(l+, l-) of direction seed ``s``."""
    if estimator == "fused":
        return (M.loss(model, params, batch, s, eps, precision, half_batch),
                M.loss(model, params, batch, s, -eps, precision,
                       half_batch))
    if estimator != "walk":
        raise ValueError(f"no reference for estimator {estimator!r}")
    sgd_update(params, s, eps)
    lp = M.loss(model, params, batch, None, 0.0, precision, half_batch)
    sgd_update(params, s, _f32(-2.0 * eps))
    lm = M.loss(model, params, batch, None, 0.0, precision, half_batch)
    sgd_update(params, s, eps)
    return lp, lm


def follow(model: dict, mezo: dict, params, batches: List[dict],
           run_seed: int, estimator: str = "fused",
           precision: str = "f32", half_batch: bool = False) -> dict:
    """Run ``len(batches)`` steps on ``params`` (updated in place).
    Returns the steps' losses and gs, and per leaf the change norm after
    the first step over lr (``grad``, the gradient as the update took
    it) and after the last (``change``)."""
    eps = _f32(mezo["eps"])
    lr = _f32(mezo["lr"])
    k_dirs = int(mezo.get("n_directions", 1))
    inv_k = _f32(1.0 / k_dirs)
    theta0 = {p: t.clone() for p, t in params.items()}
    losses, gss, grad = [], [], None
    for t, batch in enumerate(batches):
        gs_k, l_k = [], []
        for k in range(k_dirs):
            s = zhash.direction_seed(run_seed, t, k)
            lp, lm = _losses(model, params, batch, s, eps, estimator,
                             precision, half_batch)
            gs_k.append(_f32((lp - lm) / (2.0 * eps)))
            l_k.append((lp + lm) / 2.0)
        losses.append(sum(l_k) / k_dirs)
        gss.append(gs_k)
        for k in range(k_dirs):
            coeff = _f32(_f32(-lr * inv_k) * gs_k[k])
            sgd_update(params, zhash.direction_seed(run_seed, t, k), coeff)
        if t == 0:
            grad = {p: v / lr for p, v in
                    change_norms(theta0, params).items()}
    change = change_norms(theta0, params)
    del theta0
    return {"losses": losses, "gs": gss, "grad": grad, "change": change}


def replay(mezo: dict, params, gs: List[List[float]], run_seed: int,
           estimator: str = "fused") -> dict:
    """The update alone, driven by a side's own projected gradients:
    ``len(gs)`` steps on ``params`` (in place) with the coefficients
    ``-(lr / K) * gs[t][k]`` (and for ``walk`` the three perturbation
    sweeps before them), no forward. Returns the change norms after the
    first step over lr (``grad``) and after the last (``change``), the
    same readings ``follow`` gives, so that a side's update is judged
    apart from its gradient."""
    eps = _f32(mezo["eps"])
    lr = _f32(mezo["lr"])
    inv_k = _f32(1.0 / int(mezo.get("n_directions", 1)))
    theta0 = {p: t.clone() for p, t in params.items()}
    grad = None
    for t, gs_k in enumerate(gs):
        seeds = [zhash.direction_seed(run_seed, t, k)
                 for k in range(len(gs_k))]
        if estimator == "walk":
            for s in seeds:
                sgd_update(params, s, eps)
                sgd_update(params, s, _f32(-2.0 * eps))
                sgd_update(params, s, eps)
        for s, g in zip(seeds, gs_k):
            sgd_update(params, s, _f32(_f32(-lr * inv_k) * _f32(g)))
        if t == 0:
            grad = {p: v / lr for p, v in
                    change_norms(theta0, params).items()}
    change = change_norms(theta0, params)
    del theta0
    return {"grad": grad, "change": change}


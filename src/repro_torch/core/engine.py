"""Composable ZO engine: direction estimators x update rules.

Port of the JAX package's ``core/engine.py``. A training step is fully
described by the scalar pair ``(seed, gs)``, so the step function is a
product of two choices:

* a :class:`DirectionEvaluator` realizes ``L(theta +- eps*z_k)`` for K
  directions and returns the projected gradients ``gs``:

  - ``walk``    -- sequential walk (perturb / eval / counter-perturb /
    eval / restore), its three sweeps in place: peak memory is one copy
    of the parameters, the paper's profile;
  - ``vmapdir`` -- each direction on a transient perturbed copy (the
    JAX package vmaps the directions; here they run one after another);
  - ``fused``   -- the perturbation never touches the parameters: a
    :class:`~repro_torch.core.perturb_ctx.PerturbCtx` rides into the
    forward and dense projections compute ``X @ (W + coeff*z)`` through
    the ``zo_matmul`` kernel;

* an :class:`UpdateRule` turns ``(seed, gs)`` into a parameter update:
  ``sgd`` (the shared f32 seed-replay tail), ``stale-sgd`` (sgd scaled
  by ``staleness_decay ** staleness``, the async fleet's rule) or
  ``momentum`` (truncated seed replay of a window of ``(seed, gs,
  coeffs)`` rows).

Every coefficient is computed on float32 tensors on the host, never on
Python floats: float64 arithmetic would fork the last ulp from the JAX
package and replay would stop being bit-exact. ``_direction_coeffs``
multiplies by the f32 reciprocal of K, and ``gs = (l+ - l-) / (2 eps)``
is a true f32 division of two tensors on one device (a CUDA division by
a host scalar would multiply by its reciprocal instead).

:meth:`ZOStrategy.step_users` is the multi-tenant step: U users'
fine-tunes over a user-stacked state (``core.batching``) in one
dispatch. Each pristine estimator has a user-axis form -- ``fused`` runs
both signs of every user's direction as one 2U-lane perturbed forward
(``zo_matmul_users`` a projection), ``vmapdir`` perturbs every lane's
copy with ``zo_add_users`` -- and each update rule one whose sweeps are
``zo_add_users`` launches restricted to the active lanes, so an inactive
lane keeps its bits and an active one follows a lone :meth:`step` with
its (seed, eps, lr) bit for bit.

Seeds are host ints and eps a host f32, so no kernel launch waits for
the device; ``gs`` comes to the host once a step (the update's
coefficients and the replay log need it there), the loss stays on the
device until the trainer syncs it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import rng as zrng
from repro_torch.core.batching import take_user
from repro_torch.core.perturb import add_scaled_z, add_scaled_z_users
from repro_torch.core.perturb_ctx import PerturbCtx, host_to
from repro_torch.core.spans import span
from repro_torch.optim.quant import is_quantized

_F32 = torch.float32
_TINY = float(torch.finfo(torch.float32).tiny)    # smallest normal f32
Params = Dict[str, torch.Tensor]
# (params, batch) -> scalar; the fused estimator also passes ``perturb=``
LossFn = Callable[..., torch.Tensor]


# ---------------------------------------------------------------------------
# configs / aux / state


@dataclasses.dataclass(frozen=True)
class MezoConfig:
    """The JAX package's MezoConfig, field for field. ``use_kernel`` has
    no effect in the port: each tensor's device decides between the
    kernels (CUDA) and their plain versions (CPU)."""
    eps: float = 1e-3
    lr: float = 1e-6
    n_directions: int = 1          # K: SPSA directions averaged per step
    dist: str = "rademacher"       # or "gaussian" (MeZO-repo default)
    use_kernel: bool = False       # no effect here (see the docstring)
    momentum: float = 0.0          # ZO momentum via truncated seed replay
    momentum_window: int = 8       # directions of history to replay
    weight_decay: float = 0.0
    staleness_decay: float = 0.8   # stale-sgd: decay ** staleness


@dataclasses.dataclass
class MezoAux:
    """One step's scalars; :meth:`ZOStrategy.step_users` gives each a
    leading user axis (``loss`` (U,), ``gs`` (U, K), ``seed`` U ints)."""
    loss: torch.Tensor             # mean of (l+ + l-)/2, on the device
    gs: torch.Tensor               # (K,) f32 on the host -- the replay log
    seed: Any                      # uint32 step seed -- the replay log
    grad_norm_est: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainState:
    """Everything a training step consumes and produces: the flat
    parameter dict, the completed-step count, and the update rule's state
    (``{}`` for sgd, the momentum window of host tensors). A step whose
    estimator donates (walk, fused) updates ``params`` in place: the
    input state is consumed, as JAX's donated buffers are."""
    params: Params
    step: int
    opt: Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# the shared f32 update tail


def _f32(value, default: float) -> torch.Tensor:
    """f32 scalar on the host from a value or, for ``None``, the config
    constant."""
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


def _staleness_scale(decay, staleness) -> torch.Tensor:
    """f32 ``decay ** staleness`` as XLA computes it on the CPU: the f32
    power of two f32 tensors, equal bit for bit wherever the result is a
    normal number; XLA flushes a subnormal result to zero, and so does
    this."""
    s = torch.pow(torch.tensor(decay, dtype=_F32),
                  torch.tensor(float(staleness), dtype=_F32))
    return torch.where(s < _TINY, torch.zeros_like(s), s)


def _staleness_coeffs(kk: int, lr, direction_mask, staleness, decay
                      ) -> torch.Tensor:
    """Per-direction coefficients of an asynchronously delivered
    direction set: :func:`_direction_coeffs` scaled by ``decay **
    staleness``, where ``staleness`` counts the updates applied between
    the worker's parameter snapshot and this apply. One extra f32
    multiply: ``x * 1.0`` is exact, so staleness 0 is bit-identical to
    the synchronous coefficients, and the live coordinator and a replay
    compute it from the same logged integer."""
    return (_direction_coeffs(kk, lr, direction_mask)
            * _staleness_scale(decay, staleness))


def _apply_direction_updates(params, seed, gs, coeffs, cfg: MezoConfig,
                             inplace: bool = False):
    """theta += sum_k coeffs[k] * gs[k] * z_k, z_k regenerated per k.
    Without ``inplace`` only the first direction copies: the rest update
    that fresh copy in place (the same bits, one copy of peak memory)."""
    for k in range(gs.shape[0]):
        params = add_scaled_z(params, zrng.fold_seed(seed, k),
                              coeffs[k] * gs[k], dist=cfg.dist,
                              inplace=inplace)
        inplace = True
    return params


def _decay(params, wd_coeff, inplace: bool = False):
    """Weight decay ``p * (1 - wd)`` in f32, rounded to each leaf's dtype.

    A quantized leaf decays its effective weight by folding the decay
    into the f32 delta, ``delta * (1 - wd) - wd * q * s``: the int8
    values and the power-of-two scales stay frozen (a changed scale would
    break the exact ``q * s``), and a delta-less leaf (a frozen base)
    passes through."""
    if wd_coeff is None:
        return params
    wd = torch.as_tensor(wd_coeff, dtype=_F32)
    keep = 1.0 - wd
    out = params if inplace else {}
    for path, p in params.items():
        if is_quantized(p):
            if p.delta is not None:
                new = (p.delta * keep.to(p.device)
                       - wd.to(p.device) * p.base_f32())
                if inplace:
                    p.delta.copy_(new)
                else:
                    p = dataclasses.replace(p, delta=new)
            out[path] = p
            continue
        if not p.is_floating_point():
            out[path] = p
            continue
        new = (p.to(_F32) * keep.to(p.device)).to(p.dtype)
        out[path] = p.copy_(new) if inplace else new
    return out


# ---------------------------------------------------------------------------
# direction evaluators


@dataclasses.dataclass(frozen=True)
class DirectionEvaluator:
    """How ``theta +- eps*z`` is realized for the 2K loss evaluations.

    eval_fn: (loss_fn, params, batch, seed, cfg, eps=None)
    -> (params, gs, ls), gs and ls (K,) f32 on the loss's device.
    pristine: the base point is never written during evaluation, so the
    (seed, gs) replay log reconstructs the step bit-exactly.
    donate: the step consumes its input state (in-place updates).
    users_fn: the user-axis form over a user-stacked state, (loss_fn,
    params, batch, seeds, cfg, eps) -> (params, gs, ls), gs and ls
    (U, K); ``None`` for an estimator that is not pristine.
    """
    name: str
    eval_fn: Callable[..., Tuple[Params, torch.Tensor, torch.Tensor]]
    pristine: bool
    donate: bool
    users_fn: Optional[Callable[..., Tuple[Params, torch.Tensor,
                                           torch.Tensor]]] = None


def _projected(lp, lm, eps):
    """``((l+ - l-) / (2 eps), (l+ + l-) / 2)``: a true f32 division, the
    divisor a tensor on the losses' device (eps one number, or one a
    lane)."""
    den = host_to(2.0 * eps, _F32, lp.device)
    return (lp - lm) / den, 0.5 * (lp + lm)


def _eval_walk(loss_fn: LossFn, params: Params, batch: Any, seed,
               cfg: MezoConfig, eps=None):
    """Sequential in-place walk: peak memory = params + one forward."""
    eps = _f32(eps, cfg.eps)
    gs, ls = [], []
    for k in range(cfg.n_directions):
        s = zrng.fold_seed(seed, k)
        with span("zo.perturb"):
            add_scaled_z(params, s, eps, dist=cfg.dist, inplace=True)
        with span("zo.forward"):
            lp = loss_fn(params, batch)
        with span("zo.perturb"):
            add_scaled_z(params, s, -2.0 * eps, dist=cfg.dist, inplace=True)
        with span("zo.forward"):
            lm = loss_fn(params, batch)
        # restore to the base point for the next direction
        with span("zo.perturb"):
            add_scaled_z(params, s, eps, dist=cfg.dist, inplace=True)
        g, l = _projected(lp, lm, eps)
        gs.append(g)
        ls.append(l)
    return params, torch.stack(gs), torch.stack(ls)


def _eval_vmapdir(loss_fn: LossFn, params: Params, batch: Any, seed,
                  cfg: MezoConfig, eps=None):
    """Each direction on a transient perturbed copy of the parameters
    (the JAX package evaluates them concurrently under ``vmap``)."""
    eps = _f32(eps, cfg.eps)
    gs, ls = [], []
    for k in range(cfg.n_directions):
        s = zrng.fold_seed(seed, k)
        sides = []
        for c in (eps, -eps):
            with span("zo.perturb"):
                moved = add_scaled_z(params, s, c, dist=cfg.dist)
            with span("zo.forward"):
                sides.append(loss_fn(moved, batch))
            del moved
        g, l = _projected(*sides, eps)
        gs.append(g)
        ls.append(l)
    return params, torch.stack(gs), torch.stack(ls)


def _eval_fused(loss_fn: LossFn, params: Params, batch: Any, seed,
                cfg: MezoConfig, eps=None):
    """Fused perturbed forward: 0 parameter sweeps per direction.
    ``loss_fn`` must accept a ``perturb=`` keyword; both sides of each
    direction see exactly the z-fields ``add_scaled_z`` would apply."""
    eps = _f32(eps, cfg.eps)
    gs, ls = [], []
    for k in range(cfg.n_directions):
        ctx = PerturbCtx(seed=zrng.fold_seed(seed, k), coeff=eps,
                         dist=cfg.dist)
        with span("zo.forward"):
            lp = loss_fn(params, batch, perturb=ctx)
        with span("zo.forward"):
            lm = loss_fn(params, batch,
                         perturb=dataclasses.replace(ctx, coeff=-eps))
        g, l = _projected(lp, lm, eps)
        gs.append(g)
        ls.append(l)
    return params, torch.stack(gs), torch.stack(ls)


def _eval_fused_users(loss_fn: LossFn, params: Params, batch: Any, seeds,
                      cfg: MezoConfig, eps):
    """User-axis fused evaluation: per direction ONE perturbed forward of
    2U lanes, lanes 0..U-1 at ``+eps[u]`` and U..2U-1 at ``-eps[u]``
    (lane i reads user i % U's parameters and batch)."""
    u = len(seeds)
    both = {k: torch.cat([v, v]) for k, v in batch.items()}
    coeffs = torch.cat([eps, -eps])
    gs, ls = [], []
    for k in range(cfg.n_directions):
        sk = [zrng.fold_seed(s, k) for s in seeds]
        with span("zo.forward"):        # both signs in one forward
            l = loss_fn(params, both, perturb=PerturbCtx(
                seed=sk + sk, coeff=coeffs, dist=cfg.dist))
        g, m = _projected(l[:u], l[u:], eps)
        gs.append(g)
        ls.append(m)
    return params, torch.stack(gs, 1), torch.stack(ls, 1)


def _eval_vmapdir_users(loss_fn: LossFn, params: Params, batch: Any, seeds,
                        cfg: MezoConfig, eps):
    """User-axis vmapdir: every lane's perturbed copy in one
    ``zo_add_users`` sweep a sign, then each lane's loss on its own copy
    at the scalar path's shapes."""
    u = len(seeds)
    gs, ls = [], []
    for k in range(cfg.n_directions):
        sk = [zrng.fold_seed(s, k) for s in seeds]
        sides = []
        for c in (eps, -eps):
            with span("zo.perturb"):
                moved = add_scaled_z_users(params, sk, c, dist=cfg.dist)
            with span("zo.forward"):
                sides.append(torch.stack([
                    loss_fn(take_user(moved, i),
                            {key: v[i] for key, v in batch.items()})
                    for i in range(u)]))
            del moved
        g, m = _projected(sides[0], sides[1], eps)
        gs.append(g)
        ls.append(m)
    return params, torch.stack(gs, 1), torch.stack(ls, 1)


# ---------------------------------------------------------------------------
# update rules


@dataclasses.dataclass(frozen=True)
class UpdateRule:
    """Turns a logged ``(seed, gs)`` pair into a parameter update.

    init_fn:   cfg -> opt state.
    update_fn: (params, opt, seed, gs, direction_mask, cfg, lr=None,
               inplace=False) -> (params, opt). Consumes only scalars
               beyond params: the checkpoint manager's and the adapter
               store's replay primitive (zero forward passes).
    users_fn:  the same over a user-stacked state, (params, opt, seeds,
               gs (U, K), cfg, lr (U,), lanes, inplace=False) -> (params,
               opt), touching only the lanes listed.
    """
    name: str
    init_fn: Callable[[MezoConfig], Any]
    update_fn: Callable[..., Tuple[Any, Any]]
    users_fn: Optional[Callable[..., Tuple[Any, Any]]] = None


def _sgd_init(cfg: MezoConfig):
    return {}


def _sgd_apply(params, seed, gs, coeffs, lr, cfg: MezoConfig, inplace):
    """The sgd tail shared by sgd and stale-sgd: weight decay, then the
    K direction sweeps with ``coeffs``."""
    if cfg.weight_decay:
        params = _decay(params, lr * torch.tensor(cfg.weight_decay,
                                                  dtype=_F32), inplace)
        inplace = True               # the decayed dict is already a copy
    return _apply_direction_updates(params, seed, gs, coeffs, cfg, inplace)


def _sgd_update(params, opt, seed, gs, direction_mask, cfg: MezoConfig,
                lr=None, inplace: bool = False):
    seed = zrng._u32(seed)
    gs = torch.as_tensor(gs, dtype=_F32).reshape(-1)
    lr = _f32(lr, cfg.lr)
    coeffs = _direction_coeffs(gs.shape[0], lr, direction_mask)
    return _sgd_apply(params, seed, gs, coeffs, lr, cfg, inplace), opt


def _user_coeffs(kk: int, lr: torch.Tensor) -> torch.Tensor:
    """(U, K) per-lane :func:`_direction_coeffs` (no straggler mask)."""
    c = -lr * torch.tensor(1.0 / kk, dtype=_F32)
    return c[:, None].expand(-1, kk)


def _decay_users(params, wd: torch.Tensor, lanes, inplace: bool):
    """:func:`_decay` of each listed lane with its own ``wd[i]``, in
    place on that lane's views (a copy first unless ``inplace``)."""
    if not inplace:
        params = {p: (dataclasses.replace(v, delta=v.delta.clone())
                      if is_quantized(v) and v.delta is not None
                      else v if is_quantized(v) else v.clone())
                  for p, v in params.items()}
    for i, lane in enumerate(lanes):
        _decay(take_user(params, lane), wd[i], inplace=True)
    return params


def _sgd_update_users(params, opt, seeds, gs, cfg: MezoConfig, lr, lanes,
                      inplace: bool = False):
    gs = torch.as_tensor(gs, dtype=_F32)[lanes]
    lr = torch.as_tensor(lr, dtype=_F32)[lanes]
    seeds = [zrng._u32(seeds[i]) for i in lanes]
    coeffs = _user_coeffs(gs.shape[1], lr)
    if cfg.weight_decay:
        params = _decay_users(params, lr * torch.tensor(cfg.weight_decay,
                                                        dtype=_F32),
                              lanes, inplace)
        inplace = True               # the decayed dict is already a copy
    for k in range(gs.shape[1]):
        params = add_scaled_z_users(
            params, [zrng.fold_seed(s, k) for s in seeds],
            coeffs[:, k] * gs[:, k], dist=cfg.dist, lanes=lanes,
            inplace=inplace)
        inplace = True
    return params, opt


def momentum_history_init(cfg: MezoConfig):
    """Empty truncated-replay window: M rows of (seed, gs, coeffs), host
    tensors. Zero rows are exact no-ops (g = 0 adds 0 * z)."""
    m, k = cfg.momentum_window, cfg.n_directions
    return {"seeds": torch.zeros((m,), dtype=torch.int64),
            "gs": torch.zeros((m, k), dtype=_F32),
            "coeffs": torch.zeros((m, k), dtype=_F32)}


def _momentum_update(params, opt, seed, gs, direction_mask,
                     cfg: MezoConfig, lr=None, inplace: bool = False):
    """ZO momentum via truncated seed replay: the window keeps each
    step's own f32 coefficients, so replaying an entry applies exactly
    that step's sgd update scaled by ``(1 - beta) * beta^age``. Memory:
    M * (2K + 1) scalars; compute: M * K regeneration sweeps a step."""
    seed = zrng._u32(seed)
    gs = torch.as_tensor(gs, dtype=_F32).reshape(-1)
    lr = _f32(lr, cfg.lr)
    kk = gs.shape[0]
    beta = torch.tensor(cfg.momentum, dtype=_F32)
    coeffs = _direction_coeffs(kk, lr, direction_mask)

    # roll the window: newest last
    seeds_h = torch.cat([torch.as_tensor(opt["seeds"]).to(torch.int64)[1:],
                         torch.tensor([seed], dtype=torch.int64)])
    gs_h = torch.cat([torch.as_tensor(opt["gs"], dtype=_F32)[1:], gs[None]])
    cf_h = torch.cat([torch.as_tensor(opt["coeffs"], dtype=_F32)[1:],
                      coeffs[None]])

    m = seeds_h.shape[0]
    ages = torch.arange(m - 1, -1, -1, dtype=_F32)
    weights = ((1.0 - beta) * beta ** ages if cfg.momentum
               else torch.where(ages == 0, 1.0, 0.0).to(_F32))

    if cfg.weight_decay:
        params = _decay(params, lr * torch.tensor(cfg.weight_decay,
                                                  dtype=_F32), inplace)
        inplace = True               # the decayed dict is already a copy
    for j in range(m):
        s_j = int(seeds_h[j])
        for k in range(kk):
            params = add_scaled_z(params, zrng.fold_seed(s_j, k),
                                  weights[j] * cf_h[j, k] * gs_h[j, k],
                                  dist=cfg.dist, inplace=inplace)
            inplace = True           # later sweeps update that copy
    return params, {"seeds": seeds_h, "gs": gs_h, "coeffs": cf_h}


def _momentum_update_users(params, opt, seeds, gs, cfg: MezoConfig, lr,
                           lanes, inplace: bool = False):
    """:func:`_momentum_update` of each listed lane over a user-stacked
    window ``{"seeds": (U, M), "gs": (U, M, K), "coeffs": (U, M, K)}``:
    the same f32 products a lane at a time, each sweep one
    ``zo_add_users`` over the listed lanes."""
    idx = torch.as_tensor(lanes, dtype=torch.int64)
    gs = torch.as_tensor(gs, dtype=_F32)[idx]
    lr = torch.as_tensor(lr, dtype=_F32)[idx]
    kk = gs.shape[1]
    beta = torch.tensor(cfg.momentum, dtype=_F32)
    coeffs = _user_coeffs(kk, lr)
    new_seeds = torch.tensor([zrng._u32(seeds[i]) for i in lanes],
                             dtype=torch.int64)
    seeds_h = torch.cat([opt["seeds"][idx][:, 1:], new_seeds[:, None]], 1)
    gs_h = torch.cat([opt["gs"][idx][:, 1:], gs[:, None]], 1)
    cf_h = torch.cat([opt["coeffs"][idx][:, 1:], coeffs[:, None]], 1)
    m = seeds_h.shape[1]
    ages = torch.arange(m - 1, -1, -1, dtype=_F32)
    weights = ((1.0 - beta) * beta ** ages if cfg.momentum
               else torch.where(ages == 0, 1.0, 0.0).to(_F32))
    if cfg.weight_decay:
        params = _decay_users(params, lr * torch.tensor(cfg.weight_decay,
                                                        dtype=_F32),
                              lanes, inplace)
        inplace = True
    for j in range(m):
        for k in range(kk):
            params = add_scaled_z_users(
                params, [zrng.fold_seed(int(s), k) for s in seeds_h[:, j]],
                weights[j] * cf_h[:, j, k] * gs_h[:, j, k], dist=cfg.dist,
                lanes=lanes, inplace=inplace)
            inplace = True
    new = {key: v.clone() for key, v in opt.items()}
    new["seeds"][idx], new["gs"][idx], new["coeffs"][idx] = (seeds_h, gs_h,
                                                             cf_h)
    return params, new


def _stale_sgd_update(params, opt, seed, gs, direction_mask,
                      cfg: MezoConfig, lr=None, inplace: bool = False,
                      staleness=None):
    """sgd with staleness decay: the async fleet's update rule.

    ``staleness`` ``None`` or 0 is :func:`_sgd_update` bit for bit (the
    decay multiplies by exactly 1.0), so the checkpoint manager replays a
    stale-sgd log through the standard ``update_fn(params, opt, seed, gs,
    mask, cfg)`` call and a mixed log (synchronous and asynchronous
    records) stays coherent."""
    seed = zrng._u32(seed)
    gs = torch.as_tensor(gs, dtype=_F32).reshape(-1)
    lr = _f32(lr, cfg.lr)
    coeffs = _staleness_coeffs(gs.shape[0], lr, direction_mask,
                               0 if staleness is None else staleness,
                               cfg.staleness_decay)
    return _sgd_apply(params, seed, gs, coeffs, lr, cfg, inplace), opt


# ---------------------------------------------------------------------------
# the composed strategy


@dataclasses.dataclass(frozen=True)
class ZOStrategy:
    """One estimator x update pairing."""
    estimator: DirectionEvaluator
    update: UpdateRule

    @property
    def name(self) -> str:
        return f"{self.estimator.name}+{self.update.name}"

    def init_state(self, params: Params, cfg: MezoConfig,
                   step: int = 0) -> TrainState:
        return TrainState(params=params, step=int(step),
                          opt=self.update.init_fn(cfg))

    def step(self, loss_fn: LossFn, state: TrainState, batch: Any, seed,
             cfg: MezoConfig, direction_mask=None
             ) -> Tuple[TrainState, MezoAux]:
        seed = zrng._u32(seed)
        with span("zo.estimate"):
            params, gs, ls = self.estimator.eval_fn(
                loss_fn, state.params, batch, seed, cfg,
                eps=_f32(None, cfg.eps))
        with span("zo.sync"):
            gs = gs.to("cpu")             # the one host sync of a step
        with span("zo.update"):
            params, opt = self.update.update_fn(
                params, state.opt, seed, gs, direction_mask, cfg,
                lr=_f32(None, cfg.lr), inplace=self.estimator.donate)
        aux = MezoAux(loss=ls.mean(), gs=gs, seed=seed,
                      grad_norm_est=gs.abs().mean())
        return TrainState(params=params, step=state.step + 1, opt=opt), aux

    def step_users(self, loss_fn: LossFn, state: TrainState, batch: Any,
                   seeds, cfg: MezoConfig, active=None, eps=None, lr=None
                   ) -> Tuple[TrainState, MezoAux]:
        """Advance U users' slots in ONE dispatch (the multi-tenant step).

        ``state`` is a user-stacked TrainState (``core.batching``): every
        per-user leaf carries a leading U axis, quantized leaves share
        the one resident int8 base, ``step`` is (U,). ``batch`` leaves
        are stacked on a leading U axis; ``seeds`` U host ints; ``eps`` /
        ``lr`` per-user vectors (or one number); ``active`` the (U,)
        slot-occupancy mask. Inactive lanes come back bit-identical
        (the update touches only active lanes), active lanes
        bit-identical to a lone :meth:`step` with the same (seed, eps,
        lr). One host sync, for the (U, K) ``gs``.

        Requires a pristine estimator (``fused`` / ``vmapdir``): the
        walk's in-place sweeps would accumulate roundoff per lane and
        break the replay-log contract eviction and resume rest on.
        """
        if not self.estimator.pristine:
            raise ValueError(
                f"step_users requires a pristine direction estimator "
                f"(got {self.estimator.name!r}): in-place walk roundoff "
                f"would break per-user replay-log bit-parity")
        if self.update.users_fn is None:
            raise NotImplementedError(
                f"update rule {self.update.name!r} has no user-axis form")
        seeds = [zrng._u32(s) for s in seeds]
        u = len(seeds)
        eps = torch.as_tensor(_f32(eps, cfg.eps)).expand(u).contiguous()
        lr = torch.as_tensor(_f32(lr, cfg.lr)).expand(u).contiguous()
        lanes = (list(range(u)) if active is None else
                 [i for i in range(u) if bool(active[i])])
        with span("zo.estimate"):
            params, gs, ls = self.estimator.users_fn(
                loss_fn, state.params, batch, seeds, cfg, eps)
        with span("zo.sync"):
            gs = gs.to("cpu")             # the one host sync of a dispatch
        opt = state.opt
        if lanes:
            with span("zo.update"):
                params, opt = self.update.users_fn(
                    params, state.opt, seeds, gs, cfg, lr, lanes,
                    inplace=self.estimator.donate)
        step = torch.as_tensor(state.step, dtype=torch.int64).clone()
        step[lanes] += 1
        aux = MezoAux(loss=torch.stack([ls[i].mean() for i in range(u)]),
                      gs=gs, seed=seeds, grad_norm_est=gs.abs().mean(1))
        return TrainState(params=params, step=step, opt=opt), aux

    def run_chunk(self, loss_fn: LossFn, state: TrainState, batches: Any,
                  base_seed, cfg: MezoConfig
                  ) -> Tuple[TrainState, MezoAux]:
        """Run N steps over a batch dict stacked on a leading N axis.
        Step seeds are ``fold_seed(base_seed, state.step)`` -- the
        Trainer's derivation, so a chunked run is seed- and
        replay-log-compatible with a stepwise one. Returns the final
        state and a MezoAux whose fields gain a leading N axis."""
        n = next(iter(batches.values())).shape[0]
        auxes = []
        for i in range(n):
            batch = {k: v[i] for k, v in batches.items()}
            state, aux = self.step(loss_fn, state, batch,
                                   zrng.fold_seed(base_seed, state.step),
                                   cfg)
            auxes.append(aux)
        return state, MezoAux(
            loss=torch.stack([a.loss for a in auxes]),
            gs=torch.stack([a.gs for a in auxes]),
            seed=torch.tensor([a.seed for a in auxes], dtype=torch.int64),
            grad_norm_est=torch.stack([a.grad_norm_est for a in auxes]))


# ---------------------------------------------------------------------------
# the strategy registry (names -> composed strategies)


_ESTIMATORS: Dict[str, DirectionEvaluator] = {}
_UPDATE_RULES: Dict[str, UpdateRule] = {}
_STRATEGY_ALIASES: Dict[str, Tuple[str, str]] = {}
_STRATEGY_CACHE: Dict[Tuple[str, str], ZOStrategy] = {}


def register_estimator(e: DirectionEvaluator) -> DirectionEvaluator:
    _ESTIMATORS[e.name] = e
    return e


def register_update_rule(u: UpdateRule) -> UpdateRule:
    _UPDATE_RULES[u.name] = u
    return u


def register_strategy(name: str, estimator: str, update: str) -> None:
    """Bind a short name (e.g. ``"mezo-fused"``) to a pairing."""
    _STRATEGY_ALIASES[name] = (estimator, update)


def estimator_names():
    return sorted(_ESTIMATORS)


def update_rule_names():
    return sorted(_UPDATE_RULES)


def strategy_names():
    return sorted(_STRATEGY_ALIASES)


def update_rule(name: str) -> UpdateRule:
    """Resolve an update rule by name."""
    if name not in _UPDATE_RULES:
        raise ValueError(f"unknown update rule {name!r}; registered: "
                         f"{update_rule_names()}")
    return _UPDATE_RULES[name]


def check_rule(rule: Optional[UpdateRule]) -> UpdateRule:
    """``None`` -> SGD; a rule is resolved by its name."""
    if rule is None:
        return SGD
    return update_rule(getattr(rule, "name", str(rule)))


def build_strategy(estimator: str = "walk", update: str = "sgd"
                   ) -> ZOStrategy:
    """Compose any estimator x update pairing by name (cached)."""
    if estimator not in _ESTIMATORS:
        raise ValueError(
            f"unknown direction estimator {estimator!r}; "
            f"registered: {estimator_names()}")
    rule = update_rule(update)
    key = (estimator, update)
    if key not in _STRATEGY_CACHE:
        _STRATEGY_CACHE[key] = ZOStrategy(
            estimator=_ESTIMATORS[estimator], update=rule)
    return _STRATEGY_CACHE[key]


def get_strategy(name: str) -> ZOStrategy:
    """Resolve a registered strategy name (``--optimizer`` values)."""
    if name not in _STRATEGY_ALIASES:
        raise ValueError(
            f"unknown ZO strategy {name!r}; registered strategies: "
            f"{strategy_names()} (any estimator x update pairing is "
            f"constructible via build_strategy: {estimator_names()} x "
            f"{update_rule_names()})")
    return build_strategy(*_STRATEGY_ALIASES[name])


WALK = register_estimator(DirectionEvaluator(
    name="walk", eval_fn=_eval_walk, pristine=False, donate=True))
VMAPDIR = register_estimator(DirectionEvaluator(
    name="vmapdir", eval_fn=_eval_vmapdir, pristine=True, donate=False,
    users_fn=_eval_vmapdir_users))
FUSED = register_estimator(DirectionEvaluator(
    name="fused", eval_fn=_eval_fused, pristine=True, donate=True,
    users_fn=_eval_fused_users))

SGD = register_update_rule(UpdateRule(
    name="sgd", init_fn=_sgd_init, update_fn=_sgd_update,
    users_fn=_sgd_update_users))
# a multi-tenant step carries no staleness, so stale-sgd's user-axis form
# is sgd's (the reference vmaps the rule with staleness None: x * 1.0)
STALE_SGD = register_update_rule(UpdateRule(
    name="stale-sgd", init_fn=_sgd_init, update_fn=_stale_sgd_update,
    users_fn=_sgd_update_users))
MOMENTUM = register_update_rule(UpdateRule(
    name="momentum", init_fn=momentum_history_init,
    update_fn=_momentum_update, users_fn=_momentum_update_users))

register_strategy("mezo", "walk", "sgd")
register_strategy("mezo-parallel", "vmapdir", "sgd")
register_strategy("mezo-fused", "fused", "sgd")
register_strategy("mezo-momentum", "vmapdir", "momentum")
register_strategy("mezo-fused-momentum", "fused", "momentum")

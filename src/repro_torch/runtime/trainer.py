"""Fault-tolerant training loop for ZO (MeZO) and gradient (Adam) arms.

Port of the JAX package's ``runtime/trainer.py``: build the model,
resolve the training strategy from the engine registry, auto-resume
(TrainState snapshot + replay log), per-step straggler masks, metrics,
periodic checkpointing. The loop is deliberately dumb -- the cleverness
lives in ``core/`` and ``checkpoint/`` -- so a crash between two
``on_step`` calls loses at most the step in flight.

Strategy resolution: ``TrainerConfig.optimizer`` names a registered
strategy ("mezo", "mezo-parallel", "mezo-fused", "mezo-momentum",
"mezo-fused-momentum") or "adam" for the gradient baseline
(``optim/adam.py``: autograd, Adam in place, the moments snapshotted
with the state and restored on resume; no replay log, since a gradient
depends on the data); ``estimator`` / ``update`` compose any ZO pairing
directly. ``quant="int8"`` quantizes the base after init with zero f32
deltas attached (``_maybe_quantize``): the int8 values stay frozen and
every update lands in the deltas. The checks run in the JAX package's
order and raise its ``ValueError``s: an unknown quant mode, int8 with
adam, adam with an estimator or update.

``straggler_redundancy`` R schedules K + R directions a step and logs
the :class:`~repro_torch.runtime.stragglers.StragglerPolicy` mask with
each record, so replay renormalizes over the same survivors.

``device`` (default ``"cuda"``) is where parameters live and steps run;
each step's batch moves there once. Losses stay on the device and come
to the host every ``log_every`` steps.

:func:`train_multi_tenant` is the one-call multi-tenant path: a batch of
``TrainJob``s through a :class:`repro_torch.train.TrainEngine` over one
shared base.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import rng as zrng
from repro_torch.core.engine import (MezoConfig, TrainState,
                                     build_strategy, get_strategy,
                                     strategy_names)
from repro_torch.core.spans import span
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import resolve_device
from repro_torch.optim.adam import AdamConfig, adam_init, grad_train_step
from repro_torch.optim.quant import (check_quant_mode, quantize_tree,
                                     tree_is_quantized)
from repro_torch.runtime.stragglers import StragglerPolicy

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    optimizer: str = "mezo"          # registered strategy name | adam
    estimator: Optional[str] = None  # walk | vmapdir | fused (overrides
    update: Optional[str] = None     # sgd | momentum        .. optimizer)
    mezo: MezoConfig = MezoConfig()
    adam: AdamConfig = AdamConfig()
    quant: str = "none"              # base-weight quantization: none | int8
    n_steps: int = 100
    seed: int = 0
    ckpt_dir: Optional[str] = None
    snapshot_every: int = 100
    log_every: int = 10
    straggler_redundancy: int = 0
    device: str = "cuda"


class Trainer:
    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainerConfig,
                 batches: Iterator[Any],
                 log_fn: Callable[[str], None] = print):
        check_quant_mode(train_cfg.quant)
        if train_cfg.quant != "none" and train_cfg.optimizer == "adam":
            raise ValueError(
                "quantized bases require a ZO strategy: the gradient "
                "baseline differentiates through the weights, but an "
                "int8 base is frozen (updates live in the f32 delta, "
                "written by seed replay)")
        self.strategy = None
        if train_cfg.optimizer == "adam":
            if train_cfg.estimator or train_cfg.update:
                raise ValueError(
                    "TrainerConfig.estimator/.update compose ZO strategies "
                    "and cannot be combined with optimizer='adam' (the "
                    "gradient baseline has no estimator x update axes)")
        elif train_cfg.estimator or train_cfg.update:
            self.strategy = build_strategy(
                train_cfg.estimator or "walk", train_cfg.update or "sgd")
        elif train_cfg.optimizer not in strategy_names():
            raise ValueError(
                f"unknown TrainerConfig.optimizer {train_cfg.optimizer!r}; "
                f"registered strategies: {strategy_names() + ['adam']} (or "
                f"compose any estimator x update pairing via "
                f"TrainerConfig.estimator/.update)")
        else:
            self.strategy = get_strategy(train_cfg.optimizer)

        self.mcfg = model_cfg
        self.tcfg = train_cfg
        self.device = resolve_device(train_cfg.device)
        self.model = build_model(model_cfg)
        self.batches = batches
        self.log = log_fn
        self.losses: list = []
        self._pending: list = []     # device loss scalars awaiting a sync
        self._straggler = (StragglerPolicy(
            train_cfg.mezo.n_directions, train_cfg.straggler_redundancy)
            if train_cfg.straggler_redundancy else None)
        self.ckpt = (CheckpointManager(
            train_cfg.ckpt_dir,
            mezo_cfg=self._mezo_cfg() if self.strategy else None,
            snapshot_every=train_cfg.snapshot_every,
            update_rule=self.strategy.update if self.strategy else None)
            if train_cfg.ckpt_dir else None)

    # -- setup ------------------------------------------------------------
    def init_params(self) -> Params:
        """Random parameters from ``seed`` (the port cannot reproduce
        ``jax.random``; pass the JAX package's to ``train(params=)``)."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        return self.model.init(gen, self.device)

    def _maybe_quantize(self, params: Params) -> Params:
        """One-shot base quantization (``TrainerConfig.quant``). Deltas
        are attached so every update rule can write the f32 stream; a
        tree that arrives already quantized passes through."""
        if self.tcfg.quant == "none" or tree_is_quantized(params):
            return params
        return quantize_tree(params, self.tcfg.quant, with_delta=True)

    def _mezo_cfg(self) -> MezoConfig:
        """The MeZO config a step runs: K + R directions under a
        straggler policy."""
        c = self.tcfg.mezo
        if self._straggler:
            c = dataclasses.replace(c, n_directions=self._straggler.total)
        return c

    def _init_state(self, params: Params, mcfg: MezoConfig) -> TrainState:
        if self.strategy is not None:
            return self.strategy.init_state(params, mcfg)
        return TrainState(params=params, step=0, opt=adam_init(params))

    def _sync_losses(self):
        """Host-sync the buffered device scalars (one transfer per batch
        of steps instead of one per step)."""
        if self._pending:
            with span("trainer.losses.sync"):
                self.losses.extend(float(x) for x in self._pending)
            self._pending.clear()

    # -- main loop --------------------------------------------------------
    def train(self, params: Optional[Params] = None,
              fail_at: Optional[int] = None) -> Params:
        """Runs to n_steps with auto-resume (only when ``params`` is not
        given). ``fail_at`` raises at that step (fault injection for
        tests). A fused or walk step updates ``params`` in place."""
        start = 0
        mcfg = self._mezo_cfg()
        resume = params is None
        if params is None:
            params = self.init_params()
        params = self._maybe_quantize(params)
        state = self._init_state(params, mcfg)
        if resume and self.ckpt:
            restored, start = self.ckpt.restore(state)
            if restored is not None:
                state = restored
                self.log(f"[trainer] resumed at step {start}")

        t0 = time.perf_counter()
        for step in range(start, self.tcfg.n_steps):
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            with span("trainer.step"):
                with span("trainer.batch"):
                    raw = next(self.batches)
                    with span("trainer.batch.sync"):   # a host copy waits
                        batch = {k: torch.as_tensor(v).to(self.device)
                                 for k, v in raw.items()}
                mask = aux = None
                if self.strategy is None:
                    p, opt, loss = grad_train_step(
                        self.model.loss, state.params, batch, state.opt,
                        self.tcfg.adam)
                    state = TrainState(params=p, step=step + 1, opt=opt)
                    self._pending.append(loss)
                else:
                    if self._straggler:
                        mask = self._straggler.mask()
                    seed = zrng.fold_seed(self.tcfg.seed, step)
                    state, aux = self.strategy.step(self.model.loss, state,
                                                    batch, seed, mcfg, mask)
                    self._pending.append(aux.loss)
                if self.ckpt:
                    self.ckpt.on_step(step, state, aux, direction_mask=mask)
                if step % self.tcfg.log_every == 0:
                    self._sync_losses()
                    dt = time.perf_counter() - t0
                    self.log(f"[trainer] step={step} "
                             f"loss={self.losses[-1]:.4f} ({dt:.1f}s)")
        self._sync_losses()
        return state.params


def train_multi_tenant(model_cfg: ModelConfig, jobs, *, n_slots: int = 4,
                       estimator: str = "fused", update: str = "sgd",
                       seed: int = 0, mezo_cfg: Optional[MezoConfig] = None,
                       quant: str = "none", store=None,
                       log_dir: Optional[str] = None,
                       log_fn: Callable[[str], None] = print,
                       device: str = "cuda", params: Optional[Params] = None):
    """Run ``jobs`` (a TrainJob sequence) through a batched
    :class:`repro_torch.train.TrainEngine` over one shared base -- each
    job's trajectory bit-identical to a lone :class:`Trainer` with
    ``seed=derive_user_seed(seed, job.user)``.

    The base is ``params`` or the model's seeded random init on
    ``device``; ``quant="int8"`` quantizes it before the store adopts it
    (ignored when an explicit ``store`` brings its own base). Returns
    ``(engine, results)``: the engine for its stats and store, results
    jid-sorted.
    """
    from repro_torch.serve.adapters import AdapterStore
    from repro_torch.train import TrainEngine

    check_quant_mode(quant)
    if store is None:
        dev = resolve_device(device)
        if params is None:
            params = build_model(model_cfg).init(
                torch.Generator(device=dev).manual_seed(seed), dev)
        if quant != "none" and not tree_is_quantized(params):
            params = quantize_tree(params, quant, with_delta=True)
        store = AdapterStore(params, mezo_cfg=mezo_cfg or MezoConfig(),
                             update_rule=build_strategy(
                                 estimator, update).update, device=dev)
    engine = TrainEngine(model_cfg, store, n_slots=n_slots,
                         estimator=estimator, update=update, seed=seed,
                         mezo_cfg=mezo_cfg, log_dir=log_dir)
    for job in jobs:
        engine.submit(job)
    results = engine.run()
    s = engine.stats
    log_fn(f"[fleet] {s.finished} jobs, {s.user_steps} user-steps in "
           f"{s.dispatches} dispatches ({s.user_steps_per_s:.2f} "
           f"user-steps/s)")
    return engine, results

"""Checkpoint manager: snapshots + replay log + auto-resume.

Port of the JAX package's ``checkpoint/manager.py``. Policy: a full
train-state snapshot every ``snapshot_every`` steps (expensive, rare), a
replay-log append every step (cheap, always). ``restore()`` loads the
newest snapshot, replays the log tail through the strategy's update rule
(zero forward passes) and reports the step to resume from.

What gets snapshotted is the engine's whole :class:`TrainState` (params,
step counter, update-rule state), so the momentum window survives a
crash. On disk it is the JAX package's format for the same pytree:
``params::<leaf path>``, ``step`` and ``opt::<name>`` entries of
``store.save_params``, so either package restores the other's
snapshots. A bare params dict is accepted as ``restore(like=...)`` too
and replays through ``replay_into``.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.checkpoint.replay_log import ReplayLog, replay_into
from repro_torch.core.engine import SGD, TrainState, UpdateRule

Params = Dict[str, torch.Tensor]


def _flatten(state: Union[TrainState, Params]) -> Params:
    """A TrainState as one flat ``/``-keyed dict (the JAX pytree's paths);
    a bare params dict as it is."""
    if not isinstance(state, TrainState):
        return state
    flat = {f"params/{k}": v for k, v in state.params.items()}
    flat["step"] = torch.tensor(state.step, dtype=torch.int64)
    flat.update({f"opt/{k}": torch.as_tensor(v)
                 for k, v in state.opt.items()})
    return flat


def _unflatten(flat: Params, like: TrainState) -> TrainState:
    return TrainState(
        params={k: flat[f"params/{k}"] for k in like.params},
        step=int(flat["step"]),
        opt={k: flat[f"opt/{k}"] for k in like.opt})


class CheckpointManager:
    def __init__(self, ckpt_dir: str, mezo_cfg=None,
                 snapshot_every: int = 100, keep: int = 2,
                 update_rule: Optional[UpdateRule] = None):
        self.dir = ckpt_dir
        self.cfg = mezo_cfg
        self.snapshot_every = snapshot_every
        self.keep = keep
        self.rule = update_rule
        self.log = (ReplayLog(os.path.join(ckpt_dir, "replay.jsonl"))
                    if mezo_cfg is not None else None)

    # ---- save -----------------------------------------------------------
    def on_step(self, step: int, state, aux=None, direction_mask=None):
        """``state`` is the full TrainState (or a bare params dict);
        ``direction_mask`` is the step's straggler mask, logged so replay
        renormalizes over the same survivors."""
        if self.log is not None and aux is not None:
            self.log.append(step, aux.seed, aux.gs, self.cfg.lr,
                            self.cfg.eps, mask=direction_mask)
        if step % self.snapshot_every == 0:
            store.save_params(self.dir, step, _flatten(state))
            self._gc()

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"))

    # ---- restore --------------------------------------------------------
    def restore(self, like) -> Tuple[Optional[object], int]:
        """Returns (state, next_step) or (None, 0) when nothing is saved.

        ``like`` fixes keys, shapes, dtypes and devices: a TrainState
        restores the full state and replays the log tail through the
        update rule; a bare params dict replays through sgd.
        """
        snap = store.latest_step(self.dir)
        if snap is None:
            return None, 0
        flat = store.load_params(self.dir, snap, _flatten(like))
        obj = _unflatten(flat, like) if isinstance(like, TrainState) \
            else flat
        if self.log is None:
            if isinstance(obj, TrainState):
                obj = dataclasses.replace(obj, step=snap + 1)
            return obj, snap + 1
        records = ReplayLog.read(os.path.join(self.dir, "replay.jsonl"),
                                 after_step=snap)
        if isinstance(obj, TrainState):
            state, last = self._replay_state(obj, records)
            nxt = max(snap, last) + 1
            return dataclasses.replace(state, step=nxt), nxt
        params, last = replay_into(obj, records, self.cfg)
        return params, max(snap, last) + 1

    def _replay_state(self, state: TrainState, records
                      ) -> Tuple[TrainState, int]:
        """Replay logged (seed, gs) records through the update rule, in
        place on the freshly loaded parameters; the momentum window rolls
        forward exactly as the live steps rolled it."""
        rule = self.rule
        if rule is None:
            if state.opt:
                raise ValueError(
                    "restoring a TrainState with non-empty update-rule "
                    "state requires the update_rule= the run was trained "
                    "with; silently replaying the log tail with sgd would "
                    "leave the optimizer state stale")
            rule = SGD
        params, opt, last = state.params, state.opt, -1
        for rec in records:
            if rec.get("staleness") is not None:
                raise NotImplementedError(
                    f"replay record for step {rec.get('step')} carries "
                    f"staleness: the stale-sgd rule lands with the fleet "
                    f"slice")
            c = dataclasses.replace(self.cfg, lr=rec["lr"], eps=rec["eps"])
            mask = rec.get("mask")
            params, opt = rule.update_fn(
                params, opt, np.uint32(rec["seed"]),
                np.asarray(rec["gs"], np.float32),
                None if mask is None else np.asarray(mask, np.float32), c,
                inplace=True)
            last = rec["step"]
        return dataclasses.replace(state, params=params, opt=opt), last

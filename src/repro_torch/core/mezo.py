"""MeZO replay: re-apply a logged step's update from its (seed, gs) record.

Port of ``replay_update`` from the JAX package's ``core/mezo.py``; the
step functions themselves come with the training slice.
"""

from __future__ import annotations

from repro_torch.core.engine import SGD, MezoConfig


def replay_update(params, seed, gs, cfg: MezoConfig, direction_mask=None):
    """Recovery path of the replay-log checkpointer and of adapter
    materialization: the engine's sgd update rule, identical f32
    arithmetic to the live step, hence bit-exact replay."""
    params, _ = SGD.update_fn(params, {}, seed, gs, direction_mask, cfg)
    return params

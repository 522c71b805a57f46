"""User-axis batching helpers shared by the serve and train engines.

Port of the JAX package's ``core/batching.py``. Both engines run a fixed
slot table over one resident base model and advance many tenants per
dispatch; what varies is only where the slot axis lives (the
TrainEngine stacks per-user state on axis 0, the ServeEngine's cache
batches sequences on axis 1):

* :func:`masked_merge` -- the ragged-slot merge of the serving engine:
  keep a slot's previous value wherever its mask bit is off;
* :func:`user_leaf_axes` / :func:`user_state_axes` -- which leaves of a
  user-stacked parameter dict / ``TrainState`` carry the user axis (0)
  and which are shared (``None``); :func:`user_lanes` reads one leaf's
  lane count off them (the perturbed forward and the layer slicing of
  ``models.runtime`` ask it);
* :func:`stack_users` / :func:`install_user` / :func:`take_user` -- build
  a user-stacked tree from per-user trees, write one user into a slot
  lane (in place), and read one lane back out (views);
  :func:`take_lane` reads a lane of the perturbed forward's n lanes
  (lane i of leaves that carry P lanes is leaf lane ``i % P``).

The quantized-leaf convention throughout: ``q`` / ``scale`` are frozen
and shared by every user (one resident int8 base), only the f32 ``delta``
carries per-user state -- so U tenants cost one int8 base plus U delta
sets, and a delta-less (frozen) leaf has no user axis at all.

Trees are flat ``/``-keyed parameter dicts, nested dicts of tensors (an
update rule's state) or a :class:`~repro_torch.core.engine.TrainState`,
whose ``step`` becomes a (U,) int64 tensor when stacked.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from repro_torch.optim.quant import QuantizedLeaf, is_quantized


def _is_state(tree) -> bool:
    from repro_torch.core.engine import TrainState  # engine imports core
    return isinstance(tree, TrainState)


def masked_merge(old, new, mask, axis: int = 0):
    """Per-slot select: ``new`` where ``mask``, ``old`` elsewhere.

    ``old``/``new`` are tensors or (nested) dicts of tensors; ``mask`` is
    an (n_slots,) bool tensor and ``axis`` the slot axis of every leaf.
    (The TrainEngine needs no merge: its update writes only the active
    lanes.)
    """
    if isinstance(old, dict):
        return {k: masked_merge(old[k], new[k], mask, axis) for k in old}
    m = mask.reshape((1,) * axis + (-1,) + (1,) * (old.dim() - axis - 1))
    return torch.where(m, new, old)


# ---------------------------------------------------------------------------
# axes trees (user axis 0; the quantized base shared)


def _leaf_axis(leaf):
    if is_quantized(leaf):
        return QuantizedLeaf(q=None, scale=None,
                             delta=None if leaf.delta is None else 0,
                             orig_dtype=leaf.orig_dtype)
    return 0


def user_leaf_axes(params):
    """The user axis of each leaf of a user-stacked parameter dict: 0 for
    a plain leaf; for a quantized leaf a ``QuantizedLeaf`` of axes whose
    ``q`` and ``scale`` are ``None`` (one resident int8 base serves every
    lane) and whose ``delta`` is 0 (or ``None`` for a frozen leaf)."""
    if isinstance(params, dict):
        return {k: user_leaf_axes(v) for k, v in params.items()}
    return _leaf_axis(params)


def user_lanes(leaf) -> Optional[int]:
    """The length of one user-stacked leaf's user axis (per
    :func:`user_leaf_axes`), ``None`` for a leaf every lane shares (a
    frozen quantized leaf)."""
    ax = _leaf_axis(leaf)
    if is_quantized(leaf):
        return None if ax.delta is None else leaf.delta.shape[ax.delta]
    return leaf.shape[ax]


def user_state_axes(state):
    """Axes of a user-stacked ``TrainState``: params per
    :func:`user_leaf_axes`, the step counter and the rule's state fully
    stacked."""
    from repro_torch.core.engine import TrainState
    return TrainState(params=user_leaf_axes(state.params), step=0,
                      opt={k: 0 for k in state.opt})


# ---------------------------------------------------------------------------
# slot-lane scatter / gather


def stack_users(trees: Sequence[Any]):
    """Stack per-user trees on a new leading user axis. Quantized leaves
    keep the first tree's int8 base (every user shares it by
    construction) and stack only their f32 deltas."""
    first = trees[0]
    if _is_state(first):
        return dataclasses.replace(
            first, params=stack_users([t.params for t in trees]),
            step=torch.tensor([int(t.step) for t in trees],
                              dtype=torch.int64),
            opt=stack_users([t.opt for t in trees]))
    if isinstance(first, dict):
        return {k: stack_users([t[k] for t in trees]) for k in first}
    if is_quantized(first):
        if first.delta is None:
            return first
        return dataclasses.replace(
            first, delta=torch.stack([t.delta for t in trees]))
    return torch.stack([torch.as_tensor(t) for t in trees])


def install_user(stacked, tree, slot: int):
    """Write one user's (unstacked) tree into lane ``slot`` of a
    user-stacked tree, in place; returns ``stacked``."""
    if _is_state(stacked):
        install_user(stacked.params, tree.params, slot)
        stacked.step[slot] = int(tree.step)
        install_user(stacked.opt, tree.opt, slot)
        return stacked
    if isinstance(stacked, dict):
        for k, v in stacked.items():
            install_user(v, tree[k], slot)
        return stacked
    if is_quantized(stacked):
        if stacked.delta is not None:
            stacked.delta[slot].copy_(tree.delta)
        return stacked
    stacked[slot].copy_(torch.as_tensor(tree))
    return stacked


def take_lane(stacked, lane: int):
    """Lane ``lane`` of a user-stacked tree whose leaves carry P lanes
    each (lane i reads leaf lane ``i % P``, a frozen quantized leaf is
    shared), as an unstacked tree of views: what the perturbed forward
    hands a block that runs its lanes one at a time."""
    if isinstance(stacked, dict):
        return {k: take_lane(v, lane) for k, v in stacked.items()}
    p = user_lanes(stacked)
    return stacked if p is None else take_user(stacked, lane % p)


def take_user(stacked, slot: int):
    """Lane ``slot`` of a user-stacked tree as an unstacked per-user tree
    (views of the stacked tensors)."""
    if _is_state(stacked):
        return dataclasses.replace(
            stacked, params=take_user(stacked.params, slot),
            step=int(stacked.step[slot]),
            opt=take_user(stacked.opt, slot))
    if isinstance(stacked, dict):
        return {k: take_user(v, slot) for k, v in stacked.items()}
    if is_quantized(stacked):
        if stacked.delta is None:
            return stacked
        return dataclasses.replace(stacked, delta=stacked.delta[slot])
    return stacked[slot]

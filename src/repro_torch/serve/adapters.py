"""ZO adapters: a user's entire fine-tune as a few-KB replay log.

Port of the JAX package's ``serve/adapters.py``. A MeZO trajectory is
fully determined by ``(theta_base, [(seed_t, gs_t, lr_t, eps_t)])``, so a
personalized model is a scalar log replayed onto the shared base:

* ``put`` / ``import_checkpoint`` / ``save`` / ``load`` -- adapters move
  as replay-log JSONL (the JAX package's on-disk format);
* ``materialize(user)`` -- ``base + replay`` on demand, every update a
  ``zo_add`` sweep over every leaf (the CUDA kernel on the card),
  LRU-cached with a byte budget so hot users pay zero replays;
* ``materialize_state(user)`` -- the replayed ``(params, opt, n)`` a
  fine-tune resumes from;
* ``export_delta`` / ``put_delta`` / ``save_delta`` / ``load_delta`` --
  the compact int8 additive-delta form (one stochastic int8 roundtrip a
  leaf, lossy), in the JAX package's leaf order and ``.npz`` format.

The shared base may be an int8 quantized base (``optim.quant``): replay
then gives it zero deltas and writes only those, so the int8 values and
scales stay shared by every user and the cache charges only the deltas.
Materializing is bit-identical to the JAX package's with Rademacher z.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.replay_log import ReplayLog, apply_record
from repro_torch.core.engine import MezoConfig, UpdateRule, check_rule
from repro_torch.core.spans import span
from repro_torch.models.transformer import resolve_device
from repro_torch.optim.quant import (int8_dequantize, int8_quantize,
                                     is_quantized, leaf_nbytes,
                                     tensor_bytes, tree_is_quantized,
                                     with_delta)

Params = Dict[str, Any]

#: adapter id meaning "no adapter" -- materializes the shared base tree.
BASE_USER = "__base__"


@dataclasses.dataclass(frozen=True)
class ZOAdapter:
    """One user's fine-tune: step-ordered replay-log records."""
    user: str
    records: Tuple[dict, ...]

    @property
    def n_steps(self) -> int:
        return len(self.records)

    @property
    def nbytes(self) -> int:
        """Wire size of the adapter itself (the scalars, not the tree)."""
        return len(json.dumps(list(self.records)).encode())


def tree_bytes(params: Params) -> int:
    return sum(leaf_nbytes(t) for t in params.values())


def _sync(params: Params) -> None:
    devices = {t.device for t in params.values() if t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


def _leaf_order(params: Params) -> List[str]:
    """The paths in the JAX package's leaf order (nested dict keys
    sorted level by level): the order of the compact delta form."""
    return sorted(params, key=lambda path: path.split("/"))


def _eff(leaf) -> torch.Tensor:
    """Effective f32 value of a (possibly quantized) leaf."""
    return leaf.dequantize_f32() if is_quantized(leaf) \
        else leaf.to(torch.float32)


class AdapterStore:
    """Per-user ZO adapters over one shared base parameter dict.

    ``mezo_cfg`` must carry the ``dist`` / ``weight_decay`` the users
    trained with (lr / eps travel inside each record; K is the logged
    ``gs`` length). ``update_rule`` is the rule the users trained with
    (``sgd`` by default, ``stale-sgd`` or ``momentum``; a record that
    carries ``staleness`` replays through the stale-sgd coefficients
    under sgd and stale-sgd alike). ``device`` is where the base lives and the adapters
    materialize (``"cuda"`` unless the caller asks for the CPU).
    """

    def __init__(self, base_params: Params,
                 mezo_cfg: Optional[MezoConfig] = None,
                 cache_bytes: Optional[int] = None,
                 update_rule: Optional[UpdateRule] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        wrong = sorted(p for p, t in base_params.items()
                       if t.device.type != self.device.type)
        if wrong:
            raise ValueError(f"base params must lie on {self.device}; "
                             f"{wrong[:3]} do not")
        self.base = base_params
        self.cfg = mezo_cfg or MezoConfig()
        self.cache_bytes = cache_bytes
        self.rule = check_rule(update_rule)
        self._adapters: Dict[str, ZOAdapter] = {}
        self._deltas: Dict[str, list] = {}
        self._cache: "OrderedDict[str, Params]" = OrderedDict()
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "materialize_s": 0.0}

    # ---- registration ----------------------------------------------------
    def put(self, user: str, records: List[dict]) -> ZOAdapter:
        if user == BASE_USER:
            raise ValueError(f"{BASE_USER!r} is reserved for the base tree")
        ad = ZOAdapter(user=user, records=tuple(records))
        self._adapters[user] = ad
        self._cache.pop(user, None)      # re-registered => stale cache entry
        return ad

    def import_checkpoint(self, user: str, ckpt_dir: str) -> ZOAdapter:
        """Adopt a checkpoint run's replay log (``replay.jsonl``) as this
        user's adapter (the whole log: the base must be the run's
        theta_0)."""
        path = os.path.join(ckpt_dir, "replay.jsonl")
        records = ReplayLog.read(path)
        if not records:
            raise FileNotFoundError(f"no replay records under {ckpt_dir}")
        return self.put(user, records)

    def save(self, user: str, path: str) -> int:
        """Write the adapter as replay-log JSONL; returns bytes written."""
        ad = self._adapters[user]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for rec in ad.records:
                f.write(json.dumps(rec) + "\n")
        return os.path.getsize(path)

    def load(self, user: str, path: str) -> ZOAdapter:
        records = ReplayLog.read(path)
        if not records:
            # an empty adapter would silently serve the base model
            raise FileNotFoundError(f"no replay records in {path}")
        return self.put(user, records)

    def users(self) -> List[str]:
        return sorted(set(self._adapters) | set(self._deltas))

    def records(self, user: Optional[str]) -> Tuple[dict, ...]:
        """The user's stored replay records, step-ordered (empty for the
        base id and for users never ``put``)."""
        if user is None or user == BASE_USER:
            return ()
        ad = self._adapters.get(user)
        return ad.records if ad is not None else ()

    # ---- materialization -------------------------------------------------
    def materialize(self, user: Optional[str]) -> Params:
        """``base + replay(user)`` (or base + int8 delta), LRU-cached."""
        if user is None or user == BASE_USER:
            return self.base
        if user in self._cache:
            self.stats["hits"] += 1
            self._cache.move_to_end(user)
            return self._cache[user]
        t0 = time.perf_counter()
        if user in self._adapters:
            params = self._replay(self._adapters[user].records)
        elif user in self._deltas:
            params = self._apply_delta(self._deltas[user])
        else:
            raise KeyError(f"unknown adapter {user!r}; have {self.users()}")
        with span("store.sync"):
            _sync(params)
        self.stats["misses"] += 1
        self.stats["materialize_s"] += time.perf_counter() - t0
        self._cache[user] = params
        self._evict()
        return params

    def _replay_records(self, records):
        """Replay a log through the update rule from a fresh state --
        identical arithmetic to the live steps. Returns ``(params, opt)``.
        A frozen (delta-less) quantized base gains zero deltas first. The
        first update copies the base; the later ones update that copy in
        place, so a replay peaks at one copy beside the base."""
        params, opt = self.base, self.rule.init_fn(self.cfg)
        if tree_is_quantized(params):
            params = with_delta(params)
        fresh = False
        for rec in records:
            params, opt = apply_record(self.rule, params, opt, rec,
                                       self.cfg, inplace=fresh)
            fresh = True
        return params, opt

    def _replay(self, records) -> Params:
        return self._replay_records(records)[0]

    def materialize_state(self, user: Optional[str]
                          ) -> Tuple[Params, Any, int]:
        """Resume point for a fine-tune: ``(params, opt, n_replayed)``
        after replaying the user's stored records from the base. ``None``
        / ``BASE_USER`` / an unknown user start fresh (zero records); a
        user known only by a compact int8 delta raises -- the delta is
        lossy, so training from it would fork the trajectory from its own
        replay log."""
        if (user is not None and user != BASE_USER
                and user in self._deltas and user not in self._adapters):
            raise ValueError(
                f"adapter {user!r} exists only as a lossy int8 delta; "
                f"training resume needs the exact replay log")
        recs = self.records(user)
        params, opt = self._replay_records(recs)
        return params, opt, len(recs)

    def cached_bytes(self) -> int:
        """Bytes the cache adds on top of the shared base: a quantized
        leaf of a materialized tree shares the base's int8 values and
        scales, so only its per-user delta is charged."""
        total = 0
        for params in self._cache.values():
            for leaf in params.values():
                if is_quantized(leaf):
                    total += (tensor_bytes(leaf.delta)
                              if leaf.delta is not None else 0)
                else:
                    total += tensor_bytes(leaf)
        return total

    def _evict(self):
        """Drop least-recently-used materialized trees past the byte
        budget -- always keeping the most recent one."""
        if self.cache_bytes is None:
            return
        while len(self._cache) > 1 and self.cached_bytes() > self.cache_bytes:
            self._cache.popitem(last=False)
            self.stats["evictions"] += 1

    # ---- compact int8 delta form ----------------------------------------
    def export_delta(self, user: str) -> list:
        """Compact the adapter into per-leaf int8 ``(q, scale)`` deltas of
        the effective weights against the base, in the JAX package's leaf
        order: O(params) bytes instead of O(steps) replay work. Lossy
        (one stochastic int8 roundtrip a leaf). ``q`` stays on the
        store's device; ``scale`` is a Python float."""
        mat = self.materialize(user)
        out = []
        for path in _leaf_order(self.base):
            q, s = int8_quantize(_eff(mat[path]) - _eff(self.base[path]))
            out.append((q, float(s)))
        return out

    def put_delta(self, user: str, delta: list):
        if user == BASE_USER:
            raise ValueError(f"{BASE_USER!r} is reserved for the base tree")
        self._deltas[user] = delta
        self._cache.pop(user, None)

    def _apply_delta(self, delta: list) -> Params:
        order = _leaf_order(self.base)
        if len(delta) != len(order):
            raise ValueError(f"delta has {len(delta)} leaves, base has "
                             f"{len(order)}")
        new = {}
        for path, (q, s) in zip(order, delta):
            b = self.base[path]
            d = int8_dequantize(torch.as_tensor(q).to(self.device), s)
            if is_quantized(b):
                # the int8 base stays resident; the delta stays additive
                new[path] = dataclasses.replace(
                    b, delta=d if b.delta is None else b.delta + d)
            else:
                new[path] = (b.to(torch.float32) + d).to(b.dtype)
        return {path: new[path] for path in self.base}

    def save_delta(self, user: str, path: str) -> int:
        """Write the compact delta as ``.npz`` (``q_i`` int8, ``s_i`` f32
        in leaf order, the JAX package's file); returns bytes written."""
        if not path.endswith(".npz"):      # np.savez appends it silently
            path += ".npz"
        arrays = {}
        for i, (q, s) in enumerate(self._deltas.get(user)
                                   or self.export_delta(user)):
            arrays[f"q_{i}"] = torch.as_tensor(q).cpu().numpy()
            arrays[f"s_{i}"] = np.float32(s)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **arrays)
        return os.path.getsize(path)

    def load_delta(self, user: str, path: str):
        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path) as data:
            n = len([k for k in data.files if k.startswith("q_")])
            self.put_delta(user, [(torch.from_numpy(data[f"q_{i}"]),
                                   float(data[f"s_{i}"]))
                                  for i in range(n)])

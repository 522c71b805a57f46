"""ZO adapters: a user's entire fine-tune as a few-KB replay log.

Port of the JAX package's ``serve/adapters.py`` (replay form; the
compact int8 delta form comes with the int8 slice). A MeZO trajectory is
fully determined by ``(theta_base, [(seed_t, gs_t, lr_t, eps_t)])``, so a
personalized model is a scalar log replayed onto the shared base:

* ``put`` / ``import_checkpoint`` / ``save`` / ``load`` -- adapters move
  as replay-log JSONL (the JAX package's on-disk format);
* ``materialize(user)`` -- ``base + replay`` on demand, every update a
  ``zo_add`` sweep over every leaf (the CUDA kernel on the card),
  LRU-cached with a byte budget so hot users pay zero replays.

Materializing is bit-identical to the JAX package's with Rademacher z.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.replay_log import ReplayLog
from repro_torch.core.engine import MezoConfig, UpdateRule, check_rule
from repro_torch.models.transformer import resolve_device

Params = Dict[str, torch.Tensor]

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
    return sum(t.numel() * t.element_size() for t in params.values())


def _sync(params: Params) -> None:
    devices = {t.device for t in params.values() if t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


class AdapterStore:
    """Per-user ZO adapters over one shared base parameter dict.

    ``mezo_cfg`` must carry the ``dist`` / ``weight_decay`` the users
    trained with (lr / eps travel inside each record; K is the logged
    ``gs`` length). ``update_rule`` is the rule the users trained with
    (``sgd`` by default, or ``momentum``; ``stale-sgd`` raises until the
    fleet slice). ``device`` is where the base lives and the adapters
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
        self._cache: "OrderedDict[str, Params]" = OrderedDict()
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "materialize_s": 0.0, "last_materialize_s": 0.0}

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
        return sorted(self._adapters)

    def records(self, user: Optional[str]) -> Tuple[dict, ...]:
        """The user's stored replay records, step-ordered (empty for the
        base id and for users never ``put``)."""
        if user is None or user == BASE_USER:
            return ()
        ad = self._adapters.get(user)
        return ad.records if ad is not None else ()

    # ---- materialization -------------------------------------------------
    def materialize(self, user: Optional[str]) -> Params:
        """``base + replay(user)``, LRU-cached."""
        if user is None or user == BASE_USER:
            return self.base
        if user in self._cache:
            self.stats["hits"] += 1
            self._cache.move_to_end(user)
            return self._cache[user]
        if user not in self._adapters:
            raise KeyError(f"unknown adapter {user!r}; have {self.users()}")
        t0 = time.perf_counter()
        params = self._replay(self._adapters[user].records)
        _sync(params)
        dt = time.perf_counter() - t0
        self.stats["misses"] += 1
        self.stats["materialize_s"] += dt
        self.stats["last_materialize_s"] = dt
        self._cache[user] = params
        self._evict()
        return params

    def _replay_records(self, records):
        """Replay a log through the update rule from a fresh state --
        identical arithmetic to the live steps. Returns ``(params, opt)``."""
        params, opt = self.base, self.rule.init_fn(self.cfg)
        for rec in records:
            if rec.get("staleness") is not None:
                raise NotImplementedError(
                    "replay records with staleness need the stale-sgd "
                    "rule, which lands with the fleet slice")
            c = dataclasses.replace(self.cfg, lr=rec["lr"], eps=rec["eps"])
            mask = rec.get("mask")
            params, opt = self.rule.update_fn(
                params, opt, np.uint32(rec["seed"]),
                np.asarray(rec["gs"], np.float32),
                None if mask is None else np.asarray(mask, np.float32), c)
        return params, opt

    def _replay(self, records) -> Params:
        return self._replay_records(records)[0]

    def cached_bytes(self) -> int:
        """Bytes the cache holds on top of the shared base."""
        return sum(tree_bytes(t) for t in self._cache.values())

    def _evict(self):
        """Drop least-recently-used materialized trees past the byte
        budget -- always keeping the most recent one."""
        if self.cache_bytes is None:
            return
        while len(self._cache) > 1 and self.cached_bytes() > self.cache_bytes:
            self._cache.popitem(last=False)
            self.stats["evictions"] += 1

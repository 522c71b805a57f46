"""Batched multi-tenant ZO TrainEngine: one dispatch advances B users.

Port of the JAX package's ``train/engine.py``. The serving side holds
many users as replay-log adapters over one resident base; this is the
trainer-side twin. A fixed table of ``n_slots`` fine-tune slots shares
one user-batched step (``ZOStrategy.step_users``): every per-user leaf
of the stacked :class:`~repro_torch.core.engine.TrainState` carries a
leading slot axis, quantized leaves keep the one resident int8 base
(``q`` / ``scale`` shared, only the f32 deltas per slot), and each engine
step runs the fused perturbed forward over every slot and both signs at
once -- one ``zo_matmul_users`` launch a projection on the card.

Correctness spine (what the tests pin):

* **bit-parity** -- an active slot's trajectory (losses, gs, parameters
  or deltas, replay-log lines) is bit-identical to a lone sequential
  :class:`~repro_torch.runtime.trainer.Trainer` run with the same
  per-user seed: every kernel lane runs the scalar kernel's arithmetic,
  what the card might sum in another order at another batch size runs
  lane by lane, and inactive lanes are not touched by the update;
* **seed isolation** -- per-user base seeds derive as
  ``fold_seed(engine_seed, crc32(user))`` (:func:`derive_user_seed`),
  per-step seeds as ``fold_seed(user_seed, step)``: a slot's z-streams
  depend only on (user, step, leaf), never on the slot or co-residents;
* **evict/resume** -- finishing or evicting a slot flushes its
  ``(seed, gs)`` records to the :class:`~repro_torch.serve.adapters
  .AdapterStore` (and, with ``log_dir``, to a per-user replay-log
  JSONL); re-admission replays them through the update rule
  (``store.materialize_state``), bit-identical to never having been
  evicted.

Jobs queue like serve requests: whenever a slot frees, the next job is
admitted mid-flight (its resume state copied into the slot lane); slots
finish independently (ragged targets).
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.checkpoint.replay_log import ReplayLog
from repro_torch.core import rng as zrng
from repro_torch.core.batching import install_user, stack_users
from repro_torch.core.engine import MezoConfig, TrainState, build_strategy
from repro_torch.core.spans import span
from repro_torch.models import build_model

#: a job's data: a sequence indexed by the user's GLOBAL step, or a
#: callable step -> batch (so a resumed job consumes exactly the batches
#: an uninterrupted run would have).
BatchSource = Union[Sequence[Any], Callable[[int], Any]]


def derive_user_seed(engine_seed: int, user: str) -> int:
    """Stable per-user base seed: ``fold_seed(engine_seed, crc32(user))``,
    a pure function of (engine_seed, user), never of the slot or the
    admission order."""
    return zrng.fold_seed(engine_seed, zrng.leaf_salt(user))


@dataclasses.dataclass
class TrainJob:
    """One user's fine-tune job. ``n_steps`` is the user's TOTAL step
    target: a job resumed from k stored records runs ``n_steps - k``
    more steps (zero if already met), as ``Trainer``'s ``n_steps``."""
    user: str
    batches: BatchSource
    n_steps: int
    seed: Optional[int] = None       # per-user base seed (default derived)
    lr: Optional[float] = None       # per-user override of cfg.lr
    eps: Optional[float] = None      # per-user override of cfg.eps
    jid: int = -1                    # assigned by submit()


@dataclasses.dataclass
class JobResult:
    user: str
    jid: int
    start_step: int                  # replayed records at admission
    n_steps: int                     # user-global steps completed
    losses: List[float]              # this residency's step losses
    records: List[dict]              # the user's FULL replay log
    evicted: bool = False


@dataclasses.dataclass
class TrainStats:
    dispatches: int = 0              # batched step_users calls
    user_steps: int = 0              # total user-steps advanced
    train_s: float = 0.0
    admitted: int = 0
    finished: int = 0
    evicted: int = 0

    @property
    def user_steps_per_s(self) -> float:
        return self.user_steps / self.train_s if self.train_s else 0.0


class TrainEngine:
    """Slot-table multi-tenant trainer over one AdapterStore base.

    The store is both job source (admission resumes from a user's
    records) and sink (finish/evict flushes the grown log back), so a
    user can move between training and serving with only the scalar log
    travelling. Parameters live on the store's device.
    """

    def __init__(self, model_cfg, store, n_slots: int = 4,
                 estimator: str = "fused", update: str = "sgd",
                 seed: int = 0, mezo_cfg: Optional[MezoConfig] = None,
                 log_dir: Optional[str] = None):
        self.cfg = model_cfg
        self.model = build_model(model_cfg)
        self.store = store
        self.device = store.device
        self.mz = mezo_cfg or store.cfg
        self.strategy = build_strategy(estimator, update)
        if not self.strategy.estimator.pristine:
            raise ValueError(
                f"TrainEngine requires a pristine direction estimator "
                f"(vmapdir/fused), got {estimator!r}: the in-place walk's "
                f"roundoff would break replay-log bit-parity on resume")
        if self.strategy.update.name != store.rule.name:
            raise ValueError(
                f"engine update rule {self.strategy.update.name!r} != "
                f"store rule {store.rule.name!r}: eviction would flush "
                f"records the store replays with different arithmetic")
        self.n_slots = n_slots
        self.seed = seed
        self.log_dir = log_dir
        self.stats = TrainStats()

        self.queue: deque = deque()
        self._next_jid = 0
        self._job: List[Optional[TrainJob]] = [None] * n_slots
        self._active = np.zeros(n_slots, bool)
        self._user_seed = [0] * n_slots
        self._step = np.zeros(n_slots, np.int64)     # user-global step
        self._target = np.zeros(n_slots, np.int64)
        self._start = np.zeros(n_slots, np.int64)
        # Python floats: replay-log lines carry these verbatim and must
        # serialize byte-identically to the sequential CheckpointManager's
        # (which logs cfg.lr / cfg.eps)
        self._lr = [float(self.mz.lr)] * n_slots
        self._eps = [float(self.mz.eps)] * n_slots
        self._prior: List[List[dict]] = [[] for _ in range(n_slots)]
        # per-slot pending (step, seed, host gs, device loss) rows: the
        # losses come to the host at flush, so the loop stays async
        self._pending: List[list] = [[] for _ in range(n_slots)]
        self._results: List[JobResult] = []

        params, opt, _ = self.store.materialize_state(None)
        template = TrainState(params=params, step=0, opt=opt)
        self._state = stack_users([template] * n_slots)
        self._template_batch = None

    # ---- job lifecycle ---------------------------------------------------
    def submit(self, job: TrainJob) -> int:
        if job.n_steps < 0:
            raise ValueError("n_steps must be >= 0")
        job.jid = self._next_jid
        self._next_jid += 1
        self.queue.append(job)
        return job.jid

    def _free_slots(self) -> List[int]:
        return [i for i in range(self.n_slots) if not self._active[i]]

    def _resident_users(self):
        return {self._job[i].user for i in range(self.n_slots)
                if self._active[i]}

    def _admit(self):
        for slot in self._free_slots():
            if not self.queue:
                return
            if self.queue[0].user in self._resident_users():
                # one slot per user at a time: a user's trajectory is a
                # single sequential record stream; it admits when the
                # resident job frees its slot
                return
            job = self.queue.popleft()
            with span("engine.admit"):
                params, opt, done = self.store.materialize_state(job.user)
                self._prior[slot] = list(self.store.records(job.user))
                seed = (derive_user_seed(self.seed, job.user)
                        if job.seed is None else zrng._u32(job.seed))
                resident = {self._user_seed[i] for i in range(self.n_slots)
                            if self._active[i]}
                if seed in resident:
                    raise ValueError(
                        f"per-user seed collision admitting {job.user!r} "
                        f"(seed {seed}): set an explicit TrainJob.seed -- "
                        f"two co-resident users sharing a base seed would "
                        f"draw identical z streams")
                install_user(self._state,
                             TrainState(params=params, step=done, opt=opt),
                             slot)
                del params, opt
            self._job[slot] = job
            self._active[slot] = True
            self._user_seed[slot] = seed
            self._step[slot] = self._start[slot] = done
            self._target[slot] = job.n_steps
            self._lr[slot] = float(self.mz.lr if job.lr is None else job.lr)
            self._eps[slot] = float(self.mz.eps if job.eps is None
                                    else job.eps)
            self._pending[slot] = []
            self.stats.admitted += 1
            if done >= job.n_steps:      # target already met by the log
                self._finish(slot)

    def _batch_at(self, job: TrainJob, step: int):
        b = (job.batches(step) if callable(job.batches)
             else job.batches[step])
        return {k: np.asarray(v) for k, v in b.items()}

    def _flush(self, slot: int) -> JobResult:
        """Host-sync the slot's pending rows into replay records, push
        the grown log to the store (and log_dir), build the result."""
        with span("engine.flush"):
            job = self._job[slot]
            lr, eps = float(self._lr[slot]), float(self._eps[slot])
            records = list(self._prior[slot])
            for step, seed, gs, _ in self._pending[slot]:
                # ReplayLog.append's key order and values: the engine's
                # records are line-identical to a sequential Trainer's log
                records.append({
                    "step": int(step), "seed": int(seed),
                    "gs": np.asarray(gs, np.float32).reshape(-1).tolist(),
                    "lr": lr, "eps": eps})
            with span("engine.flush.sync"):   # the device losses come over
                losses = [float(row[3]) for row in self._pending[slot]]
            self._pending[slot] = []
            if records:
                self.store.put(job.user, records)
            if self.log_dir and losses:
                # append only this residency's new records: across
                # evict/re-admit cycles the file accumulates the user's
                # whole stream, and AdapterStore.load rebuilds it after a
                # crash
                log = ReplayLog(os.path.join(self.log_dir,
                                             f"{job.user}.jsonl"))
                for rec in records[len(self._prior[slot]):]:
                    log.append(rec["step"], rec["seed"], rec["gs"],
                               rec["lr"], rec["eps"])
                log.close()
            return JobResult(user=job.user, jid=job.jid,
                             start_step=int(self._start[slot]),
                             n_steps=int(self._step[slot]), losses=losses,
                             records=records)

    def _release(self, slot: int):
        self._job[slot] = None
        self._active[slot] = False
        self._prior[slot] = []

    def _finish(self, slot: int):
        res = self._flush(slot)
        self._results.append(res)
        self._release(slot)
        self.stats.finished += 1

    def evict(self, user: str) -> JobResult:
        """Flush a mid-flight user's records and free its slot. The
        result has ``evicted=True``; resubmitting a job for the user
        resumes from the flushed log, bit-identical to never having been
        evicted."""
        for slot in range(self.n_slots):
            if self._active[slot] and self._job[slot].user == user:
                res = self._flush(slot)
                res.evicted = True
                self._results.append(res)
                self._release(slot)
                self.stats.evicted += 1
                return res
        raise KeyError(f"user {user!r} is not resident")

    # ---- the batched step ------------------------------------------------
    def step(self) -> bool:
        """Admit whatever fits, then advance every active slot one user
        step in ONE batched dispatch. Returns False when idle."""
        with span("engine.dispatch"):
            self._admit()
            if not self._active.any():
                return False
            t0 = time.perf_counter()
            with span("engine.batch"):
                lane_batch = {}
                for slot in np.flatnonzero(self._active):
                    b = self._batch_at(self._job[slot], int(self._step[slot]))
                    if self._template_batch is None:
                        self._template_batch = {
                            k: np.zeros_like(v) for k, v in b.items()}
                    lane_batch[int(slot)] = b
                lanes = [lane_batch.get(slot, self._template_batch)
                         for slot in range(self.n_slots)]
                stacked = {k: np.stack([b[k] for b in lanes])
                           for k in lanes[0]}
                with span("engine.batch.sync"):   # a pageable copy waits
                    batch = {k: torch.from_numpy(v).to(self.device)
                             for k, v in stacked.items()}
            seeds = [zrng.fold_seed(self._user_seed[slot],
                                    int(self._step[slot]))
                     for slot in range(self.n_slots)]
            self._state, aux = self.strategy.step_users(
                self.model.loss, self._state, batch, seeds, self.mz,
                self._active.copy(),
                eps=torch.tensor(self._eps, dtype=torch.float32),
                lr=torch.tensor(self._lr, dtype=torch.float32))
            for slot in np.flatnonzero(self._active):
                self._pending[slot].append(
                    (int(self._step[slot]), seeds[slot], aux.gs[slot],
                     aux.loss[slot]))
                self._step[slot] += 1
            self.stats.dispatches += 1
            self.stats.user_steps += int(self._active.sum())
            for slot in np.flatnonzero(self._active):
                if self._step[slot] >= self._target[slot]:
                    self._finish(slot)
            self.stats.train_s += time.perf_counter() - t0
            return True

    def drain_results(self) -> List[JobResult]:
        out, self._results = self._results, []
        return out

    def run(self) -> List[JobResult]:
        """Train until queue and slots are empty; results jid-sorted."""
        out: List[JobResult] = []
        while self.queue or self._active.any():
            self.step()
            out.extend(self.drain_results())
        return sorted(out, key=lambda r: r.jid)

"""Async elastic direction service: fleet-scale ZO training.

Port of the JAX package's ``runtime/fleet.py``. A ZO training step is
commutative scalar accumulation of ``(seed, gs)`` pairs, which tolerates
asynchrony far better than gradient descent: a stale projected gradient
is still an unbiased directional sample at a nearby point. This module
trains over a fleet of heterogeneous, flaky device-grade workers:

* a :class:`FleetCoordinator` owns the authoritative params and hands
  out ``(step, seed, k)`` **direction leases** to whichever worker asks;
* workers evaluate the K perturbed-forward pairs against whatever params
  version they snapshotted at lease time and return ``gs`` at their own
  pace (device grades modeled by the roofline latency profiles of
  :mod:`repro_torch.roofline.analysis`);
* the coordinator applies each result **staleness-decayed** -- scaled by
  ``staleness_decay ** (version_now - version_at_snapshot)`` through the
  ``stale-sgd`` update rule -- and records the applied update (staleness
  and survivor mask included) in the replay log;
* lease expiry reuses :meth:`StragglerPolicy.deadline`: an overdue step
  is re-issued to the next idle worker, and whichever result arrives
  first wins -- late or duplicate deliveries are dropped, never logged;
* worker join/leave mid-round resizes the straggler policy and moves the
  authoritative params onto the resized mesh (``elastic_mesh`` /
  ``remesh_params``: values untouched, and on one device no copy).

**Bit-replayability** is by construction: the live coordinator applies
every update by calling :func:`repro_torch.checkpoint.replay_log.
replay_into` on the very record it just logged, so replaying the log
from theta_0 re-executes the identical f32 arithmetic in the identical
order.

**Leased snapshots are shared by reference.** A lease holds the params
version of its issue time, and several leases may hold one version. The
coordinator therefore never writes a version: ``replay_into`` applies
each record out of place (its first direction copies, the rest update
that fresh copy), so each applied update makes a new version and the
old one lives on until the last lease holding it is gone. At most about
one version per busy worker plus the head is alive
(:attr:`FleetReport.max_live_versions`).

:class:`FleetSim` drives a coordinator and an in-process worker pool
through a deterministic discrete-event simulation (virtual time,
heap-ordered deliveries, the reference's event for event): lease
latencies come from the grade model with ``default_rng((seed, wid,
step))`` jitter, never from the wall clock or the losses, so the
schedule is the reference's whatever the device computes. Each lease's
device work is one fused (or vmapdir) evaluation on the configured
device -- ``zo_matmul`` projections on the card.

The ``"server"`` grade is the H100's data sheet (989e12 bf16 FLOP/s,
3.35e12 B/s); the phone grades are the reference's figures.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.replay_log import ReplayLog, replay_into
from repro_torch.core import rng as zrng
from repro_torch.core.engine import MezoConfig, _f32, build_strategy
from repro_torch.models.transformer import resolve_device
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
from repro_torch.roofline.analysis import active_params, model_flops
from repro_torch.runtime.elastic import elastic_mesh, remesh_params
from repro_torch.runtime.stragglers import StragglerPolicy

Params = Dict[str, Any]

# the H100 SXM data sheet: bf16 dense tensor-core peak, HBM3 bandwidth
H100_PEAK_FLOPS_BF16 = PEAK_FLOPS_BF16
H100_HBM_BW = HBM_BW


# ---------------------------------------------------------------------------
# device grades (roofline latency profiles)


@dataclasses.dataclass(frozen=True)
class DeviceGrade:
    """A worker's hardware envelope. Lease latency is the classic
    two-term roofline: max(FLOPs / peak, bytes / bandwidth)."""
    name: str
    peak_flops: float            # FLOP/s
    mem_bw: float                # bytes/s


DEVICE_GRADES: Dict[str, DeviceGrade] = {
    # a server-class card: the H100 this port runs on
    "server": DeviceGrade("server", H100_PEAK_FLOPS_BF16, H100_HBM_BW),
    # phone SoC grades, the paper's regime: flagship NPU down to a
    # budget part -- order-of-magnitude figures, what matters is the
    # relative spread the scheduler has to absorb
    "flagship": DeviceGrade("flagship", 2.0e12, 60e9),
    "midrange": DeviceGrade("midrange", 5.0e11, 30e9),
    "budget": DeviceGrade("budget", 1.2e11, 12e9),
}


def get_grade(name: str) -> DeviceGrade:
    if name not in DEVICE_GRADES:
        raise ValueError(f"unknown device grade {name!r}; registered: "
                         f"{sorted(DEVICE_GRADES)}")
    return DEVICE_GRADES[name]


def lease_latency_s(model_cfg, grade: DeviceGrade, n_tokens: int,
                    k: int) -> float:
    """Modeled seconds for one direction lease on a device grade: K
    directions x 2 perturbed forwards over ``n_tokens``, each forward
    streaming the active params once (ZO adds no optimizer traffic)."""
    flops = model_flops(model_cfg, n_tokens, "train") * k   # 4*N*D per dir
    bytes_ = 2.0 * k * 4.0 * active_params(model_cfg)       # 2 fwd, f32
    return max(flops / grade.peak_flops, bytes_ / grade.mem_bw)


# ---------------------------------------------------------------------------
# workers and faults


@dataclasses.dataclass
class FaultSpec:
    """Injectable per-worker failure modes (all deterministic given the
    sim seed)."""
    latency_scale: float = 1.0       # >1: a straggler
    jitter: float = 0.05             # +-fraction of modeled latency
    die_at: Optional[float] = None   # virtual seconds; kills in-flight work
    duplicate_every: int = 0         # deliver every Nth result twice
    drop_directions: int = 0         # per lease: trailing dirs it fails


@dataclasses.dataclass
class WorkerSpec:
    grade: str = "flagship"
    faults: FaultSpec = dataclasses.field(default_factory=FaultSpec)


@dataclasses.dataclass
class DirectionLease:
    """One step's direction-evaluation assignment. ``version`` is the
    coordinator's applied-update count when the worker snapshotted
    ``params`` -- staleness at apply time is measured against it."""
    step: int
    seed: int                        # uint32 step seed (fold of run seed)
    k: int                           # directions in the lease
    version: int
    params: Params                   # snapshot reference, never written
    worker: int
    issued_at: float
    expired: bool = False


# ---------------------------------------------------------------------------
# the coordinator


class FleetCoordinator:
    """Authoritative state owner of an async direction-service run.

    Transport-agnostic: :meth:`next_lease` and :meth:`submit` are the
    whole device-facing protocol. Everything applied is appended to the
    replay log (staleness and survivor mask included) and the live apply
    goes *through* ``replay_into`` on the freshly built record, so the
    log is bit-exact replayable by construction -- across lease
    re-issues, dropped duplicates and elastic resizes alike.
    """

    def __init__(self, params: Params, cfg: MezoConfig, *,
                 total_steps: int, n_workers: int, seed: int = 0,
                 deadline_factor: float = 3.0, ema: float = 0.9,
                 log_path: Optional[str] = None, remesh: bool = False):
        if total_steps < 1:
            raise ValueError(f"total_steps must be >= 1, got {total_steps}")
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        if not 0.0 < cfg.staleness_decay <= 1.0:
            raise ValueError(
                f"staleness_decay must be in (0, 1], got "
                f"{cfg.staleness_decay} (1.0 = no decay; 0 would zero "
                f"every stale update instead of down-weighting it)")
        self.params = params
        self.cfg = cfg
        self.total_steps = total_steps
        self.seed = seed
        self.deadline_factor = deadline_factor
        self.ema = ema
        self.remesh = remesh
        self.version = 0                       # applied-update count
        self.records: List[dict] = []          # applied, in apply order
        self.losses: List[float] = []          # at-eval loss per apply
        self.log = ReplayLog(log_path) if log_path else None

        self._roster: List[int] = list(range(n_workers))
        self._next_wid = n_workers
        self._issued = 0                       # next fresh step id
        self._applied: set = set()
        self._reissue: deque = deque()
        self._inflight: Dict[int, List[DirectionLease]] = {}
        self.policy = StragglerPolicy(n_workers,
                                      deadline_factor=deadline_factor,
                                      ema=ema)
        self.reissued = 0
        self.dropped = 0                       # late/duplicate deliveries
        self.resizes = 0

    # ---- leases ---------------------------------------------------------
    def done(self) -> bool:
        return len(self._applied) >= self.total_steps

    def step_seed(self, step: int) -> int:
        return zrng.fold_seed(self.seed, step)

    def next_lease(self, worker: int, now: float
                   ) -> Optional[DirectionLease]:
        """Hand the calling worker a direction lease: an expired step to
        re-evaluate if one is overdue, else the next fresh step. None
        when there is nothing to do right now (all remaining steps are
        in flight within deadline)."""
        self.expire(now)
        while self._reissue and self._reissue[0] in self._applied:
            self._reissue.popleft()
        if self._reissue:
            step = self._reissue.popleft()
            self.reissued += 1
        elif self._issued < self.total_steps:
            step = self._issued
            self._issued += 1
        else:
            return None
        lease = DirectionLease(step=step, seed=self.step_seed(step),
                               k=self.cfg.n_directions,
                               version=self.version, params=self.params,
                               worker=worker, issued_at=now)
        self._inflight.setdefault(step, []).append(lease)
        return lease

    def expire(self, now: float):
        """Mark overdue leases expired (StragglerPolicy deadline: a
        ``deadline_factor`` multiple of the EMA-median latency) and
        queue their steps for re-issue once no un-expired lease is still
        chasing them. Expired leases may still deliver -- first result
        wins regardless; expiry only buys redundancy."""
        budget = self.policy.deadline()
        if math.isinf(budget):
            return
        for step, leases in self._inflight.items():
            if step in self._applied:
                continue
            for lease in leases:
                if not lease.expired and now - lease.issued_at > budget:
                    lease.expired = True
            if (all(lease.expired for lease in leases)
                    and step not in self._reissue):
                self._reissue.append(step)

    # ---- results --------------------------------------------------------
    def submit(self, lease: DirectionLease, gs, now: float, mask=None,
               loss: Optional[float] = None) -> bool:
        """Deliver a lease's ``gs``. Returns True iff the update was
        applied; False means the step was already applied (a late or
        duplicate delivery) and the result was dropped -- dropped
        results never reach the log."""
        self._observe(lease.worker, now - lease.issued_at)
        if lease.step in self._applied:
            self.dropped += 1
            return False
        rec = {"step": int(lease.step), "seed": int(lease.seed),
               "gs": np.asarray(gs, np.float32).reshape(-1).tolist(),
               "lr": float(self.cfg.lr), "eps": float(self.cfg.eps),
               "staleness": int(self.version - lease.version)}
        if mask is not None:
            rec["mask"] = np.asarray(mask,
                                     np.float32).reshape(-1).tolist()
        # apply THROUGH the replay path, out of place: live params
        # advance by exactly the arithmetic a later replay of this record
        # re-executes, and no leased snapshot is written
        self.params, _ = replay_into(self.params, [rec], self.cfg)
        self.version += 1
        self._applied.add(lease.step)
        self._inflight.pop(lease.step, None)
        self.records.append(rec)
        if loss is not None:
            self.losses.append(float(loss))
        if self.log is not None:
            self.log.append(rec["step"], rec["seed"], rec["gs"],
                            rec["lr"], rec["eps"], mask=rec.get("mask"),
                            staleness=rec["staleness"])
        return True

    def _observe(self, worker: int, latency: float):
        if worker not in self._roster:
            return                      # delivery from a departed worker
        vec = (self.policy.ema_latencies if self.policy.seen
               else np.full(self.policy.total, latency))
        vec[self._roster.index(worker)] = latency
        self.policy.observe(vec)

    # ---- elastic resize -------------------------------------------------
    def worker_join(self, now: float) -> int:
        """Admit a new worker mid-round: grow the straggler policy
        (seeding the newcomer's EMA with the fleet median) and move
        params onto the resized mesh. Returns the new worker id."""
        wid = self._next_wid
        self._next_wid += 1
        carried = (np.append(self.policy.ema_latencies,
                             np.median(self.policy.ema_latencies))
                   if self.policy.seen else None)
        self._roster.append(wid)
        self._resize(carried)
        return wid

    def worker_leave(self, wid: int, now: float):
        """Retire a worker: orphan its in-flight leases (their steps go
        back on the re-issue queue), shrink the policy, re-mesh."""
        if wid not in self._roster:
            raise ValueError(f"worker {wid} is not in the roster "
                             f"{self._roster}")
        idx = self._roster.index(wid)
        carried = (np.delete(self.policy.ema_latencies, idx)
                   if self.policy.seen and len(self._roster) > 1 else None)
        self._roster.remove(wid)
        for step, leases in self._inflight.items():
            if step in self._applied:
                continue
            for lease in leases:
                if lease.worker == wid:
                    lease.expired = True
            if (all(lease.expired for lease in leases)
                    and step not in self._reissue):
                self._reissue.append(step)
        self._resize(carried)

    def _resize(self, carried_latencies: Optional[np.ndarray]):
        self.policy = StragglerPolicy(max(len(self._roster), 1),
                                      deadline_factor=self.deadline_factor,
                                      ema=self.ema)
        if carried_latencies is not None and len(self._roster):
            self.policy.observe(carried_latencies)
        if self.remesh:
            # the param move of a pod resize: values untouched (on the
            # params' one device, no copy), so the replay-log contract
            # survives the resize
            dev = next(iter(self.params.values())).device
            mesh = elastic_mesh([dev], model_parallel=1, data_parallel=1)
            self.params = remesh_params(self.params, mesh)
        self.resizes += 1

    def close(self):
        if self.log is not None:
            self.log.close()


# ---------------------------------------------------------------------------
# the in-process worker pool (deterministic discrete-event simulation)


@dataclasses.dataclass
class FleetReport:
    applied: int
    issued: int                      # leases handed out (re-issues incl.)
    reissued: int
    dropped: int                     # late/duplicate deliveries discarded
    resizes: int
    virtual_s: float                 # modeled fleet makespan
    wall_s: float
    losses: List[float]              # at-eval loss per applied update
    staleness: List[int]             # per applied update, apply order
    records: List[dict]
    params: Params
    max_live_versions: int = 1       # most parameter versions held at once

    @property
    def virtual_steps_per_s(self) -> float:
        return self.applied / self.virtual_s if self.virtual_s else 0.0


@dataclasses.dataclass
class _SimWorker:
    wid: int
    spec: WorkerSpec
    grade: DeviceGrade
    alive: bool = True
    lease: Optional[DirectionLease] = None
    deliveries: int = 0


class FleetSim:
    """Deterministic event-driven fleet: virtual-time worker pool around
    a :class:`FleetCoordinator`.

    ``batches``: step -> host batch dict (every worker evaluating step t
    sees the same batch -- a re-issued lease differs only in its params
    snapshot). ``events``: scheduled elastic events, ``("join", t,
    WorkerSpec)`` / ``("leave", t, wid)`` at virtual time ``t``;
    per-worker ``FaultSpec.die_at`` deaths are leave events that also
    discard the worker's in-flight result. ``step_events`` are the
    applied-count-triggered form -- ``(after_applied, kind, payload)``
    fires as soon as ``after_applied`` updates have been applied.

    ``params`` is theta_0 (e.g. the JAX package's parameters); without
    it the model's seeded random init on ``device``. ``base_params``
    keeps theta_0: the coordinator never writes it.
    """

    def __init__(self, model_cfg, workers: Sequence[WorkerSpec], *,
                 total_steps: int, mezo_cfg: Optional[MezoConfig] = None,
                 batches: Optional[Callable[[int], dict]] = None,
                 batch: int = 2, seq: int = 16, seed: int = 0,
                 estimator: str = "fused", deadline_factor: float = 3.0,
                 ema: float = 0.9, log_path: Optional[str] = None,
                 events: Sequence[Tuple] = (),
                 step_events: Sequence[Tuple] = (), remesh: bool = True,
                 params: Optional[Params] = None, device: str = "cuda"):
        from repro_torch.models import build_model

        if not workers:
            raise ValueError("FleetSim needs at least one worker")
        strat = build_strategy(estimator, "stale-sgd")
        if not strat.estimator.pristine:
            raise ValueError(
                f"fleet workers share params snapshots by reference and "
                f"need a pristine direction estimator (vmapdir/fused), "
                f"got {estimator!r}: the in-place walk would corrupt "
                f"co-leased snapshots")
        self._eval_fn = strat.estimator.eval_fn
        self.model_cfg = model_cfg
        self.model = build_model(model_cfg)
        self.cfg = mezo_cfg or MezoConfig()
        self.seed = seed
        self.device = resolve_device(device)
        self.base_params = (params if params is not None else
                            self.model.init(torch.Generator(
                                device=self.device).manual_seed(seed),
                                self.device))
        self.batches = batches or default_batches(model_cfg, batch, seq,
                                                  seed)
        b0 = self.batches(0)
        first = b0.get("tokens", next(iter(b0.values())))
        self.n_tokens = int(np.asarray(first).size)
        self.coord = FleetCoordinator(
            self.base_params, self.cfg, total_steps=total_steps,
            n_workers=len(workers), seed=seed,
            deadline_factor=deadline_factor, ema=ema, log_path=log_path,
            remesh=remesh)
        self.workers: Dict[int, _SimWorker] = {
            i: _SimWorker(i, spec, get_grade(spec.grade))
            for i, spec in enumerate(workers)}
        self._heap: list = []
        self._seq = 0
        self._events = list(events)
        self._step_events = sorted(step_events, key=lambda e: e[0])
        self.max_live_versions = 1

    # ---- event plumbing -------------------------------------------------
    def _push(self, at: float, kind: str, payload):
        heapq.heappush(self._heap, (at, self._seq, kind, payload))
        self._seq += 1

    def _live_versions(self) -> int:
        """Parameter versions still referenced: the head, every lease in
        flight, and every lease a pending delivery holds (a dead worker's
        result and a transport duplicate keep theirs until popped)."""
        held = {self.coord.version}
        held |= {lease.version for leases in self.coord._inflight.values()
                 for lease in leases}
        held |= {payload[1].version for _, _, kind, payload in self._heap
                 if kind in ("done", "done_dup")}
        return len(held)

    def _latency(self, w: _SimWorker, lease: DirectionLease) -> float:
        base = lease_latency_s(self.model_cfg, w.grade, self.n_tokens,
                               lease.k)
        u = np.random.default_rng(
            (self.seed, w.wid, lease.step)).uniform(-1.0, 1.0)
        return base * w.spec.faults.latency_scale * (
            1.0 + w.spec.faults.jitter * u)

    def _assign(self, now: float):
        for w in self.workers.values():
            if not w.alive or w.lease is not None:
                continue
            lease = self.coord.next_lease(w.wid, now)
            if lease is None:
                continue
            w.lease = lease
            done_at = now + self._latency(w, lease)
            self._push(done_at, "done", (w.wid, lease))
            budget = self.coord.policy.deadline()
            if not math.isinf(budget):
                # a timer so idle workers pick up the re-issue the
                # moment the lease goes overdue, not at the next
                # unrelated delivery
                self._push(lease.issued_at + budget * 1.001, "expire",
                           None)

    def _evaluate(self, w: _SimWorker, lease: DirectionLease):
        """One lease's device work: K perturbed-forward pairs against the
        lease's snapshot -> ((K,) gs on the host, mask, mean loss)."""
        # the default batches are slices of one (B, S + 1) draw: each is
        # made contiguous on the host before it moves
        batch = {k: torch.as_tensor(np.ascontiguousarray(v)).to(self.device)
                 for k, v in self.batches(lease.step).items()}
        _, gs, ls = self._eval_fn(self.model.loss, lease.params, batch,
                                  lease.seed, self.cfg,
                                  eps=_f32(None, self.cfg.eps))
        gs = gs.to("cpu").numpy().astype(np.float32)
        mask = None
        d = w.spec.faults.drop_directions
        if d:
            mask = np.ones(lease.k, np.float32)
            mask[lease.k - min(d, lease.k - 1):] = 0.0
        return gs, mask, float(ls.mean())

    # ---- event handlers -------------------------------------------------
    def _on_done(self, now: float, wid: int, lease: DirectionLease,
                 result=None):
        w = self.workers.get(wid)
        if w is None or not w.alive:
            return                            # died while computing
        if result is None:                    # first delivery: evaluate
            if w.lease is not lease:
                return                        # stale event (superseded)
            w.lease = None
            result = self._evaluate(w, lease)
            w.deliveries += 1
            dup = w.spec.faults.duplicate_every
            if dup and w.deliveries % dup == 0:
                # the transport delivers the same result again shortly
                # (a fraction of this worker's own lease latency, so the
                # dup lands among other deliveries at any model scale)
                self._push(now + 0.1 * self._latency(w, lease),
                           "done_dup", (wid, lease, result))
        gs, mask, loss = result
        self.coord.submit(lease, gs, now, mask=mask, loss=loss)

    def _on_leave(self, now: float, wid: int):
        w = self.workers.get(wid)
        if w is None or not w.alive:
            return
        w.alive = False
        w.lease = None
        self.coord.worker_leave(wid, now)

    def _on_join(self, now: float, spec: WorkerSpec):
        wid = self.coord.worker_join(now)
        self.workers[wid] = _SimWorker(wid, spec, get_grade(spec.grade))
        if spec.faults.die_at is not None:
            self._push(spec.faults.die_at, "leave", wid)

    # ---- the run --------------------------------------------------------
    def run(self) -> FleetReport:
        t0 = time.perf_counter()
        now = 0.0
        for ev in self._events:
            kind, at, payload = ev
            if kind not in ("join", "leave"):
                raise ValueError(f"unknown fleet event kind {kind!r}; "
                                 f"expected ('join'|'leave', time, "
                                 f"payload)")
            self._push(float(at), kind, payload)
        for after, kind, _ in self._step_events:
            if kind not in ("join", "leave"):
                raise ValueError(f"unknown fleet step-event kind "
                                 f"{kind!r}; expected (after_applied, "
                                 f"'join'|'leave', payload)")
            if after >= self.coord.total_steps:
                raise ValueError(
                    f"step event at after_applied={after} can never "
                    f"fire: the run applies {self.coord.total_steps} "
                    f"update(s) and stops")
        for w in self.workers.values():
            if w.spec.faults.die_at is not None:
                self._push(w.spec.faults.die_at, "leave", w.wid)
        self._assign(now)
        while not self.coord.done():
            if not self._heap:
                raise RuntimeError(
                    f"fleet stalled at t={now:.3f}s with "
                    f"{len(self.coord._applied)}/{self.coord.total_steps}"
                    f" steps applied and no live workers or pending "
                    f"events")
            now, _, kind, payload = heapq.heappop(self._heap)
            if kind == "done":
                self._on_done(now, *payload)
            elif kind == "done_dup":
                self._on_done(now, payload[0], payload[1],
                              result=payload[2])
            elif kind == "leave":
                self._on_leave(now, payload)
            elif kind == "join":
                self._on_join(now, payload)
            # "expire" carries no payload: expiry is re-checked inside
            # next_lease; the event just forces an assignment pass
            while (self._step_events and
                   len(self.coord._applied) >= self._step_events[0][0]):
                _, ekind, payload = self._step_events.pop(0)
                if ekind == "join":
                    self._on_join(now, payload)
                else:
                    self._on_leave(now, payload)
            self._assign(now)
            self.max_live_versions = max(self.max_live_versions,
                                         self._live_versions())
        self.coord.close()
        c = self.coord
        return FleetReport(
            applied=len(c._applied), issued=c._issued + c.reissued,
            reissued=c.reissued, dropped=c.dropped, resizes=c.resizes,
            virtual_s=now, wall_s=time.perf_counter() - t0,
            losses=list(c.losses),
            staleness=[r["staleness"] for r in c.records],
            records=list(c.records), params=c.params,
            max_live_versions=self.max_live_versions)


def default_batches(model_cfg, batch: int, seq: int, seed: int
                    ) -> Callable[[int], dict]:
    """Deterministic step-indexed LM batches (numpy, the reference's
    stream): every worker evaluating step t draws the identical batch,
    so a re-issued lease's gs differs only through its params
    snapshot."""
    def fn(step: int):
        rng = np.random.default_rng((seed, step))
        toks = rng.integers(0, model_cfg.vocab, (batch, seq + 1),
                            dtype=np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                "loss_mask": np.ones((batch, seq), np.float32)}
    return fn

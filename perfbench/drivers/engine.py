"""Many users' fine-tunes over one base through
``repro_torch.train.engine.TrainEngine`` (``launch/train_fleet.py``'s
path): ``slots`` lanes a dispatch, each job a new user.

Jobs: job ``j`` is user ``u<seed>-<j>`` (its seed derived by the engine
from the run's seed and the name) with a step target from the
workload's ``min_steps..max_steps``: each block of consecutive jobs
takes every target of that range once, in an order drawn from the seed,
so every seed runs the same set of job sizes. User-step ``t`` of job
``j`` reads batch ``t`` of the traffic stream ``j + 1``. A closed loop
keeps ``waiting`` jobs queued behind the slots at every dispatch (it
tops the queue up to ``waiting + slots`` before each), so admissions
and flushes spread over the window.

Set-up runs the engine's first three dispatches, which admit jobs
``0..slots-1`` into slots ``0..slots-1``; the reference follows
``check_lanes`` of those lanes, drawn from the seed, as lone users
(losses and gs; and each leaf's change after one and after three steps
against the update replayed with the lane's own gs). Once
the window has closed, the reference also follows ``check_reused`` jobs
drawn from the seed among those admitted into a slot that an earlier
job had freed (job ``slots`` on) and finished: their first three steps'
losses and the gs of their flushed replay records (``reused_loss_gap``).
Where none has finished by the window's close (with jobs of more steps
than set-up's dispatches none finishes before it), the engine runs on,
untimed, until one has. Every job that
finishes is also checked record by record: its flushed replay log must
hold steps ``0..n-1`` with the seed schedule of its user and a finite
gs.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench import compare, flops
from perfbench.drivers.trainer import FIRST_STEPS, TIMED_STEPS, Probe, \
    _f32, sync
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train
from perfbench.reference import zhash
from perfbench.traffic import make_batch, stream_seed


class Driver:
    def __init__(self, cell, seed: int, device, seconds: float):
        self.cell, self.seed = cell, int(seed)
        self.device, self.seconds = torch.device(device), seconds
        wl = cell.workload
        self.traffic, self.slots = wl["traffic"], int(wl["slots"])
        self.jobs_spec = wl["jobs"]
        self.n_jobs = 0
        self.results = []
        rng = np.random.default_rng(stream_seed(self.seed, 0, 10 ** 6))
        self.lanes = sorted(int(i) for i in rng.choice(
            self.slots, int(wl["check_lanes"]), replace=False))
        self.n_reused = int(wl["check_reused"])
        self.reused = []            # the re-used slots' jobs followed
        self.marks = []             # (set-up part, host clock at its end)

    def mark(self, part: str) -> None:
        sync(self.device)
        self.marks.append((part, time.perf_counter()))

    # -- jobs ------------------------------------------------------------------
    def _target(self, j: int) -> int:
        lo, hi = int(self.jobs_spec["min_steps"]), int(
            self.jobs_spec["max_steps"])
        span = hi - lo + 1
        order = np.random.default_rng(
            stream_seed(self.seed, 0, j // span)).permutation(span)
        return lo + int(order[j % span])

    def user(self, j: int) -> str:
        return f"u{self.seed}-{j}"

    @staticmethod
    def job_of(res) -> int:
        return int(res.user.rsplit("-", 1)[1])

    def batches(self, j: int):
        m = self.cell.model

        def at(step: int):
            return make_batch(self.traffic, m["vocab"], m.get("n_classes", 0),
                              self.seed, step, "cpu", stream=j + 1)
        return at

    def _top_up(self) -> None:
        want = int(self.jobs_spec["waiting"]) + self.slots
        while len(self.engine.queue) < want:
            j = self.n_jobs
            self.engine.submit(self.TrainJob(user=self.user(j),
                                             batches=self.batches(j),
                                             n_steps=self._target(j)))
            self.n_jobs += 1

    def _dispatch(self, n: int) -> None:
        for _ in range(n):
            self._top_up()
            self.engine.step()
            self.results.extend(self.engine.drain_results())

    # -- the program ---------------------------------------------------------
    def setup(self, size_window: bool = True) -> int:
        from repro_torch.core.engine import MezoConfig, build_strategy
        from repro_torch.models.config import ModelConfig
        from repro_torch.serve.adapters import AdapterStore
        from repro_torch.train.engine import TrainEngine, TrainJob
        self.TrainJob = TrainJob
        mz = self.cell.mezo
        mcfg = MezoConfig(eps=mz["eps"], lr=mz["lr"],
                          n_directions=mz["n_directions"], dist=mz["dist"])
        est = self.cell.workload["estimator"]
        self.params = ref_model.make_params(self.cell.model, self.seed,
                                            self.device)
        self.mark("weights")
        store = AdapterStore(self.params, mezo_cfg=mcfg,
                             update_rule=build_strategy(est, "sgd").update,
                             device=self.device)
        self.engine = TrainEngine(ModelConfig(**self.cell.model), store,
                                  n_slots=self.slots, estimator=est,
                                  update="sgd", seed=self.seed,
                                  mezo_cfg=mcfg)
        self.mark("program")
        lr = _f32(mz["lr"])
        reads = {i: {"losses": [], "gs": []} for i in self.lanes}
        last = {}

        def lane(params, i):
            return {p: t[i] for p, t in params.items()}

        def after_dispatch(state, aux):
            last["params"] = state.params
            for i in self.lanes:
                reads[i]["losses"].append(float(aux.loss[i]))
                reads[i]["gs"].append([float(g) for g in aux.gs[i]])
                if "grad" not in reads[i]:
                    reads[i]["grad"] = {p: v / lr for p, v in ref_train
                                        .change_norms(self.params,
                                                      lane(state.params, i))
                                        .items()}

        inner = self.engine.strategy
        self.engine.strategy = Probe(inner, after_dispatch)
        self._dispatch(FIRST_STEPS)
        self.engine.strategy = inner
        for i in self.lanes:
            reads[i]["change"] = ref_train.change_norms(
                self.params, lane(last["params"], i))
        self.readings = reads
        del last
        self.mark("first steps")
        if not size_window:
            return 0
        t0 = self.marks[-1][1]
        self._dispatch(TIMED_STEPS)
        self.mark("sizing")
        return max(1, round(self.seconds / (
            (self.marks[-1][1] - t0) / TIMED_STEPS)))

    def window(self, n: int) -> dict:
        b, s = int(self.traffic["batch"]), int(self.traffic["seq"])
        model, mz = self.cell.model, self.cell.mezo
        st = self.engine.stats
        before = (st.user_steps, st.admitted, st.finished)
        self._dispatch(n)
        user_steps = st.user_steps - before[0]
        self.engine_counts = {"dispatches": n, "user_steps": user_steps,
                              "n_slots": self.slots,
                              "admitted": st.admitted - before[1],
                              "finished": st.finished - before[2]}
        k = int(mz["n_directions"])
        lanes = 2 * self.slots
        return {
            "steps": user_steps, "dispatches": n, "tokens": user_steps * b * s,
            "flops": user_steps * flops.step_flops(model, mz, b, s),
            "zo_matmul_bound_s": n * k * flops.zo_matmul_bound_s(
                model, mz, b, s, lanes=lanes, weights=self.slots),
            "zo_add_bytes": flops.zo_add_bytes_users(
                model, mz, n, user_steps, lanes)}

    def counters(self) -> dict:
        return {"engine": self.engine_counts}

    def _reused_jobs(self) -> dict:
        """Finished jobs admitted into a freed slot, by job index."""
        return {self.job_of(r): r for r in self.results
                if self.job_of(r) >= self.slots
                and r.n_steps >= FIRST_STEPS}

    def program_readings(self) -> dict:
        limit = 4 * int(self.jobs_spec["max_steps"])
        while len(self._reused_jobs()) < self.n_reused and limit > 0:
            self._dispatch(1)
            limit -= 1
        done = self._reused_jobs()
        rng = np.random.default_rng(stream_seed(self.seed, 0, 10 ** 6 + 1))
        self.reused = sorted(int(j) for j in rng.choice(
            sorted(done), min(self.n_reused, len(done)), replace=False))
        reused = {j: {"losses": done[j].losses[:FIRST_STEPS],
                      "gs": [r["gs"] for r in done[j].records[:FIRST_STEPS]]}
                  for j in self.reused}
        return {"lanes": self.readings, "reused": reused,
                "records_bad": self._records_bad(self.results)}

    def _records_bad(self, results) -> int:
        """Records of the finished jobs that break their user's log: a
        missing or extra step, a seed off the user's schedule, or a gs
        that is not finite."""
        bad = 0
        for res in results:
            j = self.job_of(res)
            useed = zhash.fold_seed(self.seed, zhash.salt(res.user))
            recs = res.records
            bad += abs(len(recs) - self._target(j))
            for t, rec in enumerate(recs):
                ok = (rec["step"] == t
                      and rec["seed"] == zhash.fold_seed(useed, t)
                      and all(math.isfinite(g) for g in rec["gs"]))
                bad += 0 if ok else 1
        return bad

    def numbers(self, prog: dict, ref: dict, upd: dict) -> dict:
        eps = _f32(self.cell.mezo["eps"])
        out = {}
        for i, r in ref["lanes"].items():
            for name, v in compare.training_numbers(
                    prog["lanes"][i], r, eps, upd["lanes"][i]).items():
                out[name] = max(out.get(name, 0.0), v)
        # a re-used slot's job that never finished is an answer that never
        # came: no reading, so the number is infinite
        out["reused_loss_gap"] = max(
            [compare.loss_gap(prog["reused"][j], r, eps)
             for j, r in ref["reused"].items()]
            + [0.0 if len(ref["reused"]) >= self.n_reused else math.inf])
        out["records_bad"] = float(prog["records_bad"])
        return out

    def free(self) -> None:
        del self.engine, self.params

    # -- the reference -------------------------------------------------------
    def reference_readings(self, precision: str = "f32",
                           half_batch: bool = False) -> dict:
        base = ref_model.make_params(self.cell.model, self.seed,
                                     self.device)
        def lone(j):
            at = self.batches(j)
            batches = [{k: v.to(self.device) for k, v in at(t).items()}
                       for t in range(FIRST_STEPS)]
            useed = zhash.fold_seed(self.seed, zhash.salt(self.user(j)))
            params = {p: t.clone() for p, t in base.items()}
            out = ref_train.follow(
                self.cell.model, self.cell.mezo, params, batches, useed,
                self.cell.workload["estimator"], precision, half_batch)
            del params
            return out
        return {"lanes": {i: lone(i) for i in self.lanes},
                "reused": {j: lone(j) for j in self.reused},
                "records_bad": 0}

    def update_readings(self, side: dict) -> dict:
        """The reference's update replayed with each lane's gs in
        ``side``."""
        base = ref_model.make_params(self.cell.model, self.seed,
                                     self.device)
        lanes = {}
        for i in self.lanes:
            params = {p: t.clone() for p, t in base.items()}
            useed = zhash.fold_seed(self.seed, zhash.salt(self.user(i)))
            lanes[i] = ref_train.replay(
                self.cell.mezo, params, side["lanes"][i]["gs"], useed,
                self.cell.workload["estimator"])
            del params
        return {"lanes": lanes}

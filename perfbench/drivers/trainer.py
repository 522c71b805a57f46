"""One user's fine-tune through ``repro_torch.runtime.trainer.Trainer``,
the path under ``launch/train.py``.

Set-up builds one ``Trainer`` over the benchmark's weights and feed,
runs its first three steps through ``Trainer.train(params=)`` (the
reference follows them: losses, and each leaf's change after the first
and after the third step), then times two more to size the window. The
window is ``Trainer.train(params=)`` again on the same object, ``n``
whole steps. No checkpoint directory: a snapshot of the weights would
write gigabytes a run.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from perfbench import compare, flops
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train
from perfbench.traffic import Feed

FIRST_STEPS = 3        # the steps the reference follows
TIMED_STEPS = 2        # the steps that size the window


class Probe:
    """A strategy with a call after each step or user-axis dispatch, for
    set-up's first steps (the window runs the strategy itself)."""

    def __init__(self, inner, on_step):
        self.inner, self.on_step = inner, on_step

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def step(self, *args, **kwargs):
        state, aux = self.inner.step(*args, **kwargs)
        self.on_step(state, aux)
        return state, aux

    def step_users(self, *args, **kwargs):
        state, aux = self.inner.step_users(*args, **kwargs)
        self.on_step(state, aux)
        return state, aux


def _f32(x) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    def __init__(self, cell, seed: int, device, seconds: float):
        self.cell, self.seed = cell, int(seed)
        self.device, self.seconds = torch.device(device), seconds
        self.traffic = cell.workload["traffic"]
        self.estimator = cell.workload["estimator"]
        m = cell.model
        self.feed_args = (self.traffic, m["vocab"], m.get("n_classes", 0),
                          self.seed, self.device)
        self.marks = []             # (set-up part, host clock at its end)

    def mark(self, part: str) -> None:
        sync(self.device)
        self.marks.append((part, time.perf_counter()))

    # -- the program ---------------------------------------------------------
    def setup(self, size_window: bool = True) -> int:
        from repro_torch.core.engine import MezoConfig
        from repro_torch.models.config import ModelConfig
        from repro_torch.runtime.trainer import Trainer, TrainerConfig
        mz = self.cell.mezo
        tcfg = TrainerConfig(
            estimator=self.estimator, update="sgd",
            mezo=MezoConfig(eps=mz["eps"], lr=mz["lr"],
                            n_directions=mz["n_directions"],
                            dist=mz["dist"]),
            n_steps=FIRST_STEPS, seed=self.seed, ckpt_dir=None,
            log_every=10 ** 9, device=str(self.device))
        self.trainer = Trainer(ModelConfig(**self.cell.model), tcfg,
                               Feed(*self.feed_args), log_fn=lambda s: None)
        self.mark("program")
        self.params = ref_model.make_params(self.cell.model, self.seed,
                                            self.device)
        self.mark("weights")
        theta0 = {p: t.clone() for p, t in self.params.items()}
        lr = _f32(mz["lr"])
        first, gs = {}, []

        def after_step(state, aux):
            gs.append([float(g) for g in aux.gs.reshape(-1)])
            if "grad" not in first:
                first["grad"] = {p: v / lr for p, v in ref_train
                                 .change_norms(theta0, state.params)
                                 .items()}

        inner = self.trainer.strategy
        self.trainer.strategy = Probe(inner, after_step)
        self.trainer.train(params=self.params)
        self.trainer.strategy = inner
        self.readings = {
            "losses": list(self.trainer.losses[:FIRST_STEPS]), "gs": gs,
            "grad": first["grad"],
            "change": ref_train.change_norms(theta0, self.params)}
        del theta0
        self.mark("first steps")
        if not size_window:
            return 0
        t0 = self.marks[-1][1]
        self._train(TIMED_STEPS)
        self.mark("sizing")
        step_s = (self.marks[-1][1] - t0) / TIMED_STEPS
        return max(1, round(self.seconds / step_s))

    def _train(self, n: int) -> None:
        self.trainer.tcfg = dataclasses.replace(self.trainer.tcfg, n_steps=n)
        self.trainer.train(params=self.params)

    def window(self, n: int) -> dict:
        b, s = int(self.traffic["batch"]), int(self.traffic["seq"])
        model, mz = self.cell.model, self.cell.mezo
        self._train(n)
        k = int(mz["n_directions"])
        fused = self.estimator == "fused"
        return {
            "steps": n, "tokens": n * b * s,
            "flops": n * flops.step_flops(model, mz, b, s),
            "zo_matmul_bound_s": (n * 2 * k * flops.zo_matmul_bound_s(
                model, mz, b, s) if fused else 0.0),
            "zo_add_bytes": n * flops.zo_add_bytes_per_step(
                model, mz, self.estimator)}

    def counters(self) -> dict:
        return {}

    def program_readings(self) -> dict:
        return self.readings

    def numbers(self, prog: dict, ref: dict, upd: dict) -> dict:
        return compare.training_numbers(prog, ref,
                                        _f32(self.cell.mezo["eps"]), upd)

    def free(self) -> None:
        del self.trainer, self.params

    # -- the reference -------------------------------------------------------
    def reference_readings(self, precision: str = "f32",
                           half_batch: bool = False) -> dict:
        params = ref_model.make_params(self.cell.model, self.seed,
                                       self.device)
        feed = Feed(*self.feed_args)
        batches = [feed.batch(i) for i in range(FIRST_STEPS)]
        out = ref_train.follow(self.cell.model, self.cell.mezo, params,
                               batches, self.seed, self.estimator,
                               precision, half_batch)
        del params
        return out

    def update_readings(self, side: dict) -> dict:
        """The reference's update replayed with ``side``'s gs."""
        params = ref_model.make_params(self.cell.model, self.seed,
                                       self.device)
        out = ref_train.replay(self.cell.mezo, params, side["gs"],
                               self.seed, self.estimator)
        del params
        return out

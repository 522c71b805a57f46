"""One user's fine-tune of the Jamba hybrid through
``repro_torch.runtime.trainer.Trainer``, the path under
``launch/train.py``, held to the plain Jamba reference
(``reference/jamba.py``).

As ``drivers/trainer.py``, with what 26e9 parameters on one card ask for:
no copy of the weights is kept (the change norms draw the initial weights
again from ``--seed``, a leaf at a time), the reference takes both signs
of a direction in one forward, and the set-up's first steps record the
program's routing (``models.moe.ROUTES``) for the reference to settle
near ties by: the assignments it takes from the program there
(``route_taken``) and those it still routes elsewhere (``route_flips``)
are printed on standard error. The window counts the program's MoE rows and assignments
(``core.spans.COUNTS``) and reports the work of ``flops_hybrid.py``.
"""

from __future__ import annotations

import sys

from perfbench import compare, flops_hybrid
from perfbench.drivers import trainer
from perfbench.drivers.trainer import FIRST_STEPS, TIMED_STEPS, Probe, _f32
from perfbench.reference import jamba as ref
from perfbench.traffic import Feed


class Driver(trainer.Driver):
    routes = None           # the program's routes of its first steps

    def setup(self, size_window: bool = True) -> int:
        from repro_torch.core.engine import MezoConfig
        from repro_torch.models import moe
        from repro_torch.models.config import ModelConfig
        from repro_torch.runtime.trainer import Trainer, TrainerConfig
        mz, model = self.cell.mezo, self.cell.model
        tcfg = TrainerConfig(
            estimator=self.estimator, update="sgd",
            mezo=MezoConfig(eps=mz["eps"], lr=mz["lr"],
                            n_directions=mz["n_directions"],
                            dist=mz["dist"]),
            n_steps=FIRST_STEPS, seed=self.seed, ckpt_dir=None,
            log_every=10 ** 9, device=str(self.device))
        self.trainer = Trainer(ModelConfig(**model), tcfg,
                               Feed(*self.feed_args), log_fn=lambda s: None)
        self.mark("program")
        self.params = ref.make_params(model, self.seed, self.device)
        self.mark("weights")
        lr = _f32(mz["lr"])
        first, gs = {}, []

        def after_step(state, aux):
            gs.append([float(g) for g in aux.gs.reshape(-1)])
            if "grad" not in first:
                first["grad"] = {p: v / lr for p, v in ref.change_norms(
                    model, self.seed, state.params).items()}

        inner = self.trainer.strategy
        self.trainer.strategy = Probe(inner, after_step)
        moe.ROUTES = []
        try:
            self.trainer.train(params=self.params)
            routes = moe.ROUTES
        finally:
            moe.ROUTES = None
            self.trainer.strategy = inner
        self.routes = _split_routes(routes, FIRST_STEPS,
                                    int(mz["n_directions"]))
        self.readings = {
            "losses": list(self.trainer.losses[:FIRST_STEPS]), "gs": gs,
            "grad": first["grad"],
            "change": ref.change_norms(model, self.seed, self.params)}
        self.mark("first steps")
        if not size_window:
            return 0
        t0 = self.marks[-1][1]
        self._train(TIMED_STEPS)
        self.mark("sizing")
        step_s = (self.marks[-1][1] - t0) / TIMED_STEPS
        return max(1, round(self.seconds / step_s))

    def window(self, n: int) -> dict:
        from repro_torch.kernels import ops
        b, s = int(self.traffic["batch"]), int(self.traffic["seq"])
        model, mz = self.cell.model, self.cell.mezo
        ops.reset_launches()
        self._train(n)
        k = int(mz["n_directions"])
        return {
            "steps": n, "tokens": n * b * s,
            "flops": n * flops_hybrid.step_flops(model, mz, b, s),
            "zo_matmul_bound_s": n * 2 * k * flops_hybrid.zo_matmul_bound_s(
                model, mz, b, s),
            "selective_scan_bound_s": n * 2 * k
            * flops_hybrid.selective_scan_bound_s(model, b, s)}

    def counters(self) -> dict:
        from repro_torch.core import spans
        from repro_torch.kernels import ops
        counts = getattr(spans, "COUNTS", {})
        return {"moe": {k.split(".", 1)[1]: v for k, v in counts.items()
                        if k.startswith("moe.")},
                "launches": dict(ops.LAUNCHES)}

    def numbers(self, prog: dict, ref_side: dict, upd: dict) -> dict:
        out = compare.training_numbers(prog, ref_side,
                                       _f32(self.cell.mezo["eps"]), upd)
        for name in ("taken", "flips"):
            per = ref_side.get(name)
            if per:
                out[f"route_{name}"] = sum(sum(f) for f in per)
                print(f"[perfbench] routing {name} (+eps, -eps) a step: "
                      f"{per}", file=sys.stderr)
        return out

    # -- the reference -------------------------------------------------------
    def reference_readings(self, precision: str = "f32",
                           half_batch: bool = False) -> dict:
        params = ref.make_params(self.cell.model, self.seed, self.device)
        feed = Feed(*self.feed_args)
        batches = [feed.batch(i) for i in range(FIRST_STEPS)]
        out = ref.follow(self.cell.model, self.cell.mezo, params, batches,
                         self.seed, self.seed, precision, half_batch,
                         None if half_batch else self.routes)
        del params
        return out

    def update_readings(self, side: dict) -> dict:
        params = ref.make_params(self.cell.model, self.seed, self.device)
        out = ref.replay(self.cell.model, self.cell.mezo, params, side["gs"],
                         self.seed, self.seed)
        del params
        return out


def _split_routes(routes, steps: int, k_dirs: int):
    """The program's routes of its first steps, in call order, as
    ``[step][direction][sign: +eps, -eps][MoE layer]``."""
    per = len(routes) // (steps * k_dirs * 2)
    it = iter(routes)
    return [[[[next(it) for _ in range(per)] for _ in range(2)]
             for _ in range(k_dirs)] for _ in range(steps)]

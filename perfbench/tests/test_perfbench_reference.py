"""The plain reference against the port's CPU path at tiny sizes, and
whole runs on the CPU: a sound run comes out correct, the control put in
the program's place does not, and neither does a run whose timed path
is broken underneath (a step that leaves its state unchanged, half of
each batch left out, the projected gradient altered where it is made;
in the multi-tenant cell, a flush that writes altered records and an
admission into a freed slot that reads the wrong batches).

This file imports both sides; the harness's own modules import nothing
of the port outside the drivers' set-up.
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from perfbench import bench
from perfbench.reference import model as ref_model
from perfbench.reference import zhash
from perfbench.run import run_cell

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
            vocab=128, max_seq=64)
SEED = 2 ** 32 + 77


def tiny_cell(name, dtype=None):
    """The cell at a size a CPU test holds: two layers of width 64, a
    vocabulary of 128, batches of 2 x 16, three slots of jobs of 4-6
    steps; ``dtype`` overrides the configuration's."""
    cell = bench.load_cell(name, ROOT)
    model = dict(cell.model, **TINY)
    if dtype:
        model["dtype"] = dtype
    wl = dict(cell.workload,
              traffic=dict(cell.workload["traffic"], batch=2, seq=16))
    if "slots" in wl:
        wl.update(slots=3, jobs=dict(min_steps=4, max_steps=6, waiting=2))
    return dataclasses.replace(cell, config=dict(cell.config, model=model),
                               workload=wl)


def test_zhash_matches_the_port():
    from repro_torch.core import rng
    s = zhash.direction_seed(3_000_000_123, 2)
    assert s == rng.fold_seed(rng.fold_seed(3_000_000_123, 2), 0)
    path = "blocks/mlp/w_in/w"
    full = rng.z_field(s, rng.leaf_salt(path), (3, 5, 7))
    for li in range(3):
        assert torch.equal(full[li], zhash.leaf_z(s, path, (5, 7), "cpu",
                                                  layer=li))
    ids = torch.tensor([[3, 1], [0, 4]])
    base = rng.leaf_base(s, rng.leaf_salt("embed/tok"))
    assert torch.equal(rng.z_rows(base, ids, 6),
                       zhash.leaf_z(s, "embed/tok", (10, 6), "cpu", rows=ids))


@pytest.mark.parametrize("config", ["opt-1.3b", "roberta-large"])
def test_param_spec_is_the_ports_tree(config):
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import param_shapes
    cell = next(bench.load_cell(c, ROOT) for c in CELLS
                if c.startswith(config))
    ours = ref_model.param_spec(cell.model)
    port = param_shapes(ModelConfig(**cell.model))
    assert list(ours) == list(port)
    for path, (shape, dt, init) in ours.items():
        assert (shape, dt) == port[path][:2], path
        assert init == port[path][2], path


@pytest.mark.parametrize("config", ["opt-1.3b", "roberta-large"])
def test_reference_loss_matches_the_fused_forward(config):
    from repro_torch.core.perturb_ctx import PerturbCtx
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig
    cell = tiny_cell(next(c for c in CELLS if c.startswith(config)),
                     "float32")
    model = cell.model
    params = ref_model.make_params(model, SEED, "cpu")
    from perfbench.traffic import make_batch
    batch = make_batch(cell.workload["traffic"], model["vocab"],
                       model.get("n_classes", 0), SEED, 0, "cpu")
    port = build_model(ModelConfig(**model))
    seed = zhash.direction_seed(SEED, 0)
    for coeff in (1e-3, -1e-3):
        want = float(port.loss(params, batch, perturb=PerturbCtx(
            seed=seed, coeff=torch.tensor(coeff, dtype=torch.float32))))
        got = ref_model.loss(model, params, batch, seed, coeff)
        assert abs(got - want) <= 1e-5 * abs(want)
    assert abs(ref_model.loss(model, params, batch)
               - float(port.loss(params, batch))) <= 1e-5


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run_cell(tiny_cell(name, "float32"), SEED, 0.2, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in the control's precision, put in the program's
    place, breaks one of the cell's limits (in the configuration's own
    dtype)."""
    from perfbench import compare
    cell = tiny_cell(name)
    drv = bench.driver_module(cell).Driver(cell, SEED, "cpu", 0.0)
    if "slots" in cell.workload:        # follow one job of a freed slot
        drv.reused = [cell.workload["slots"]]
    ref = drv.reference_readings()
    low = drv.reference_readings(precision=cell.workload["control"])
    ok, checks = compare.verdict(drv.numbers(low, ref,
                                             drv.update_readings(low)),
                                 cell.workload["limits"])
    assert not ok, checks
    assert all(c["value"] < float("inf") for c in checks.values()), checks


def _unchanged(monkeypatch):
    from repro_torch.core import engine
    monkeypatch.setattr(engine, "_apply_direction_updates",
                        lambda params, *a, **k: params)
    monkeypatch.setattr(engine, "add_scaled_z_users",
                        lambda params, *a, **k: params)


def _half_batch(monkeypatch):
    from repro_torch.models import runtime
    ce = runtime._ce

    def half(plan, logits, batch, aux):
        n = logits.shape[0] // 2
        return ce(plan, logits[:n], {k: v[:n] for k, v in batch.items()},
                  aux)
    monkeypatch.setattr(runtime, "_ce", half)


def _gs_altered(monkeypatch):
    from repro_torch.core import engine
    projected = engine._projected

    def flipped(lp, lm, eps):
        g, l = projected(lp, lm, eps)
        return -g, l
    monkeypatch.setattr(engine, "_projected", flipped)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _gs_altered],
                         ids=["state_unchanged", "half_batch", "gs_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    r = run_cell(tiny_cell(name, "float32"), SEED, 0.2, False, "cpu")
    assert not r["correct"], r["checks"]


def _flush_altered(monkeypatch):
    """Every flush after the first writes its records' gs negated."""
    from repro_torch.train.engine import TrainEngine
    flush = TrainEngine._flush

    def altered(self, slot):
        res = flush(self, slot)
        if self.stats.finished > 0:
            for rec in res.records:
                rec["gs"] = [-g for g in rec["gs"]]
        return res
    monkeypatch.setattr(TrainEngine, "_flush", altered)


def _admitted_off_by_one(monkeypatch):
    """A job admitted once a slot has been freed reads its batches one
    step ahead."""
    from repro_torch.train.engine import TrainEngine
    batch_at = TrainEngine._batch_at

    def ahead(self, job, step):
        late = int(job.user.rsplit("-", 1)[1]) >= self.n_slots
        return batch_at(self, job, step + 1 if late else step)
    monkeypatch.setattr(TrainEngine, "_batch_at", ahead)


@pytest.mark.parametrize("fault", [_flush_altered, _admitted_off_by_one],
                         ids=["flush_altered", "admitted_off_by_one"])
def test_broken_reused_slot_is_not_correct(fault, monkeypatch):
    """Faults that touch only jobs admitted into a freed slot: the set-up
    lanes and the record schedule stay within their limits, and the
    re-used slot's job, followed by the reference, does not."""
    fault(monkeypatch)
    cell = tiny_cell("opt-1.3b.tenants-8x4s256", "float32")
    r = run_cell(cell, SEED, 0.2, False, "cpu")
    assert not r["correct"], r["checks"]
    for name, c in r["checks"].items():
        assert (c["value"] > c["limit"]) == (name == "reused_loss_gap"), \
            r["checks"]

"""Port parity: the multi-tenant (user-axis) step of the MoE and the
encoder-decoder families (reduced, f32, the JAX package's init).

* granite-moe-1b-a400m through the port's ``train_fleet`` CLI against
  ``repro.launch.train_fleet`` with the same argv (3 users on 2 slots):
  per-user losses within 1e-5, gs within 1e-3, the same steps, seeds, lr
  and eps; every lane of the port's engine bit for bit a lone port
  ``Trainer`` with the derived seed (losses, parameters, replay-log
  bytes); replay logs crossing both packages at atol 0;
* a capacity that drops assignments, with staggered admissions (ragged
  targets, a user admitted while another is mid-run): every MoE dispatch
  of the engine routes one lane's B * S tokens against that lane's own
  capacity, some lane drops past it, the lanes still equal lone Trainers
  at atol 0, and the same tokens dispatched with another lane's (shared
  capacity) would give other outputs;
* whisper-base through the ``TrainEngine`` with batches that carry
  ``enc_embeds`` (the CLIs make none): lanes against lone Trainers.

The recurrent families (rwkv6-7b, jamba) are in
``test_torch_user_axis_scans.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_families import (CPU, FLEET_B, FLEET_MZ, FLEET_S,  # noqa: E402
                             FLEET_SEED, assert_fleet_matches_jax,
                             assert_lanes_equal_lone_trainers,
                             assert_logs_cross, configs, enc_batches,
                             fleet_params, fleet_runs)
from repro_torch.core import MezoConfig  # noqa: E402
from repro_torch.launch.train_fleet import user_batches  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.runtime import train_multi_tenant  # noqa: E402
from repro_torch.train import TrainJob  # noqa: E402

torch.set_num_threads(1)

MOE = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def moe_fleet(tmp_path_factory):
    return fleet_runs(MOE, tmp_path_factory.mktemp("moe-fleet"))


def test_fleet_cli_matches_jax(moe_fleet):
    assert moe_fleet["torch"]["dispatches"] == 4   # 2 users, then the 3rd
    assert_fleet_matches_jax(moe_fleet)


def test_engine_lanes_bit_equal_lone_trainers(moe_fleet, tmp_path):
    cfg = configs(MOE)[1]
    assert_lanes_equal_lone_trainers(
        cfg, moe_fleet["engine"], moe_fleet["results"].values(),
        {u: user_batches(cfg, u, FLEET_B, FLEET_S, FLEET_SEED)
         for u in moe_fleet["results"]},
        lambda: fleet_params(MOE), moe_fleet["root"] / "torch", tmp_path)


def test_replay_logs_cross_packages(moe_fleet):
    assert_logs_cross(moe_fleet, MOE)


def _engine(cfg, fns, steps, params, log_dir):
    jobs = [TrainJob(user=u, batches=fns[u], n_steps=n)
            for u, n in steps.items()]
    return train_multi_tenant(cfg, jobs, n_slots=2, seed=FLEET_SEED,
                              mezo_cfg=MezoConfig(**FLEET_MZ),
                              log_dir=str(log_dir), log_fn=lambda s: None,
                              device=CPU, params=params)


def test_moe_lanes_route_with_their_own_capacity(monkeypatch, tmp_path):
    cfg = dataclasses.replace(configs(MOE)[1], capacity_factor=0.5)
    calls = []
    orig = moe.moe_apply

    def spy(cfg_, p, x):
        xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
        idx = torch.topk(torch.softmax(xf @ p["router"], -1), cfg_.topk,
                         -1).indices
        counts = torch.bincount(idx.reshape(-1), minlength=cfg_.n_experts)
        c = moe.capacity(xf.shape[0], cfg_)
        calls.append((xf.shape[0], int((counts - c).clamp(min=0).sum()),
                      p, x))
        return orig(cfg_, p, x)

    monkeypatch.setattr(moe, "moe_apply", spy)
    # ragged targets: user-c is admitted into user-a's slot while user-b
    # is mid-run
    steps = {"user-a": 1, "user-b": 3, "user-c": 2}
    fns = {u: user_batches(cfg, u, FLEET_B, FLEET_S, FLEET_SEED)
           for u in steps}
    engine, results = _engine(cfg, fns, steps, fleet_params(MOE),
                              tmp_path / "engine")
    assert engine.stats.dispatches == 3 and engine.stats.admitted == 3
    assert calls and {n for n, *_ in calls} == {FLEET_B * FLEET_S}
    dropped = [(p, x) for _, d, p, x in calls if d > 0]
    assert dropped, "no lane dropped an assignment"
    monkeypatch.setattr(moe, "moe_apply", orig)
    assert_lanes_equal_lone_trainers(
        cfg, engine, results, fns, lambda: fleet_params(MOE),
        tmp_path / "engine", tmp_path / "lone")
    # the lane's tokens after another lane's, under one shared capacity:
    # the experts the first lane filled drop more of the second's
    p, x = dropped[0]
    alone, _ = moe.moe_apply(cfg, p, x)
    shared, _ = moe.moe_apply(cfg, p, torch.cat([x, x]))
    assert not torch.equal(shared[FLEET_B:], alone)


def test_encdec_engine_lanes_bit_equal_lone_trainers(tmp_path):
    arch = "whisper-base"
    cfg = configs(arch)[1]
    steps = {f"user-{i}": 2 for i in range(3)}
    fns = {u: enc_batches(cfg, u) for u in steps}
    engine, results = _engine(cfg, fns, steps, fleet_params(arch),
                              tmp_path / "engine")
    assert engine.stats.dispatches == 4
    assert_lanes_equal_lone_trainers(
        cfg, engine, results, fns, lambda: fleet_params(arch),
        tmp_path / "engine", tmp_path / "lone")

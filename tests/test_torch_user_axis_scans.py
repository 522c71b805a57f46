"""Port parity: the multi-tenant (user-axis) step of the recurrent
families, rwkv6-7b (the WKV scan) and jamba-v0.1-52b (the selective scan,
MoE and attention), reduced, f32, from the JAX package's init.

Each through the port's ``train_fleet`` CLI against
``repro.launch.train_fleet`` with the same argv (3 users on 2 slots, the
third admitted when a slot frees): per-user losses within 1e-5, gs
within 1e-3, the same steps, seeds, lr and eps; every lane of the port's
engine bit for bit a lone port ``Trainer`` with the derived seed
(losses, parameters, replay-log bytes); replay logs crossing both
packages at atol 0.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_families import (FLEET_B, FLEET_S, FLEET_SEED,  # noqa: E402
                             assert_fleet_matches_jax,
                             assert_lanes_equal_lone_trainers,
                             assert_logs_cross, configs, fleet_params,
                             fleet_runs)
from repro_torch.launch.train_fleet import user_batches  # noqa: E402

torch.set_num_threads(1)

ARCHS = ["rwkv6-7b", "jamba-v0.1-52b"]


@pytest.fixture(scope="module", params=ARCHS)
def fleet(request, tmp_path_factory):
    """(arch, both CLIs' run of it)."""
    arch = request.param
    return arch, fleet_runs(arch, tmp_path_factory.mktemp(arch))


def test_fleet_cli_matches_jax(fleet):
    _, run = fleet
    assert run["torch"]["dispatches"] == 4
    assert_fleet_matches_jax(run)


def test_engine_lanes_bit_equal_lone_trainers(fleet, tmp_path):
    arch, run = fleet
    cfg = configs(arch)[1]
    assert_lanes_equal_lone_trainers(
        cfg, run["engine"], run["results"].values(),
        {u: user_batches(cfg, u, FLEET_B, FLEET_S, FLEET_SEED)
         for u in run["results"]},
        lambda: fleet_params(arch), run["root"] / "torch", tmp_path)


def test_replay_logs_cross_packages(fleet):
    arch, run = fleet
    assert_logs_cross(run, arch)

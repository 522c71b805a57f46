"""The port's dry run (``repro_torch.launch.dryrun``) on a ``fake`` process
group: reduced qwen3-4b and granite-moe ``train_4k`` cells on a (16, 16)
mesh write the reference's JSON keys, their analytic per-device bytes
equal the JAX-side reckoning from ``spec_tree``, and their dot FLOPs on a
one-rank mesh are within 1 % of the reference's loop-aware HLO count of
the same step lowered on a 1 x 1 mesh. Also pins what the dry run takes from
``torch.testing._internal.distributed.fake_pg``."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.mezo import MezoConfig, mezo_step  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import sharding as jshd  # noqa: E402
from repro.roofline.hlo import analyze as hlo_analyze  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402

ARCHS = ["qwen3-4b", "granite-moe-1b-a400m"]
KEYS = {"arch", "shape", "mesh_tag", "optimizer", "mode", "mesh", "status",
        "n_tokens", "analytic_param_bytes_per_device",
        "analytic_opt_bytes_per_device", "memory_analysis", "cost_analysis",
        "collectives", "n_params_total", "n_params_active", "roofline",
        "traced"}
ROOFLINE_KEYS = {"flops_per_chip", "hbm_bytes_per_chip",
                 "collective_bytes_per_chip", "raw_cost_analysis_flops",
                 "raw_cost_analysis_bytes", "t_compute_s", "t_memory_s",
                 "t_collective_s", "bottleneck", "model_flops_total",
                 "useful_flops_ratio", "roofline_fraction"}


def _reduced(arch):
    red = get_config(arch).reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)}


@pytest.fixture
def no_group():
    """The dry run makes the default group itself; it is gone after."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _jax_param_bytes(arch, shape, axes, extra=None, moments=False):
    """Per-device parameter bytes on the JAX side; ``moments``: those of
    Adam's two f32 moments of every floating leaf instead."""
    red = dataclasses.replace(jax_config(arch).reduced(), **(extra or {}))
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices() * n)[:n].reshape(shape), axes)
    tree = jax.eval_shape(jax_build(red).init, jax.random.PRNGKey(0))
    specs = jshd.spec_tree(tree, fsdp=red.fsdp_params, use_tp=red.use_tp)
    total = 0
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    for leaf, spec in zip(jax.tree.leaves(tree),
                          jax.tree.leaves(specs, is_leaf=is_spec)):
        if moments and not jax.numpy.issubdtype(leaf.dtype,
                                                jax.numpy.floating):
            continue
        fit = jshd.fit_spec(leaf.shape, spec, mesh)
        total += int(np.prod(NamedSharding(mesh, fit).shard_shape(
            leaf.shape))) * (2 * 4 if moments else leaf.dtype.itemsize)
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_cell_on_fake_16x16(tmp_path, no_group, arch):
    rec = D.run_cell(arch, "train_4k", False, out_dir=str(tmp_path),
                     verbose=False, cfg_overrides=_reduced(arch))
    assert rec["status"] == "ok", rec.get("trace")
    (path,) = tmp_path.glob("*.json")
    with open(path) as f:
        got = json.load(f)
    assert KEYS <= set(got), KEYS - set(got)
    assert ROOFLINE_KEYS <= set(got["roofline"])
    assert got["traced"] == "plain"
    assert got["mesh"] == {"axes": ["data", "model"], "shape": [16, 16]}
    assert got["collectives"]["total"] > 0
    assert got["memory_analysis"]["peak_live_bytes_rank0"] >= \
        got["analytic_param_bytes_per_device"]
    assert got["analytic_param_bytes_per_device"] == _jax_param_bytes(
        arch, (16, 16), ("data", "model"))


# (arch, overrides of the reduced config): qwen3-4b's 4 reduced heads do
# not divide the 16-way model axis (gathered heads, merged on the local
# block); granite-moe with 16 experts takes the expert-parallel body
ADAM = [("qwen3-4b", {}), ("granite-moe-1b-a400m", {"n_experts": 16})]


@pytest.mark.parametrize("arch,extra", ADAM)
def test_dryrun_adam_cell_on_fake_16x16(no_group, arch, extra):
    """``--optimizer adam`` traces the gradient step through the plan; its
    optimizer bytes are two f32 moments of every floating leaf's shard,
    as the JAX-side reckoning from ``spec_tree`` gives them."""
    rec = D.run_cell(arch, "train_4k", False, optimizer="adam",
                     verbose=False, cfg_overrides={**_reduced(arch), **extra})
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["analytic_opt_bytes_per_device"] == _jax_param_bytes(
        arch, (16, 16), ("data", "model"), extra, moments=True)
    assert rec["analytic_param_bytes_per_device"] == _jax_param_bytes(
        arch, (16, 16), ("data", "model"), extra)
    assert rec["collectives"]["total"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_dot_flops_one_rank_within_1pct_of_reference(no_group, arch):
    from torch.distributed.device_mesh import init_device_mesh
    D.fake_group(1)
    pmesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    _, tr, _, _ = D.trace_cell(arch, "train_4k", pmesh,
                               cfg_overrides=_reduced(arch))
    counts = tr.result()
    # the reference's lower_cell, its step jitted here (its mezo_step is
    # a plain function, which lower_cell's ``.lower`` does not take)
    red = jax_config(arch).reduced()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with jax.set_mesh(mesh):
        inp = JS.cell_inputs(red, "train_4k", mesh)
        lowered = jax.jit(mezo_step, static_argnums=(0, 4)).lower(
            inp["model"].loss, inp["params"], inp["batch"], inp["seed"],
            MezoConfig(n_directions=1), None)
        want = hlo_analyze(lowered.compile().as_text())["flops"]
    got = counts["flops"]
    assert abs(got - want) <= 0.01 * want, (got, want)
    # one rank: nothing to communicate
    assert D.collective_bytes(counts)["total"] == 0


def test_fake_group_surface_the_dry_run_uses(no_group):
    """``FakeStore`` + the ``fake`` backend: a group of 512 ranks in one
    process, a (2, 16, 16) mesh on it, a DTensor shard of a fake leaf with
    nothing allocated, and a functional collective that returns at once."""
    import torch.distributed._functional_collectives as fc
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard, distribute_tensor
    D.fake_group(512)
    assert dist.get_backend() == "fake" and dist.get_world_size() == 512
    mesh = D.make_production_mesh(multi_pod=True)
    assert tuple(mesh.mesh.shape) == (2, 16, 16)
    with FakeTensorMode(allow_non_fake_inputs=True):
        w = torch.empty((7168, 32768), dtype=torch.bfloat16)
        d = distribute_tensor(w, mesh, [Shard(0), Shard(0), Shard(1)],
                              src_data_rank=None)
        assert tuple(d.to_local().shape) == (224, 2048)
        y = fc.wait_tensor(fc.all_reduce(d.to_local(), "sum",
                                         mesh.get_group("model")))
        assert tuple(y.shape) == (224, 2048)
    D.fake_group(256)                      # replaces the 512-rank group
    assert dist.get_world_size() == 256

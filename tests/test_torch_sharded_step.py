"""The sharded MeZO step on 4 gloo ranks (2 data x 2 model): reduced
OPT-1.3B and qwen3-4b in f32, params and batch DTensors by the sharding
plan. Every shard's z is the unsharded z's slice at atol 0 (the kernels'
plain versions at the shard's global offsets); the loss and the updated
params of the walk, fused and direction-parallel steps are the unsharded
port step's within 1e-5; ``remesh_params`` from a (1, 2, 2) mesh to a
(2, 1, 2) one keeps every value at atol 0."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp  # noqa: E402

WORLD = 4
ARCHS = ["opt-1.3b", "qwen3-4b"]


def _worker(rank, path, out_dir, arch):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.core import rng as zrng
    from repro_torch.core.mezo import (MezoConfig, mezo_step,
                                       mezo_step_fused, mezo_step_vmapdir)
    from repro_torch.kernels import ops
    from repro_torch.kernels import zo_perturb as zp
    from repro_torch.models import build_model
    from repro_torch.models import sharding as shd
    from repro_torch.runtime import elastic

    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=WORLD)
    res = {}
    try:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        model = build_model(cfg)
        g = torch.Generator().manual_seed(0)
        params = model.init(g, device="cpu")
        toks = torch.randint(0, cfg.vocab, (4, 16), generator=g)
        batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        me = mesh.get_local_rank("data")
        sbatch = {k: DTensor.from_local(v.chunk(2)[me].clone(), mesh,
                                        [Shard(0), Replicate()])
                  for k, v in batch.items()}

        # every shard's z: the whole leaf's slice, at atol 0
        sp = shd.distribute_tree(params, mesh)
        n_sharded = 0
        for path, leaf in params.items():
            salt = zrng.leaf_salt(path)
            got = ops.zo_add(sp[path], 99, salt, 1.0).to_local()
            want = zp.zo_add_ref(leaf, 99, salt, 1.0)
            offs = shd.local_offsets(sp[path])
            sl = tuple(slice(o, o + n) for o, n in zip(offs, got.shape))
            assert torch.equal(got, want[sl]), path
            n_sharded += got.shape != leaf.shape
        res["n_sharded"] = n_sharded

        mcfg = MezoConfig(n_directions=2, lr=1e-3, eps=1e-3)
        for name, fn in (("walk", mezo_step), ("fused", mezo_step_fused),
                         ("vmapdir", mezo_step_vmapdir)):
            want_p, want_aux = fn(model.loss,
                                  {k: v.clone() for k, v in params.items()},
                                  batch, 11, mcfg)
            with shd.use_mesh(mesh):
                got_p, got_aux = fn(model.loss,
                                    shd.distribute_tree(params, mesh),
                                    sbatch, 11, mcfg)
            res[f"{name}_loss"] = [float(want_aux.loss),
                                   float(got_aux.loss)]
            res[f"{name}_dparam"] = max(
                float((got_p[k].full_tensor() - want_p[k]).abs().max())
                for k in params)

        # remesh (1, 2, 2) -> (2, 1, 2): values untouched
        m1 = elastic.Mesh(np.empty((1, 2, 2), dtype=object)).device_mesh(
            "cpu")
        m2 = init_device_mesh("cpu", (2, 1, 2),
                              mesh_dim_names=("pod", "data", "model"))
        on1 = elastic.remesh_params(params, m1)
        on2 = elastic.remesh_params(on1, m2)
        res["remesh_equal"] = all(
            torch.equal(on2[k].full_tensor(), params[k]) for k in params)
        res["remesh_on_m2"] = all(on2[k].device_mesh == m2 for k in params)
        if rank == 0:
            np.save(os.path.join(out_dir, "res.npy"), res)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_unsharded(tmp_path, arch):
    mp.spawn(_worker, args=(str(tmp_path / "store"), str(tmp_path), arch),
             nprocs=WORLD)
    res = np.load(tmp_path / "res.npy", allow_pickle=True).item()
    assert res["n_sharded"] > 0
    for name in ("walk", "fused", "vmapdir"):
        want, got = res[f"{name}_loss"]
        assert abs(got - want) <= 1e-5, (name, got, want)
        assert res[f"{name}_dparam"] <= 1e-5, (name, res[f"{name}_dparam"])
    assert res["remesh_equal"] and res["remesh_on_m2"]

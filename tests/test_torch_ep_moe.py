"""Expert-parallel MoE (``repro_torch.models.moe.moe_apply_ep``) on 8 gloo
ranks against the JAX package's single-device ``moe_apply``, on
``tests/test_ep_moe.py``'s config and numpy inputs: the plain EP body, the
``fsdp_params`` gather and the weights-stationary branch on 2 data x 4
model, and the weights-stationary branch with a shared expert on that mesh
and on 2 pod x 2 data x 2 model, each within that test's tolerances; and
the EP path moves no more collective bytes (``roofline/trace.py``) than the
auto-sharded ``moe_apply`` under the same mesh. The two shared-expert
cases witness the port's weights-stationary sum (over ``model`` and
``data``, never ``pod``; the shared partial added on one data rank),
where the reference's differs (ROADMAP, "Open in the reference")."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.models import moe as JMoE  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402

CFG = dict(family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
           d_ff=64, vocab=64, n_experts=8, topk=2, expert_dff=48,
           capacity_factor=8.0, dtype="float32")
WORLD = 8
DM = ((2, 4), ("data", "model"))
PDM = ((2, 2, 2), ("pod", "data", "model"))
# (name, fsdp_params, batch, seq, mesh, n_shared_experts): the
# weights-stationary branch runs at b * s <= 8192 with fsdp, the fsdp
# gather above it
CASES = [("ep", False, 4, 8, DM, 0), ("fsdp_gather", True, 4, 2080, DM, 0),
         ("weights_stationary", True, 4, 8, DM, 0),
         ("weights_stationary_shared", True, 4, 8, DM, 1),
         ("weights_stationary_shared_pod", True, 4, 8, PDM, 1)]


def _inputs(b, s, n_shared=0):
    rng = np.random.default_rng(0)
    d, e, f = CFG["d_model"], CFG["n_experts"], CFG["expert_dff"]
    p = {"router": rng.normal(0, 0.02, (d, e)).astype(np.float32),
         "w_in": rng.normal(0, 0.02, (e, d, f, 2)).astype(np.float32),
         "w_out": rng.normal(0, 0.02, (e, f, d)).astype(np.float32)}
    x = rng.normal(0, 1.0, (b, s, d)).astype(np.float32)
    if n_shared:
        fs = n_shared * f
        p["shared"] = {
            "w_in": {"w": rng.normal(0, 0.02, (d, fs, 2)).astype(np.float32)},
            "w_out": {"w": rng.normal(0, 0.02, (fs, d)).astype(np.float32)}}
    return p, x


def _worker(rank, path, out_dir, fsdp, b, s, mesh_shape, n_shared):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import moe as MoE
    from repro_torch.models import sharding as shd
    from repro_torch.models.config import ModelConfig
    from repro_torch.roofline import trace as T

    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=WORLD)
    try:
        shape, axes = mesh_shape
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        cfg = ModelConfig(**CFG, fsdp_params=fsdp, moe_ep=True,
                          n_shared_experts=n_shared)
        pn, xn = _inputs(b, s, n_shared)
        # one layer's (unstacked) leaves, placed as the reference's test
        # places them (plus the data-sharded F of fsdp_params); the shared
        # expert as the plan places it (F over ``model``)
        specs = {"router": shd.P(),
                 "w_in": shd.P("model", None, "data" if fsdp else None,
                               None),
                 "w_out": shd.P("model", "data" if fsdp else None, None)}
        shared = {"w_in": shd.P(None, "model", None),
                  "w_out": shd.P("model", None)}
        p = {k: shd.distribute(torch.from_numpy(pn[k]), mesh, spec)
             for k, spec in specs.items()}
        if n_shared:
            p["shared"] = {k: {"w": shd.distribute(
                torch.from_numpy(pn["shared"][k]["w"]), mesh, shared[k])}
                for k in ("w_in", "w_out")}
        batch_axes = tuple(a for a in ("pod", "data") if a in axes)
        x = shd.distribute(torch.from_numpy(xn), mesh,
                           shd.P(batch_axes, None, None))
        with shd.use_mesh(mesh):
            with T.Tracer() as t_ep:
                out, aux = MoE.moe_apply_ep(cfg, p, x)
            with T.Tracer() as t_auto:
                out_auto, aux_auto = MoE.moe_apply(cfg, p, x)
        res = {"out": out.full_tensor().numpy(), "aux": float(aux),
               "out_auto": out_auto.full_tensor().numpy(),
               "aux_auto": float(aux_auto),
               "coll_ep": t_ep.result()["collective_bytes"],
               "coll_auto": t_auto.result()["collective_bytes"]}
        if rank == 0:
            np.savez(os.path.join(out_dir, "res.npz"), **res)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name,fsdp,b,s,mesh_shape,n_shared", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}" for c in CASES])
def test_ep_moe_equals_single_device_reference(tmp_path, name, fsdp, b, s,
                                               mesh_shape, n_shared):
    pn, xn = _inputs(b, s, n_shared)
    jcfg = JConfig(**CFG, fsdp_params=fsdp, moe_ep=True,
                   n_shared_experts=n_shared)
    want, aux_w = JMoE.moe_apply(jcfg, jax.tree.map(jnp.asarray, pn),
                                 jnp.asarray(xn))
    mp.spawn(_worker, args=(str(tmp_path / "store"), str(tmp_path), fsdp,
                            b, s, mesh_shape, n_shared), nprocs=WORLD)
    got = np.load(tmp_path / "res.npz")
    np.testing.assert_allclose(got["out"], np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(got["aux"]), float(aux_w), rtol=1e-4)
    # the auto-sharded local form computes the same function
    np.testing.assert_allclose(got["out_auto"], np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(got["aux_auto"]), float(aux_w),
                               rtol=1e-4)
    # the EP path must not move the expert buffers
    assert 0 < got["coll_ep"] <= got["coll_auto"], (got["coll_ep"],
                                                    got["coll_auto"])

"""Direction-parallel ZO training across pods -- PocketLLM Sec 6.3 realized.

Port of the JAX package's ``examples/multipod_directions.py``. Spawns 8
gloo ranks on the CPU forming a (pod=2, data=2, model=2) mini production
mesh, and demonstrates:

  1. K perturbation directions evaluated concurrently, direction k on pod
     k % 2 over that pod's (data, model) sub-mesh,
  2. cross-pod traffic = the (K,) scalar vector gs (the collectives are
     traced by ``roofline/trace.py``, each by its process group: the only
     one that crosses pods is the gather of gs),
  3. straggler drop: masking one pod's direction yields a valid update,
  4. elastic: "losing a pod" = halving K; no parameter resharding.

  PYTHONPATH=src python -m repro_torch.examples.multipod_directions

CPU only by design, as the JAX example is a host mesh of 8 forced CPU
devices: it takes no ``--device``. Parameters are placed by the sharding
plan (``models/sharding.py``; the pod axis replicates them) and the batch
over ``data``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import MezoConfig, add_scaled_z, get_strategy
from repro_torch.core import rng as zrng
from repro_torch.core.engine import MezoAux, _f32, _projected

WORLD = 8
MESH = ((2, 2, 2), ("pod", "data", "model"))
MCFG = MezoConfig(eps=1e-2, lr=1e-2, n_directions=2)   # 1 per pod
BATCH, SEQ = 8, 32


def reduced_config():
    return get_config("qwen3-4b").reduced(d_model=64, n_layers=2)


def _local(t):
    """A DTensor's value on this rank, replicated over its mesh."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh,
                          [Replicate()] * t.device_mesh.ndim).to_local()


def on_pod(t, sub):
    """A DTensor of the (pod, data, model) mesh, replicated over ``pod``,
    as a DTensor of this rank's pod's (data, model) sub-mesh ``sub``: the
    same local shard, no copy, no communication."""
    from torch.distributed.tensor import DTensor, Replicate
    assert isinstance(t.placements[0], Replicate), t.placements
    return DTensor.from_local(t.to_local(), sub, t.placements[1:],
                              shape=t.shape, stride=t.stride())


def pod_vmapdir_step(loss_fn, params, batch, seed, cfg: MezoConfig, mesh,
                     direction_mask=None):
    """``mezo_step_vmapdir`` with its K directions over the mesh's pod
    axis: pod p evaluates directions p, p + P, ... on its (data, model)
    sub-mesh, the pods exchange their gs (one all-gather over ``pod``,
    padded to ceil(K / P) a pod), and every rank applies the sgd update
    of all K directions (with ``direction_mask``) to the full mesh's
    parameters. ``aux.loss`` is this pod's directions' mean: the losses
    never leave the pod."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.models import sharding as shd
    seed = zrng._u32(seed)
    kk = cfg.n_directions
    pods = mesh.size(MESH[1].index("pod"))
    me = mesh.get_local_rank("pod")
    sub = mesh["data", "model"]
    p_sub = {k: on_pod(v, sub) for k, v in params.items()}
    b_sub = {k: on_pod(v, sub) for k, v in batch.items()}
    eps = _f32(None, cfg.eps)
    per = -(-kk // pods)
    gs, ls = torch.zeros(per), []
    with shd.use_mesh(sub):
        for j in range(per):
            k = me + j * pods
            if k >= kk:
                continue            # padding: this pod has no k-th one
            s = zrng.fold_seed(seed, k)
            lp = loss_fn(add_scaled_z(p_sub, s, eps, dist=cfg.dist), b_sub)
            lm = loss_fn(add_scaled_z(p_sub, s, -eps, dist=cfg.dist), b_sub)
            g, l = _projected(_local(lp), _local(lm), eps)
            gs[j] = g
            ls.append(l)
    every = DTensor.from_local(gs, mesh["pod"], [Shard(0)]).full_tensor()
    gs = every.reshape(pods, per).t().reshape(-1)[:kk].contiguous()
    with shd.use_mesh(mesh):
        params, _ = get_strategy("mezo-parallel").update.update_fn(
            params, {}, seed, gs, direction_mask, cfg, lr=_f32(None, cfg.lr))
    loss = torch.stack(ls).mean() if ls else torch.tensor(float("nan"))
    return params, MezoAux(loss=loss, gs=gs, seed=seed,
                           grad_norm_est=gs.abs().mean())


def run_rank(rank: int, store: str, out: str, params_np=None):
    """One of the 8 ranks: the three steps of the example on the mesh;
    rank 0 writes their results to ``out`` (JSON)."""
    import dataclasses
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint.store import params_from_numpy
    from repro_torch.data.synthetic import lm_batch_at, synthetic_lm_corpus
    from repro_torch.models import build_model
    from repro_torch.models import sharding as shd
    from repro_torch.roofline import trace as T

    torch.set_num_threads(1)
    # DTensor warns at every loss that reduces over data and model
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = init_device_mesh("cpu", MESH[0], mesh_dim_names=MESH[1])
        cfg = reduced_config()
        model = build_model(cfg)
        params = (params_from_numpy(params_np, "cpu") if params_np
                  is not None else model.init(
                      torch.Generator().manual_seed(0), "cpu"))
        n_param_bytes = sum(v.numel() * v.element_size()
                            for v in params.values())
        params = shd.distribute_tree(params, mesh)
        stream = synthetic_lm_corpus(BATCH * 40 * (SEQ + 1), cfg.vocab, 0)
        batch = {k: shd.distribute(torch.from_numpy(v), mesh, shd.P("data"))
                 for k, v in lm_batch_at(0, BATCH, SEQ, cfg.vocab,
                                         stream).items()}
        with T.Tracer() as tr:
            p2, aux = pod_vmapdir_step(model.loss, params, batch, 0, MCFG,
                                       mesh)
        coll = T.collective_bytes(tr.result())
        cross = T.groups_crossing(tr.by_group, mesh, "pod")
        # straggler: drop direction 1 (pod 1 late) -- still a valid step
        p3, _ = pod_vmapdir_step(model.loss, params, batch, 0, MCFG, mesh,
                                 torch.tensor([1.0, 0.0]))
        # elastic: pod left -> K=1, same params sharding, no resharding
        mcfg1 = dataclasses.replace(MCFG, n_directions=1)
        p4, _ = pod_vmapdir_step(model.loss, params, batch, 0, mcfg1, mesh)
        full = {name: {k: _local(v) for k, v in p.items()}
                for name, p in (("k2", p2), ("masked", p3), ("k1", p4))}
        res = {"gs": aux.gs.tolist(), "collective_total": coll["total"],
               "collective_by_kind": coll,
               "cross_pod_bytes": int(sum(tr.by_group[g] for g in cross)),
               "param_bytes": n_param_bytes,
               "masked_vs_k1_ln_f": float(
                   (full["masked"]["ln_f/scale"]
                    - full["k1"]["ln_f/scale"]).abs().max()),
               "masked_vs_k1": max(float((full["masked"][k]
                                          - full["k1"][k]).abs().max())
                                   for k in full["k1"]),
               "k2_moved": max(float((full["k2"][k]
                                      - _local(params[k])).abs().max())
                               for k in full["k2"])}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
            np.savez(out + ".params.npz", **{
                f"{name}::{k}": v.numpy() for name, p in full.items()
                for k, v in p.items()})
    finally:
        dist.destroy_process_group()


def run(params_np=None, workdir: Optional[str] = None) -> dict:
    """Spawn the 8 ranks; returns rank 0's results (and, under
    ``"params"``, the three steps' full parameters as numpy)."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(dir=workdir)
    try:
        out = os.path.join(tmp, "res.json")
        mp.spawn(run_rank, args=(os.path.join(tmp, "store"), out,
                                 params_np), nprocs=WORLD)
        with open(out) as f:
            res = json.load(f)
        with np.load(out + ".params.npz") as data:
            res["params"] = {k: data[k] for k in data.files}
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    res = run()
    print(f"gs per direction: {np.asarray(res['gs'], np.float32)}")
    print(f"collective bytes/step/device: {res['collective_total']:,} "
          f"(cross-pod: {res['cross_pod_bytes']:,}; params: "
          f"{res['param_bytes']:,} bytes)")
    print("straggler-masked update == K=1 update:",
          res["masked_vs_k1_ln_f"] <= 1e-6)
    assert np.isfinite(np.asarray(res["gs"])).all()
    print("OK: direction-parallel, straggler drop and elastic-K all work")


if __name__ == "__main__":
    main()

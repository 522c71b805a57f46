"""Multi-pod dry run: trace every (arch x shape) cell's step on the
production mesh of fake ranks.

Port of the JAX package's ``launch/dryrun.py``. Where the reference lowers
and compiles each cell on 512 placeholder host devices, the port starts
a ``fake`` process group of 256 (or 512) ranks in this one process, builds
the cell's params, batch and cache as fake DTensors placed by the sharding
plan (``launch/specs.py``) and runs the step under ``FakeTensorMode``:
nothing is allocated on any device, and the kernels' plain versions run
(fake tensors live on the CPU), hence ``"traced": "plain"``. It proves the
plan coherent -- a placement an op cannot take, or a shard that does not
divide, fails here -- and counts, on rank 0, what the step does:

  * ``analytic_*_bytes_per_device``: parameter, optimizer and cache bytes
    from the shard shapes;
  * ``memory_analysis``: the peak of live bytes on rank 0 while the step
    runs, its inputs included (``roofline/trace.py``'s count of storage
    lifetimes; ``MemTracker`` under the fake mode saw no tensor freed);
  * ``cost_analysis`` / ``collectives`` / ``roofline``: the traced counts
    of ``roofline/trace.py`` (dot flops, unfused bytes, collective bytes
    by kind) and the three-term roofline on the H100's data sheet
    (``roofline/analysis.py``, ``launch/mesh.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--optimizer mezo|mezo-parallel|adam] [--out experiments/dryrun_torch]

Outputs one JSON per cell and the reference's one-line summary; exits
non-zero if a cell fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding as shd
from repro_torch.roofline.analysis import (active_params, roofline_terms,
                                           total_params)
from repro_torch.roofline.trace import Tracer, collective_bytes


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _analytic_bytes_per_device(tree) -> int:
    total = 0
    for leaf in _leaves(tree):
        local = leaf.to_local() if shd.is_dtensor(leaf) else leaf
        total += int(local.numel()) * local.element_size()
    return total


def fake_group(world_size: int):
    """Make the default process group a ``fake`` one of ``world_size``
    ranks (this process is rank 0), replacing one of another size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world_size):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _mesh(multi_pod: bool):
    fake_group(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod)


def _opt_state(params):
    """Adam's two f32 moments, placed as their leaves."""
    from torch.distributed.tensor import DTensor
    out = {}
    for k, p in params.items():
        if not p.is_floating_point():
            continue
        z = torch.zeros(p.to_local().shape, dtype=torch.float32)
        out[k] = DTensor.from_local(z, p.device_mesh, p.placements,
                                    shape=p.shape, stride=p.stride())
    return out


def trace_cell(arch: str, shape_name: str, mesh, optimizer: str = "mezo",
               cfg_overrides=None):
    """Trace one cell's step; returns (meta, tracer, peak, cfg)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.mezo import MezoConfig, mezo_step, \
        mezo_step_vmapdir
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    sh = S.SHAPES[shape_name]
    # the mesh's own rank table is a real tensor DTensor reads
    with FakeTensorMode(allow_non_fake_inputs=True):
        inp = S.cell_inputs(cfg, shape_name, mesh)
        model = inp["model"]
        meta = dict(arch=arch, shape=shape_name, mode=inp["mode"],
                    optimizer=optimizer if inp["mode"] == "train" else "fwd",
                    mesh=dict(axes=list(shd.axis_names(mesh)),
                              shape=[int(s) for s in mesh.mesh.shape]),
                    traced="plain")
        meta["n_tokens"] = sh["batch"] * (sh["seq"] if inp["mode"] !=
                                          "decode" else 1)
        meta["analytic_param_bytes_per_device"] = \
            _analytic_bytes_per_device(inp["params"])
        if inp["mode"] == "train":
            if optimizer == "adam":
                from repro_torch.optim.adam import (AdamConfig, AdamState,
                                                    grad_train_step)
                mu = _opt_state(inp["params"])
                state = AdamState(mu=mu, nu=_opt_state(inp["params"]),
                                  count=torch.zeros((), dtype=torch.int32))
                meta["analytic_opt_bytes_per_device"] = 2 * \
                    _analytic_bytes_per_device(mu)

                def step():
                    return grad_train_step(model.loss, inp["params"],
                                           inp["batch"], state, AdamConfig())
            else:
                fn = {"mezo": mezo_step,
                      "mezo-parallel": mezo_step_vmapdir}[optimizer]
                meta["analytic_opt_bytes_per_device"] = 0

                def step():
                    return fn(model.loss, inp["params"], inp["batch"],
                              inp["seed"], MezoConfig(n_directions=1))
        elif inp["mode"] == "prefill":
            def step():
                return model.forward(inp["params"], inp["batch"],
                                     last_only=True)
        else:
            meta["analytic_cache_bytes_per_device"] = \
                _analytic_bytes_per_device(inp["cache"])

            def step():
                return model.decode_step(inp["params"], inp["cache"],
                                         inp["tokens"], inp["pos"])
        with shd.use_mesh(mesh), Tracer() as tr:
            tr.track(*_leaves(inp))
            step()
    return meta, tr, tr.peak, cfg


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             optimizer: str = "mezo", out_dir: str = None,
             verbose: bool = True, cfg_overrides=None, tag: str = None):
    """One cell: trace, count, emit."""
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    if tag:
        mesh_tag = f"{mesh_tag}+{tag}"
    cfg = get_config(arch)
    reason = S.cell_supported(cfg, shape_name)
    rec = dict(arch=arch, shape=shape_name, mesh_tag=mesh_tag,
               optimizer=optimizer)
    if reason:
        rec.update(status="skip", reason=reason)
        _emit(rec, out_dir, verbose)
        return rec

    t0 = time.time()
    try:
        mesh = _mesh(multi_pod)
        meta, tr, peak, cfg = trace_cell(arch, shape_name, mesh, optimizer,
                                         cfg_overrides)
    except Exception as e:
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        _emit(rec, out_dir, verbose)
        return rec
    rec.update(meta)
    rec.update(status="ok", t_trace_s=round(time.time() - t0, 1))
    a = tr.result()
    rec["memory_analysis"] = {"peak_live_bytes_rank0": peak}
    rec["cost_analysis"] = {"flops": a["flops"],
                            "bytes accessed": a["hbm_bytes"],
                            "n_ops": tr.n_ops}
    n_chips = int(np.prod(mesh.mesh.shape))
    rec["n_params_total"] = float(total_params(cfg))
    rec["n_params_active"] = float(active_params(cfg))
    rec["roofline"] = roofline_terms(
        rec["cost_analysis"], a, n_chips, cfg=cfg, n_tokens=rec["n_tokens"],
        mode=("train" if rec.get("optimizer") in ("mezo", "mezo-parallel")
              else ("train-adam" if rec.get("optimizer") == "adam"
                    else rec["mode"])))
    rec["collectives"] = collective_bytes(a)
    _emit(rec, out_dir, verbose)
    return rec


def _emit(rec, out_dir, verbose):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = (f"{rec['arch']}__{rec['shape']}__{rec['mesh_tag']}"
                f"__{rec.get('optimizer', 'na')}.json")
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        if rec["status"] == "ok":
            r = rec["roofline"]
            print(f"[dryrun] OK  {rec['arch']:24s} {rec['shape']:12s} "
                  f"{rec['mesh_tag']:10s} bottleneck={r['bottleneck']:10s} "
                  f"tc={r['t_compute_s']:.3e} tm={r['t_memory_s']:.3e} "
                  f"tx={r['t_collective_s']:.3e}", flush=True)
        elif rec["status"] == "skip":
            print(f"[dryrun] SKIP {rec['arch']:24s} {rec['shape']:12s} "
                  f"({rec['reason'][:60]})", flush=True)
        else:
            print(f"[dryrun] FAIL {rec['arch']:24s} {rec['shape']:12s} "
                  f"{rec['error'][:200]}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(S.SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--optimizer", default="mezo",
                    choices=["mezo", "mezo-parallel", "adam"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--moe-ep", action="store_true",
                    help="expert-parallel MoE (moe_apply_ep)")
    ap.add_argument("--tag", default=None,
                    help="suffix for output filenames (perf iterations)")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(S.SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_fail = 0
    try:
        for mp in meshes:
            for arch in archs:
                for shape in shapes:
                    ovr = {"moe_ep": True} if args.moe_ep else None
                    rec = run_cell(arch, shape, mp, args.optimizer, args.out,
                                   cfg_overrides=ovr, tag=args.tag)
                    n_fail += rec["status"] == "fail"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()

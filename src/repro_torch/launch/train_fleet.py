"""Multi-tenant fine-tune launcher: N users through one TrainEngine.

Port of the JAX package's ``launch/train_fleet.py``: the same flags and
defaults, plus ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions, for reduced configs). A fleet of per-user fine-tune jobs
shares one resident base (full precision or int8) and the batched
TrainEngine advances every resident job per dispatch -- each user's
trajectory bit-identical to a lone sequential Trainer run with that
user's derived seed, for every family (``--arch``). On the card the
projections always take the CUDA kernels: ``--use-kernel`` is taken and
has no effect, as in ``launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train_fleet --arch opt-1.3b \\
      --reduced --device cpu --users 6 --slots 4 --steps 3 --quant int8
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import zlib
from typing import Optional

import numpy as np

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.engine import (MezoConfig, estimator_names,
                                     update_rule_names)
from repro_torch.runtime.trainer import train_multi_tenant
from repro_torch.train import TrainJob


def user_batches(cfg, user: str, batch: int, seq: int, seed: int):
    """Deterministic per-(user, step) LM batches (numpy, the JAX CLI's
    stream): a resumed job replays exactly the batches the uninterrupted
    run would have consumed."""
    salt = zlib.crc32(f"{seed}/{user}".encode()) & 0x7FFFFFFF

    def fn(step: int):
        rng = np.random.default_rng((salt, step))
        toks = rng.integers(0, cfg.vocab, (batch, seq + 1), dtype=np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                "loss_mask": np.ones((batch, seq), np.float32)}
    return fn


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch."
                                      "train_fleet")
    ap.add_argument("--arch", default="gemma-2b", choices=ALL_ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--users", type=int, default=8,
                    help="fine-tune jobs to run (user-0 .. user-N-1)")
    ap.add_argument("--slots", type=int, default=4,
                    help="resident jobs per batched dispatch")
    ap.add_argument("--steps", type=int, default=20,
                    help="ZO steps per user")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--estimator", default="fused",
                    choices=[e for e in estimator_names() if e != "walk"],
                    help="pristine direction evaluator (the in-place walk "
                         "cannot give replay-log bit-parity)")
    ap.add_argument("--update", default="sgd", choices=update_rule_names())
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--directions", type=int, default=1)
    ap.add_argument("--zo-dist", default="rademacher",
                    choices=["rademacher", "gaussian"])
    ap.add_argument("--quant", default="none",
                    help="base-weight quantization (none | int8): int8 "
                         "keeps ONE ~1 byte/param base resident for every "
                         "user; per-user state is only the f32 deltas")
    ap.add_argument("--use-kernel", action="store_true",
                    help="no effect: tensors on the card always take the "
                         "CUDA kernels, tensors on the CPU their plain "
                         "versions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-dir", default=None,
                    help="append per-user replay logs under this dir "
                         "(crash recovery: AdapterStore.load per user)")
    ap.add_argument("--out", default=None, help="summary JSON path")
    return ap


def run(argv=None, params=None):
    """Parse ``argv``, train the fleet, print the summary lines and write
    ``--out``; returns ``(engine, results)``. ``params`` replaces the
    seeded random base, e.g. with the JAX package's parameters."""
    args = build_argparser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.seq and cfg.family != "encoder":
        cfg = dataclasses.replace(cfg, max_seq=max(cfg.max_seq, args.seq))

    mz = MezoConfig(eps=args.eps, lr=args.lr, n_directions=args.directions,
                    dist=args.zo_dist)
    jobs = [TrainJob(user=f"user-{i}",
                     batches=user_batches(cfg, f"user-{i}", args.batch,
                                          args.seq, args.seed),
                     n_steps=args.steps)
            for i in range(args.users)]
    engine, results = train_multi_tenant(
        cfg, jobs, n_slots=args.slots, estimator=args.estimator,
        update=args.update, seed=args.seed, mezo_cfg=mz, quant=args.quant,
        log_dir=args.log_dir, device=args.device, params=params)

    for r in results:
        print(f"[fleet] {r.user}: steps {r.start_step}->{r.n_steps} "
              f"loss {r.losses[0]:.4f} -> {r.losses[-1]:.4f}")
    s = engine.stats
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"arch": args.arch, "users": args.users,
                       "slots": args.slots, "steps": args.steps,
                       "quant": args.quant,
                       "user_steps_per_s": s.user_steps_per_s,
                       "dispatches": s.dispatches,
                       "losses": {r.user: r.losses for r in results}}, f)
    print(f"[fleet] {s.finished} users x {args.steps} steps in "
          f"{s.dispatches} dispatches: {s.user_steps_per_s:.2f} "
          f"user-steps/s")
    return engine, results


def main(argv: Optional[list] = None):
    run(argv)


if __name__ == "__main__":
    main()

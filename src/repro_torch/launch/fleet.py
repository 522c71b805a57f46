"""Async direction-service launcher: elastic fleet ZO training.

Port of the JAX package's ``launch/fleet.py``: the same flags, plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions,
for reduced configs). One training job runs across an elastic fleet of
heterogeneous workers: a coordinator hands out (step, seed, K) direction
leases, workers return projected gradients at their own modeled pace,
and the coordinator applies them staleness-decayed, logging every
applied update so the run replays bit-exactly from theta_0
(``--verify-replay`` checks exactly that, atol 0, after injected
stragglers, duplicate deliveries and a mid-run join and leave).

  PYTHONPATH=src python -m repro_torch.launch.fleet --arch gemma-2b \\
      --reduced --device cpu --workers 4 --stragglers 1 --steps 24 \\
      --join-after 6 --leave-after 12 --log runs/fleet.jsonl \\
      --verify-replay
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

from repro_torch.checkpoint.replay_log import ReplayLog, replay_into
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.engine import MezoConfig, estimator_names
from repro_torch.runtime.fleet import (DEVICE_GRADES, FaultSpec, FleetSim,
                                       WorkerSpec)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.fleet")
    ap.add_argument("--arch", default="gemma-2b", choices=ALL_ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--workers", type=int, default=4,
                    help="initial fleet size")
    ap.add_argument("--grade", default="flagship",
                    choices=sorted(DEVICE_GRADES),
                    help="device grade of the fleet (roofline latency "
                         "profile)")
    ap.add_argument("--stragglers", type=int, default=0,
                    help="how many workers run --straggler-scale slower")
    ap.add_argument("--straggler-scale", type=float, default=5.0)
    ap.add_argument("--duplicate-every", type=int, default=0,
                    help="worker 0 delivers every Nth result twice "
                         "(transport-retry fault injection)")
    ap.add_argument("--steps", type=int, default=24,
                    help="updates to apply before stopping")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--estimator", default="fused",
                    choices=[e for e in estimator_names() if e != "walk"],
                    help="pristine direction evaluator (leased params "
                         "snapshots are shared by reference; the in-place "
                         "walk would corrupt them)")
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--directions", type=int, default=2)
    ap.add_argument("--zo-dist", default="rademacher",
                    choices=["rademacher", "gaussian"])
    ap.add_argument("--staleness-decay", type=float, default=0.95,
                    help="applied update scaled by decay**staleness "
                         "(updates applied since the worker's params "
                         "snapshot); 1.0 = no decay")
    ap.add_argument("--deadline-factor", type=float, default=3.0,
                    help="lease expiry budget: factor x EMA-median "
                         "latency (StragglerPolicy)")
    ap.add_argument("--join-after", type=int, default=None,
                    help="admit one extra worker after this many applied "
                         "updates (elastic resize mid-round)")
    ap.add_argument("--leave-after", type=int, default=None,
                    help="retire the last initial worker after this many "
                         "applied updates")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log", default=None,
                    help="replay-log path (staleness-bearing JSONL)")
    ap.add_argument("--out", default=None, help="summary JSON path")
    ap.add_argument("--verify-replay", action="store_true",
                    help="replay the log from theta_0 and require "
                         "bit-exact (atol=0) agreement with live params")
    return ap


def max_abs_diff(a, b) -> float:
    """max |a - b| over every leaf of two flat parameter dicts, in f32."""
    return max(float((a[k].float() - b[k].float()).abs().max())
               for k in a)


def run(argv=None, params=None):
    """Parse ``argv``, run the fleet, print the summary lines, verify the
    replay and write ``--out``; returns ``(sim, report, replay_ok)``.
    ``params`` replaces the seeded random theta_0, e.g. with the JAX
    package's parameters."""
    args = build_argparser().parse_args(argv)
    if args.stragglers > args.workers:
        raise SystemExit(f"--stragglers {args.stragglers} exceeds "
                         f"--workers {args.workers}")
    for flag, val in (("--join-after", args.join_after),
                      ("--leave-after", args.leave_after)):
        if val is not None and not 0 < val < args.steps:
            raise SystemExit(f"{flag} {val} must lie inside (0, --steps "
                             f"{args.steps}) to fire mid-round")
    if args.verify_replay and not args.log:
        raise SystemExit("--verify-replay needs --log (the replay source)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mz = MezoConfig(eps=args.eps, lr=args.lr,
                    n_directions=args.directions, dist=args.zo_dist,
                    staleness_decay=args.staleness_decay)

    workers = []
    for i in range(args.workers):
        faults = FaultSpec(jitter=0.2)
        if i >= args.workers - args.stragglers:
            faults.latency_scale = args.straggler_scale
        if i == 0 and args.duplicate_every:
            faults.duplicate_every = args.duplicate_every
        workers.append(WorkerSpec(args.grade, faults))

    step_events = []
    if args.join_after is not None:
        step_events.append((args.join_after, "join",
                            WorkerSpec(args.grade, FaultSpec(jitter=0.2))))
    if args.leave_after is not None:
        step_events.append((args.leave_after, "leave", args.workers - 1))

    sim = FleetSim(cfg, workers, total_steps=args.steps, mezo_cfg=mz,
                   batch=args.batch, seq=args.seq, seed=args.seed,
                   estimator=args.estimator,
                   deadline_factor=args.deadline_factor,
                   log_path=args.log, step_events=step_events,
                   params=params, device=args.device)
    rep = sim.run()

    print(f"[fleet] {rep.applied} updates applied over "
          f"{rep.virtual_s * 1e3:.2f} virtual ms "
          f"({rep.virtual_steps_per_s:.1f} steps/s modeled); "
          f"reissued {rep.reissued}, dropped {rep.dropped} late/dup "
          f"deliveries, {rep.resizes} elastic resizes, "
          f"max staleness {max(rep.staleness)}")
    print(f"[fleet] loss {rep.losses[0]:.4f} -> {rep.losses[-1]:.4f}")

    replay_ok = None
    if args.verify_replay:
        # theta_0 is the sim's base_params: the coordinator applied every
        # update out of place and never wrote it
        replayed, _ = replay_into(sim.base_params, ReplayLog.read(args.log),
                                  mz)
        diff = max_abs_diff(replayed, rep.params)
        del replayed
        replay_ok = diff == 0.0
        print(f"[fleet] replay-from-log max |diff| = {diff} "
              f"({'bit-exact' if replay_ok else 'MISMATCH'})")
        if not replay_ok:
            raise SystemExit(1)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"arch": args.arch, "workers": args.workers,
                       "stragglers": args.stragglers, "steps": args.steps,
                       "applied": rep.applied, "reissued": rep.reissued,
                       "dropped": rep.dropped, "resizes": rep.resizes,
                       "virtual_s": rep.virtual_s,
                       "virtual_steps_per_s": rep.virtual_steps_per_s,
                       "max_staleness": max(rep.staleness),
                       "losses": rep.losses,
                       "replay_bitexact": replay_ok}, f)
    return sim, rep, replay_ok


def main(argv: Optional[list] = None):
    run(argv)


if __name__ == "__main__":
    main()

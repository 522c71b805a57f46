#!/usr/bin/env python3
"""Host and device time of one ``--quant int8`` fused MeZO step (Q2).

  python3 tools/step_time.py [--src DIR]

Builds the train CLI's Trainer (``repro_torch.launch.train.run``,
full-width OPT-1.3B over an int8 base with f32 deltas, ``mezo-fused``,
B 8 x S 128, seed 0) from the ``repro_torch`` package under ``--src``
(default: this checkout's ``src``), then prints one JSON line: the mean
host-clock seconds of 6 synchronized steps, 3 times; one step under
``torch.profiler`` (device busy time and share); and one step under
``cProfile`` (the host functions with the most own time). Two trees are
compared by running it once for each, one after another on one card, in the
order a, b, b, a. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS, REPEATS = 6, 3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("step_time: torch.cuda is not available")
    import chip_smoke as cs              # its helpers import repro_torch
    from repro_torch.core import rng
    from repro_torch.launch import train as train_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    argv = ["--arch", "opt-1.3b", "--optimizer", "mezo-fused", "--steps",
            "1", "--batch", str(cs.TRAIN_B), "--seq", str(cs.TRAIN_S),
            "--seed", "0", "--quant", "int8"]
    tr = train_mod.run(argv)
    batch = cs._first_batch(torch, tr.mcfg, cs.TRAIN_B, cs.TRAIN_S)
    state = tr.strategy.init_state(tr.params, tr.tcfg.mezo)
    step_s = []
    for _ in range(REPEATS):
        s, state = cs._timed_steps(torch, tr.strategy, tr.model.loss, state,
                                   batch, tr.tcfg.mezo, STEPS)
        step_s.append(s)

    def one():
        tr.strategy.step(tr.model.loss, state, batch, rng.fold_seed(777, 0),
                         tr.tcfg.mezo)
    wall_us, by_name = cs._profiled(torch, one)
    busy_us = sum(by_name.values())
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    one()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]
    print(json.dumps({
        "phase": "step-time", "src": str(src), "quant": "int8",
        "card": smi.stdout.strip(), "batch": [cs.TRAIN_B, cs.TRAIN_S],
        "steps": STEPS, "step_s": step_s,
        "profiled_wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "cprofile_total_s": stats.total_tt,
        "host_top_own_s": {f"{Path(f).name}:{line}:{fn}": v[2]
                           for (f, line, fn), v in top}}), flush=True)


if __name__ == "__main__":
    main()

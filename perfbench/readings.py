"""The readings the limits of ``correct`` are set from, several seeds in
one process, on the card at the cell's own sizes:

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \
        [--control] [--faults] [--out FILE]

For each seed it runs the program's set-up steps (as a run does) and the
reference, and prints the numbers the cell's driver compares for the
program; with ``--control`` also for the reference computed in the
workload's ``control`` precision put in the program's place, and with
``--faults`` for the reference with half of each batch left out (the
mean over the rest). One JSON line a seed, with each side's losses, gs
and leaf norms under ``raw``; the benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def seed_readings(cell, seed: int, device, control: bool,
                  faults: bool) -> dict:
    import torch

    from perfbench import bench
    drv = bench.driver_module(cell).Driver(cell, seed, device, 0.0)
    out = {"seed": seed}
    t0 = time.perf_counter()
    drv.setup(size_window=False)
    prog = drv.program_readings()
    drv.free()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = drv.reference_readings()
    sides = {"reference": ref, "program": prog}
    out["program"] = drv.numbers(prog, ref, drv.update_readings(prog))
    if control:
        sides["control"] = drv.reference_readings(
            precision=cell.workload["control"])
        out["control"] = drv.numbers(sides["control"], ref,
                                     drv.update_readings(sides["control"]))
    if faults:
        sides["half_batch"] = drv.reference_readings(half_batch=True)
        out["half_batch"] = drv.numbers(
            sides["half_batch"], ref, drv.update_readings(sides["half_batch"]))
    out["raw"] = sides
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from perfbench import bench
    cell = bench.load_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for s in args.seeds.split(","):
            line = json.dumps({"workload": args.workload, **seed_readings(
                cell, int(s), "cuda:0", args.control, args.faults)})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

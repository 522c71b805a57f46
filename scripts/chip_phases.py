"""Run chosen phases of ``chip_smoke.py`` alone on the card.

Builds the kernels, then calls each named phase function of
``chip_smoke.py`` that takes ``(torch, paths)`` (``ex1_quickstart``,
``ex2_finetune_sst2``, ``ex3_personalized``, ``r1_roberta``, ...) in
order, printing its lines and its seconds: a quick check of a phase
without the whole script's ~15 minutes.

  python scripts/chip_phases.py ex3_personalized
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("phases", nargs="+")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.library()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0}),
          flush=True)
    paths: dict = {}
    for name in args.phases:
        t0 = time.perf_counter()
        getattr(cs, name)(torch, paths)
        print(json.dumps({"phase": name, "seconds":
                          time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()

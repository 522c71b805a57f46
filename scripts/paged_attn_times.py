#!/usr/bin/env python3
"""Time the paged attention kernels of one source tree on the card.

  python3 scripts/paged_attn_times.py [--src DIR] [--label NAME]
                                      [--unchecked]

Builds the kernels of ``DIR/repro_torch/csrc`` (default: this checkout's
``src``) and runs ``chip_smoke.py``'s ``ATTN_TIMED`` cases through its
``time_paged_attention``: ``flash_decode`` and ``flash_prefill`` in bf16
at OPT-1.3B's width (32 heads of 64, page 16), each beside its plain
version, every SDPA backend over K/V gathered beforehand (the
yardstick) and, as context, every backend with the gather in the timed
graph. Each kernel's output is first held to its plain version
(``--unchecked``: not, for a deliberately patched tree). Prints the
card's name and power limit, then one JSON line a case. Two trees are
compared in one call, in turns (a b b a), e.g. the parent commit
unpacked by ``git archive`` under ``build/parent``:

  for s in build/parent/src src src build/parent/src; do
      python3 scripts/paged_attn_times.py --src $s; done
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default=None)
    ap.add_argument("--unchecked", action="store_true")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("torch.cuda is not available: this script needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    build.library()
    for name, label, pos, n_live in cs.ATTN_TIMED:
        row = cs.time_paged_attention(torch, name, pos, n_live,
                                      checked=not args.unchecked)
        print(json.dumps({"tree": args.label or str(src), "name": name,
                          "case": label, **row}), flush=True)


if __name__ == "__main__":
    main()

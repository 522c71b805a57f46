#!/usr/bin/env python3
"""Time the paged attention kernels of one source tree on the card.

  python3 scripts/paged_attn_times.py [--src DIR] [--label NAME]
                                      [--unchecked]

Builds the kernels of ``DIR/repro_torch/csrc`` (default: this checkout's
``src``) and runs ``chip_smoke.py``'s ``ATTN_TIMED`` and ``VERIFY_TIMED``
cases through its ``time_paged_attention``: ``flash_decode``,
``flash_prefill`` and ``flash_verify`` in bf16 at OPT-1.3B's width (32
heads of 64, page 16), each beside its plain
version, every SDPA backend over K/V gathered beforehand (the
yardstick) and, as context, every backend with the gather in the timed
graph. ``--gqa`` runs ``flash_decode`` instead at every grouped-query
layout of ``REAL_HEADS`` (G >= 2: gemma-2b, qwen3-4b, chatglm3,
granite-moe, kimi-k2), short and long (``GQA_DECODE_TIMED``), without
the gather context. Each kernel's output is first held to its plain
version (``--unchecked``: not, for a deliberately patched tree). Prints
the card's name and power limit, then one JSON line a case. Two trees
are compared in one call, in turns (a b b a), e.g. the parent commit
unpacked by ``git archive`` under ``build/parent``:

  for s in build/parent/src src src build/parent/src; do
      python3 scripts/paged_attn_times.py --gqa --src $s \
          --g1-bits build/g1_bits.pt; done

``--g1-bits FILE`` first runs ``flash_decode`` at G = 1 (``G1_LAYOUTS``,
head dims 16-256, f32 and bf16, ``DECODE_SPLIT_CHECKED``'s short and long
B 8 cases at pages 16 and 64) on inputs made from fixed seeds, and writes
the outputs to FILE, or, where FILE exists, holds this tree's outputs to
it bit for bit (a line ``{"g1_bits_equal": ...}``; exit 1 on any
difference): the first tree of the turns writes it, the others are held
to it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# G = 1 (H, KV, hd): OPT-1.3B, whisper-base, and the other head dims
G1_LAYOUTS = ((32, 32, 64), (8, 8, 64), (4, 4, 16), (4, 4, 32),
              (4, 4, 112), (4, 4, 128), (2, 2, 256))


def g1_outputs(torch, cs):
    """flash_decode's G = 1 outputs on seeded inputs, by case (host)."""
    from repro_torch.kernels import flash_decode as fd
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    outs = {}
    for h, kvh, hd in G1_LAYOUTS:
        for case, (pos, n_live16) in cs.DECODE_SPLIT_CHECKED.items():
            for ps in (16, 64):
                k, v, pages, pos_t = cs._paged_case(
                    torch, len(pos), ps, kvh, hd, n_live16 * 16 // ps, pos,
                    0.0)
                q = torch.randn((len(pos), h, hd), generator=gen, device=dev)
                for dt in (torch.float32, torch.bfloat16):
                    outs[f"H {h} hd {hd} {case} page {ps} {dt}"] = \
                        fd.flash_decode(q.to(dt), k.to(dt), v.to(dt), pages,
                                        pos_t).cpu()
    return outs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default=None)
    ap.add_argument("--unchecked", action="store_true")
    ap.add_argument("--gqa", action="store_true",
                    help="flash_decode at every G >= 2 REAL_HEADS layout")
    ap.add_argument("--g1-bits", default=None, metavar="FILE",
                    help="write flash_decode's G = 1 outputs to FILE, or "
                         "hold them to it bit for bit where it exists")
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
    if args.g1_bits:
        outs = g1_outputs(torch, cs)
        path = Path(args.g1_bits)
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save(outs, path)
            print(json.dumps({"tree": args.label or str(src),
                              "g1_bits_written": str(path),
                              "cases": len(outs)}), flush=True)
        else:
            want = torch.load(path)
            differ = sorted(c for c in want
                            if c not in outs or not torch.equal(outs[c],
                                                                want[c]))
            print(json.dumps({"tree": args.label or str(src),
                              "g1_bits_equal": not differ and
                              outs.keys() == want.keys(),
                              "cases": len(want), "differ": differ}),
                  flush=True)
            if differ or outs.keys() != want.keys():
                cs.fail(f"flash_decode's G = 1 bits differ from {path}")
    if args.gqa:
        cases = [("flash_decode", f"{arch} {label}", pos, n_live, heads)
                 for arch, heads in cs.REAL_HEADS.items()
                 if heads[0] != heads[1]
                 for label, pos, n_live in cs.GQA_DECODE_TIMED]
    else:
        cases = [(*c, (32, 32, 64))
                 for c in cs.ATTN_TIMED + (cs.VERIFY_TIMED,)]
    for name, label, pos, n_live, heads in cases:
        row = cs.time_paged_attention(torch, name, pos, n_live,
                                      checked=not args.unchecked,
                                      heads=heads, context=not args.gqa)
        print(json.dumps({"tree": args.label or str(src), "name": name,
                          "case": label, **row}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""What holds ``flash_decode`` back, measured on the card.

  python3 scripts/paged_attn_ablation.py [--gqa]

Writes patched copies of this checkout's ``src`` under
``build/paged_attn_ablation/<variant>/src`` and times each with
``scripts/paged_attn_times.py`` (one process a tree, in turns: kernel,
variants, variants reversed, kernel), printing the ``flash_decode`` rows
(``B 4`` and ``long``; ``--gqa``: every grouped-query layout's short and
long rows, on the split route):

* ``kernel``: the committed body;
* ``no_math``: the warps of the SIMT bodies (the slot route's and the
  split route's) skip every tile's dots, softmax and P V (the loads,
  barriers and the merges stay), so what is left is the load pipeline;
* ``no_table``: the page table is not read (logical page p is physical
  page p + 1), so the difference is the gather through the table.

The patched copies compute other values, so they are timed with
``--unchecked``; the committed kernel is checked against its plain
version. Needs one CUDA card.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "paged_attn_ablation"
DECODE = "repro_torch/csrc/flash_decode.cu"
HEADER = "repro_torch/csrc/paged_attn.cuh"
# (file, old, new) substitutions a variant
VARIANTS = {
    "no_math": [(DECODE, "    if (n_rows == 0) continue;\n",
                 "    continue;\n")],
    "no_table": [(HEADER, "static_cast<int64_t>(tbl[pg - pg0])",
                  "static_cast<int64_t>(pg + 1)")],
}


def make_tree(name, subs) -> Path:
    dst = OUT / name / "src"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "src", dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path, old, new in subs:
        text = (dst / path).read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {path} no longer has the "
                               f"patched text {old.strip()[:40]!r}")
        (dst / path).write_text(text.replace(old, new))
    return dst


def times(src: Path, label: str, checked: bool, gqa: bool):
    cmd = [sys.executable, str(ROOT / "scripts" / "paged_attn_times.py"),
           "--src", str(src), "--label", label] + (["--gqa"] if gqa else [])
    out = subprocess.run(cmd + ([] if checked else ["--unchecked"]),
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"{label}: {out.stderr[-2000:]}")
    rows = [json.loads(x) for x in out.stdout.splitlines()
            if x.startswith("{")]
    card = out.stdout.splitlines()[0]
    return card, [r for r in rows if r["name"] == "flash_decode"]


def main():
    gqa = "--gqa" in sys.argv[1:]
    trees = {"kernel": (ROOT / "src", True)}
    for name, subs in VARIANTS.items():
        trees[name] = (make_tree(name, subs), False)
    order = ["kernel", *VARIANTS, *reversed(list(VARIANTS)), "kernel"]
    card = None
    for label in order:
        src, checked = trees[label]
        card, rows = times(src, label, checked, gqa)
        for r in rows:
            print(json.dumps({"tree": label, "case": r["case"],
                              "ms": r["ms"], "bound_ms": r["bound_ms"],
                              "library_ms": r["library_ms"]}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Registers, spills and stack of every kernel instantiation, from ptxas.

  python3 scripts/ptxas_registers.py [--hd 112] [--sass] [file.cu ...]

Compiles each named source of ``src/repro_torch/csrc`` (default: the four
attention kernels) with the build's flags plus ``-Xptxas -v``, one
``nvcc`` each, in parallel, into ``build/ptxas/``, and prints one JSON
line an instantiation: the demangled kernel, its registers a thread,
spill stores and loads (bytes), stack frame (bytes) and static shared
memory. ``--hd N`` keeps the instantiations whose template arguments
name head dim N; ``--sass`` adds each one's count of local-memory
stores and loads (``STL``, ``LDL``) and of calls (``CALL``) in its SASS
(``cuobjdump``), which says where a spill sits. Needs the CUDA toolkit
(``nvcc``, ``cu++filt``, ``cuobjdump``); no card. Exits non-zero if a
compile fails or a kept instantiation spills.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "ptxas"
ATTENTION = ("flash_attention.cu", "flash_decode.cu", "flash_prefill.cu",
             "flash_verify.cu")

_ENTRY = re.compile(r"Compiling entry function '(\S+)' for '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def _tool(name: str) -> str:
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(found).exists():
        sys.exit(f"{name} not found: the CUDA toolkit is needed")
    return found


def parse(log: str):
    """(mangled name, stack, spill stores, spill loads, registers, smem)
    of each entry function in a ptxas -v log."""
    rows, cur = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"mangled": m.group(1)}
            continue
        if cur is None:
            continue
        m = _FRAME.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = _USED.search(line)
        if m:
            cur.update(registers=int(m.group(1)),
                       smem=int(m.group(2) or 0))
            rows.append(cur)
            cur = None
    return rows


def sass_counts(cuobjdump: str, obj: Path) -> dict:
    """{mangled function: {"STL": n, "LDL": n, "CALL": n}} of an object's
    SASS."""
    text = subprocess.run([cuobjdump, "-sass", str(obj)], text=True,
                          capture_output=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), {"STL": 0, "LDL": 0, "CALL": 0})
        elif cur is not None:
            for op in cur:
                if re.search(rf"\b{op}(\.|\s)", line):
                    cur[op] += 1
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="*", default=list(ATTENTION))
    ap.add_argument("--hd", type=int, default=None,
                    help="keep instantiations naming this head dim")
    ap.add_argument("--sass", action="store_true",
                    help="count STL / LDL / CALL in each one's SASS")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import NVCC_FLAGS
    nvcc, filt = _tool("nvcc"), _tool("cu++filt")
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {src: subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / src), "-o",
         str(OUT / (Path(src).stem + ".o"))], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for src in args.sources}
    bad = []
    for src, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            print(log, file=sys.stderr)
            sys.exit(f"{src}: nvcc failed")
        sass = (sass_counts(_tool("cuobjdump"), OUT / (Path(src).stem + ".o"))
                if args.sass else {})
        for row in parse(log):
            counts = sass.get(row["mangled"])
            name = subprocess.run([filt, row["mangled"]], text=True,
                                  capture_output=True).stdout.strip()
            if args.hd is not None and not re.search(
                    rf"[<, )]{args.hd}[,>]", name):
                continue
            row = {"source": src, "kernel": name,
                   **{k: v for k, v in row.items() if k != "mangled"},
                   **({"sass": counts} if counts else {})}
            print(json.dumps(row), flush=True)
            if row.get("spill_stores") or row.get("spill_loads"):
                bad.append(name)
    if bad:
        sys.exit(f"spills in {bad}")


if __name__ == "__main__":
    main()

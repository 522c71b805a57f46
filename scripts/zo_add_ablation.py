#!/usr/bin/env python3
"""What holds the zo_add family back, measured on the card.

  python3 scripts/zo_add_ablation.py

Writes patched copies of this checkout's ``src`` under
``build/zo_add_ablation/<variant>/src`` and times each with
``scripts/zo_add_times.py --rademacher`` (one process a tree, in turns:
kernel, variants, variants reversed, kernel), printing the Rademacher
times of ``zo_add`` (bf16), ``zo_add_q`` (int8) and ``zo_add_users`` (4
f32 lanes) on OPT-1.3B's stacked ``w_in`` and LM head beside their bytes
bound:

* ``kernel``: the committed stream;
* ``no_hash``: no per-element hash (c is added as it is) in ``zo_add``'s
  stream and in ``zo_add_q``, the row's hash and the odometer stay;
* ``no_row``: no per-vector row hash (the leaf's base stands for it);
* ``copy``: neither, nor the add: the grid-stride copy with its
  odometer, the floor of this loop (``zo_add``'s stream);
* ``q_unroll1``: ``zo_add_q`` with one vector in flight a thread (the
  committed one keeps 4);
* ``no_cs``: plain loads and stores, without the streaming cache hints;
* ``q_no_scale``: ``zo_add_q`` without its scale loads (s = 1).

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
OUT = ROOT / "build" / "zo_add_ablation"
SOURCE = "repro_torch/csrc/zo_add.cu"
HASH = ("    const float cz = c_times_z<DIST>(avalanche(h_row ^ cp), coeff);\n",
        "    const float cz = coeff;\n")
ROW = ("perturb_in_row<T, VEC, DIST>(x, odometer_hash(o, s, base),",
       "perturb_in_row<T, VEC, DIST>(x, base,")
COPY = ("""    perturb_in_row<T, VEC, DIST>(x, odometer_hash(o, s, base),
                                 o.col + off_col, p_last, coeff);""", "")
Q_HASH = ("                           c_times_z<DIST>(avalanche(h_row ^ cp), "
          "coeff));", "                           coeff);")
VARIANTS = {
    "no_hash": [HASH, Q_HASH],
    "no_row": [ROW],
    "copy": [COPY],
    "q_unroll1": [("constexpr int kQUnroll = 4;",
                   "constexpr int kQUnroll = 1;")],
    "no_cs": [("r.u = __ldcs(reinterpret_cast<const uint4*>(p));",
               "r.u = *reinterpret_cast<const uint4*>(p);"),
              ("__stcs(reinterpret_cast<uint4*>(p), r.u);",
               "*reinterpret_cast<uint4*>(p) = r.u;"),
              ("          __stcs(reinterpret_cast<float4*>(op),\n"
               "                 make_float4(r[0], r[1], r[2], r[3]));",
               "          *reinterpret_cast<float4*>(op) =\n"
               "              make_float4(r[0], r[1], r[2], r[3]);"),
              ("r.u = __ldcs(reinterpret_cast<const unsigned*>(p));",
               "r.u = *reinterpret_cast<const unsigned*>(p);")],
    "q_no_scale": [("            sc[0] = f.x;\n"
                    "            sc[1] = f.y;\n"
                    "            sc[2] = f.z;\n"
                    "            sc[3] = f.w;",
                    "            sc[0] = sc[1] = sc[2] = sc[3] = 1.0f;"),
                   ("            const float4 f = __ldg(reinterpret_cast"
                    "<const float4*>(sp));\n", "")],
}


def make_tree(name, subs) -> Path:
    dst = OUT / name / "src"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "src", dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    text = (dst / SOURCE).read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: the source no longer has the "
                               f"patched text {old.strip()[:40]!r}")
        text = text.replace(old, new)
    (dst / SOURCE).write_text(text)
    return dst


def times(src: Path, label: str, checked: bool):
    cmd = [sys.executable, str(ROOT / "scripts" / "zo_add_times.py"),
           "--src", str(src), "--label", label, "--rademacher"]
    out = subprocess.run(cmd + ([] if checked else ["--unchecked"]),
                         capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(f"{label}: {out.stderr[-2000:]}")
    rows = [json.loads(x) for x in out.stdout.splitlines()
            if x.startswith("{")]
    return out.stdout.splitlines()[0], rows


def main():
    trees = {"kernel": (ROOT / "src", True)}
    for name, subs in VARIANTS.items():
        trees[name] = (make_tree(name, subs), False)
    order = ["kernel", *VARIANTS, *reversed(list(VARIANTS)), "kernel"]
    card = None
    for label in order:
        src, checked = trees[label]
        card, rows = times(src, label, checked)
        for r in rows:
            print(json.dumps({"tree": label, "name": r["name"],
                              "leaf": r["leaf"], "ms": r["ms"],
                              "bound_ms": r["bound_ms"]}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()

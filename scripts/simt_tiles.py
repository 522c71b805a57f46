#!/usr/bin/env python3
"""Every tile of ``zo_matmul``'s SIMT body at the T0 shapes, on the card.

  python3 scripts/simt_tiles.py

Builds one patched copy of ``src/repro_torch/csrc/zo_matmul.cu`` a tile
of ``zo_perturb.SIMT_TILES`` whose launcher (``pick_tile``) always takes
that tile (one ``nvcc`` each, in parallel, into ``build/simt_tiles/``),
and times ``repro_zo_matmul`` of each beside the committed kernel (the
launcher's own pick) and cuBLAS SGEMM of ``X.float() @ W'`` (TF32 off)
with ``chip_smoke.time_interleaved`` (CUDA-graph replays, 5 rounds,
medians) at ``chip_smoke.SIMT_MM_TIMED``'s shapes. Every copy's output
must equal the committed kernel's at atol 0 (the tile leaves each
output's bits as they are), and the committed kernel's the plain version
within the T0 limits. Also prints, at RoBERTa-large's ``w_in`` shape
(every tile gives an SM the same outputs there), each tile's outputs an
SM a second in % of the first tile's: the launcher's ``kEff``. Needs one
CUDA card and the CUDA toolkit. Prints the card's name and power limit,
then one JSON line a shape.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "simt_tiles"
PICK = "int pick_tile(int64_t m, int64_t n, int64_t lanes, int64_t sms) {\n"


def build_tiles(nvcc: str, n_tiles: int, signature) -> dict:
    """{tile index: repro_zo_matmul of the copy fixed to that tile}."""
    csrc = ROOT / "src/repro_torch/csrc"
    src = (csrc / "zo_matmul.cu").read_text()
    if PICK not in src:
        raise RuntimeError("zo_matmul.cu no longer has pick_tile's head")
    procs = {}
    for i in range(n_tiles):
        d = OUT / f"tile{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "zo_matmul.cu").write_text(
            src.replace(PICK, PICK + f"  if (sms > 0) return {i};\n"))
        (d / "zo_hash.cuh").write_text((csrc / "zo_hash.cuh").read_text())
        procs[i] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", "-o",
             str(d / "lib.so"), str(d / "zo_matmul.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for i, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for tile {i}:\n{out}")
        fn = ctypes.CDLL(str(OUT / f"tile{i}" / "lib.so")).repro_zo_matmul
        fn.argtypes = signature
        fn.restype = ctypes.c_int
        fns[i] = fn
    return fns


def main():
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("torch.cuda is not available: this script needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    from repro_torch.kernels import build
    from repro_torch.kernels import zo_perturb as zp
    build.library()
    tiles = zp.SIMT_TILES
    fns = build_tiles(build._nvcc(), len(tiles),
                      build._SIGNATURES["repro_zo_matmul"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(5)
    coeff = 1e-3
    for case, m, k, n, dt, dist, path, layer in cs.SIMT_MM_TIMED:
        dt = getattr(torch, dt)
        x, w, kw = cs.mm_case(torch, gen, m, k, n, dt, path, layer)
        got = zp.zo_matmul_cuda(x, w, coeff=coeff, dist=dist, **kw)
        want = zp.zo_matmul_ref(x, w, coeff=coeff, dist=dist, **kw).float()
        tol = cs.ZO_MM_F32_RTOL if dt == torch.float32 \
            else cs.ZO_MM_BF16_RTOL
        err = ((got.float() - want).abs().max() / want.abs().max()).item()
        cs.check(err <= tol, f"zo_matmul {case}: {err} > {tol}")
        del want
        args = (x.data_ptr(), w.data_ptr(), None, zp._DTYPES[dt], m, k, n,
                zp._base(kw["seed"], kw["salt"], kw["prehashed"]),
                kw["prime_offset"], coeff, zp._DISTS[dist], 0, 0)
        calls = {"kernel": lambda: zp.zo_matmul_cuda(x, w, coeff=coeff,
                                                     dist=dist, **kw)}
        for i, fn in fns.items():
            y = torch.empty_like(got)

            def call(fn=fn, y=y, i=i):
                rc = fn(args[0], args[1], y.data_ptr(), *args[3:],
                        torch.cuda.current_stream().cuda_stream)
                cs.check(rc == 0, f"tile {i}: launch error {rc}")
                return y
            cs.check(torch.equal(call(), got),
                     f"{case}: tile {tiles[i]} differs from the kernel")
            calls[f"tile{i}"] = call
        xf, wp = cs.mm_library(torch, x, w, coeff, dist, kw)
        calls["sgemm"] = lambda: xf @ wp
        t = cs.time_interleaved(torch, calls)
        row = {"case": case, "shape": [m, k, n], "dtype": str(dt),
               "dist": dist, "rel_err": err,
               "picked": list(zp.simt_tile(m, n)), "kernel_ms": t["kernel"],
               "sgemm_ms": t["sgemm"],
               "tile_ms": {f"{bm}x{bn}": t[f"tile{i}"]
                           for i, (bm, bn) in enumerate(tiles)}}
        if case == "roberta w_in slice":
            # outputs an SM runs, over the time: each tile in % of tile 0's
            rate = [math.ceil(math.ceil(m / bm) * math.ceil(n / bn) / sms)
                    * bm * bn / t[f"tile{i}"]
                    for i, (bm, bn) in enumerate(tiles)]
            row["eff_pct"] = [100.0 * r / rate[0] for r in rate]
        print(json.dumps(row), flush=True)
        del x, w, got, xf, wp, calls
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

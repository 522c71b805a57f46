#!/usr/bin/env python3
"""Time the SIMT bodies of ``zo_matmul`` and ``flash_attention`` of two
source trees on the card, in turns, beside their library calls.

  python3 scripts/simt_times.py --src DIR [--label NAME]

Builds this checkout's kernels (``src/repro_torch/csrc``) and those of
``DIR/repro_torch/csrc`` (e.g. the parent commit unpacked by ``git
archive`` under ``build/parent``: ``--src build/parent/src``) into two
libraries, loaded side by side, and times each case of ``chip_smoke.py``'s
``SIMT_MM_TIMED`` (RoBERTa-large's three projection shapes in f32, the
Gaussian arm at OPT-1.3B's ``w_in`` slice in bf16) and
``SIMT_ATTN_TIMED`` (RoBERTa-large's bidirectional attention in f32)
through both libraries' C entry points and through its library call
(cuBLAS SGEMM of ``X.float() @ W'``, TF32 off, W' made beforehand; every
SDPA backend that takes the case) in one ``time_interleaved`` call: CUDA
graph replays in turns, 5 rounds, medians. Each tree's output is first
held to the plain version at the T0 limits (2e-5 of max|Y| in f32, 1e-2
in bf16; attention 2e-5). Prints the card's name and power limit, then
one JSON line a case: both trees' ms, the library's, the bound and the
tile this tree's launcher picks.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def other_library(build, src: Path):
    """The kernels of another tree's ``repro_torch/csrc``, built as
    ``build.library()`` builds this tree's (one nvcc a source, sm_90a)
    into ``build/simt_times/<hash>``, with the two entry points timed
    here."""
    csrc = src / "repro_torch" / "csrc"
    cu, cuh = sorted(csrc.glob("*.cu")), sorted(csrc.glob("*.cuh"))
    if not cu:
        raise SystemExit(f"no CUDA sources under {csrc}")
    out = ROOT / "build" / "simt_times" / build._digest(cu + cuh)
    if not (out / build.LIB_NAME).exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        build._compile(out, cu)
    lib = ctypes.CDLL(str(out / build.LIB_NAME))
    for name in ("repro_zo_matmul", "repro_flash_attention"):
        fn = getattr(lib, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def zo_matmul_call(torch, lib, x, w, coeff, dist, kw):
    """``lib``'s ``repro_zo_matmul`` on (x, w) into a preallocated y, on
    the current stream, as ``zo_perturb.zo_matmul_cuda`` launches it."""
    from repro_torch.kernels import zo_perturb as zp
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), zp._DTYPES[x.dtype],
            m, k, n, zp._base(kw["seed"], kw["salt"], kw["prehashed"]),
            kw["prime_offset"], float(torch.tensor(coeff,
                                                   dtype=torch.float32)),
            zp._DISTS[dist], 0, 0)

    def call():
        rc = lib.repro_zo_matmul(
            *args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"repro_zo_matmul failed with error {rc}")
        return y
    return call


def attention_call(torch, lib, q, k, v, causal):
    """``lib``'s ``repro_flash_attention`` into a preallocated out."""
    from repro_torch.kernels import flash_attention as fa
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0, b,
            s, t, h, kvh, hd, int(causal), fa._scale(hd))

    def call():
        rc = lib.repro_flash_attention(
            *args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"repro_flash_attention failed with error "
                               f"{rc}")
        return out
    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the other tree's src directory")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("torch.cuda is not available: this script needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import zo_perturb as zp
    libs = {"tree": build.library(),
            "other": other_library(build, Path(args.src).resolve())}
    label = args.label or args.src
    gen = torch.Generator(device="cuda").manual_seed(5)
    coeff = 1e-3
    for case, m, k, n, dt, dist, path, layer in cs.SIMT_MM_TIMED:
        dt = getattr(torch, dt)
        x, w, kw = cs.mm_case(torch, gen, m, k, n, dt, path, layer)
        want = zp.zo_matmul_ref(x, w, coeff=coeff, dist=dist, **kw).float()
        tol = cs.ZO_MM_F32_RTOL if dt == torch.float32 \
            else cs.ZO_MM_BF16_RTOL
        calls = {name: zo_matmul_call(torch, lib, x, w, coeff, dist, kw)
                 for name, lib in libs.items()}
        errs = {}
        for name, call in calls.items():
            got = call().float()
            torch.cuda.synchronize()
            errs[name] = ((got - want).abs().max() / want.abs().max()).item()
            cs.check(errs[name] <= tol, f"{name} zo_matmul {case}: "
                     f"{errs[name]} > {tol}")
        del want
        xf, wp = cs.mm_library(torch, x, w, coeff, dist, kw)
        t = cs.time_interleaved(torch, {**calls, "sgemm": lambda: xf @ wp})
        del xf, wp
        row = cs._mm_row(dt == torch.bfloat16, m, k, n,
                         (m * k + k * n + m * n) * x.element_size(), 1,
                         {"kernel": t["tree"], "sgemm": t["sgemm"]},
                         gauss=dist == "gaussian")
        print(json.dumps({"kernel": "zo_matmul", "case": case,
                          "shape": [m, k, n], "dtype": str(dt), "dist": dist,
                          "tree_ms": t["tree"], "other_ms": t["other"],
                          "other": label, "library_ms": t["sgemm"],
                          "library": "sgemm", "bound_ms": row["bound_ms"],
                          "bound_by": row["bound_by"],
                          "tile": list(zp.simt_tile(m, n)),
                          "rel_err": errs}), flush=True)
        del x, w, calls
        torch.cuda.empty_cache()
    for case, b, s, h, kvh, hd, causal in cs.SIMT_ATTN_TIMED:
        q = torch.randn((b, s, h, hd), generator=gen, device="cuda")
        k = torch.randn((b, s, kvh, hd), generator=gen, device="cuda")
        v = torch.randn((b, s, kvh, hd), generator=gen, device="cuda")
        want = fa.flash_attention_ref(q, k, v, causal)
        calls = {name: attention_call(torch, lib, q, k, v, causal)
                 for name, lib in libs.items()}
        errs = {}
        for name, call in calls.items():
            errs[name] = (call() - want).abs().max().item()
            cs.check(errs[name] <= cs.ATTN_F32_ATOL,
                     f"{name} flash_attention {case}: {errs[name]}")
        qq, kk, vv = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        sdpa = cs.sdpa_backends(torch, lambda: F.scaled_dot_product_attention(
            qq, kk, vv, is_causal=causal, enable_gqa=kvh != h))
        t = cs.time_interleaved(torch, {**calls, **sdpa})
        lib_name = min(sdpa, key=t.get)
        n_bytes, flops = cs._flash_cost(b, s, s, h, kvh, hd, causal, 4)
        b_ms, b_by = cs.bound(n_bytes, flops, "f32")
        print(json.dumps({"kernel": "flash_attention", "case": case,
                          "shape": [b, s, h, kvh, hd], "causal": causal,
                          "tree_ms": t["tree"], "other_ms": t["other"],
                          "other": label, "library_ms": t[lib_name],
                          "library": lib_name,
                          "library_ms_by_call": {c: t[c] for c in sdpa},
                          "bound_ms": b_ms, "bound_by": b_by,
                          "max_abs_err": errs}), flush=True)


if __name__ == "__main__":
    main()

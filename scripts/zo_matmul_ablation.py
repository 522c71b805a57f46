#!/usr/bin/env python3
"""What holds the tensor-core ``zo_matmul`` body back, measured on the card.

  python3 scripts/zo_matmul_ablation.py

Builds patched copies of ``src/repro_torch/csrc/zo_matmul.cu`` (one
``nvcc`` each, in parallel, into ``build/zo_matmul_ablation/``) and times
``repro_zo_matmul`` of each beside the committed kernel and one bf16
cuBLAS product of the unperturbed W, with ``chip_smoke.time_interleaved``
(CUDA-graph replays, medians), at OPT-1.3B's training shapes (M = 1024):

* ``kernel``: the committed tensor-core body, Y = X W + c (X z);
* ``no_hash``: the producers write a z tile without hashing it (the
  same bf16 +-1 layout), so the difference is the hash's share;
* ``no_hash_no_z``: also without the consumers' X z product: one bf16
  product through the same ring and mainloop, to hold against cuBLAS.

The two patched copies compute other values; only the committed kernel is
checked, against the plain version (``ZO_MM_BF16_RTOL``). Needs one CUDA
card and the CUDA toolkit. Prints one JSON line a shape, then the card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "zo_matmul_ablation"
SHAPES = [(1024, 2048, 8192), (1024, 2048, 50272), (1024, 2048, 2048),
          (1024, 8192, 2048)]   # w_in, LM head, wq/wk/wv/wo, w_out

# the producers' hash of two z, and the consumers' X z product
HASH = ("            const uint32_t sa = z_sign(h_row, np);\n"
        "            const uint32_t sb = z_sign(h_row, np + p1);\n"
        "            np += 2u * p1;\n"
        "            o[e] = z_pair(sa, sb);")
NO_HASH = ("            o[e] = 0x3F803F80u ^ (np & 0x80000000u);\n"
           "            np += p1;")
Z_MMA = "        wgmma_64(acc_z[i], da, dz);\n"
VARIANTS = {"no_hash": [(HASH, NO_HASH)],
            "no_hash_no_z": [(HASH, NO_HASH), (Z_MMA, "")]}


def build_variants(nvcc: str, signature) -> dict:
    src = (ROOT / "src/repro_torch/csrc/zo_matmul.cu").read_text()
    header = (ROOT / "src/repro_torch/csrc/zo_hash.cuh").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has the "
                                   f"patched text {old[:40]!r}")
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "zo_matmul.cu").write_text(text)
        (d / "zo_hash.cuh").write_text(header)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", "-o",
             str(d / "lib.so"), str(d / "zo_matmul.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).repro_zo_matmul
        fn.argtypes = signature
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.core import rng
    from repro_torch.kernels import build
    from repro_torch.kernels import zo_perturb as zp
    build.library()
    fns = build_variants(build._nvcc(), build._SIGNATURES["repro_zo_matmul"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    seed, coeff = 99, 1e-3
    salt = rng.leaf_salt("lm_head/w")
    base = zp._base(seed, salt, False)
    for m, k, n in SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).bfloat16()
        got = zp.zo_matmul_cuda(x, w, seed, salt, coeff)
        want = zp.zo_matmul_ref(x, w, seed, salt, coeff)
        err = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        cs.check(err <= cs.ZO_MM_BF16_RTOL, f"kernel {m, k, n}: {err}")
        del got, want
        calls = {"kernel": lambda: zp.zo_matmul_cuda(x, w, seed, salt,
                                                     coeff)}
        for name, fn in fns.items():
            def call(fn=fn):
                y = torch.empty((m, n), dtype=x.dtype, device=dev)
                rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), 1, m, k, n,
                        base, 0, coeff, 0,
                        torch.cuda.current_stream().cuda_stream)
                cs.check(rc == 0, f"{name}: launch error {rc}")
                return y
            calls[name] = call
        calls["cublas_bf16"] = lambda: x @ w
        t = cs.time_interleaved(torch, calls, iters=100)
        print(json.dumps({"shape": [m, k, n], "rel_err": err,
                          **{f"{name}_ms": v for name, v in t.items()}}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""What holds the tensor-core ``zo_matmul`` bodies back, measured on the card.

  python3 scripts/zo_matmul_ablation.py [--only opt] [--before FILE]

Builds patched copies of ``src/repro_torch/csrc/zo_matmul.cu`` (one
``nvcc`` each, in parallel, into ``build/zo_matmul_ablation/``) and times
each beside the committed kernel and one bf16 cuBLAS product of the
unperturbed W, with ``chip_smoke.time_interleaved`` (CUDA-graph replays,
medians), at the OPT-1.3B cells' products: M 8192 (B 16 x S 512) through
``repro_zo_matmul``, and 16 lanes of M 1024 (B 4 x S 256) over 8 stacked
W lanes through ``repro_zo_matmul_users``:

* ``kernel``: the committed route, the Hopper body (TMA, 2-CTA clusters,
  one n256 ``wgmma`` over the joint [W | z] tile), Y = X W + c (X z);
* ``before`` (with ``--before FILE``): another commit's
  ``zo_matmul.cu``, built as it is -- e.g. the 256 x 64 body (cp.async,
  two n64 products a 64-row tile) that these shapes took before the
  Hopper body: ``git show <rev>:src/repro_torch/csrc/zo_matmul.cu >
  FILE``;
* ``cluster4``: the Hopper body on 4-CTA clusters (z hashed once per
  512 rows, each CTA loading and hashing a quarter of a stage's rows);
* ``no_peer_z``: the Hopper body with each CTA's z rows written into its
  own ring alone (the other CTAs' consumers then read z rows that nobody
  wrote), so the difference is the writes across the cluster;
* ``no_hash``: the Hopper body's producers write a z tile without hashing
  it (the same bf16 +-1 layout and stores), so the difference is the
  hash's share;
* ``no_hash_no_z``: also without the X z half: an n128 ``wgmma`` over W
  alone, one bf16 product through the same ring, to hold against cuBLAS.

The other patched copies compute other values; the kernel,
``cluster4`` and ``before`` are checked against the plain version
(``ZO_MM_BF16_RTOL``). Needs one CUDA card and the CUDA toolkit. Prints
one JSON line a shape, then the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "zo_matmul_ablation"
# (lanes, M a lane, K, N): q/k/v/o, w_in, w_out of each OPT cell
SHAPES = [(1, 8192, 2048, 2048), (1, 8192, 2048, 8192),
          (1, 8192, 8192, 2048), (16, 1024, 2048, 2048),
          (16, 1024, 2048, 8192), (16, 1024, 8192, 2048)]
W_LANES = 8

# the Hopper body's hash of two z, its writes into the other CTA's ring
# (and their bytes on the full barrier), its joint product, and the route
# rule
HASH = "o[e] = z_pair(z_sign(h_row, np), z_sign(h_row, np + p1));"
NO_HASH = "o[e] = 0x3F803F80u ^ (np & 0x80000000u);"
PEER_Z = ("          for (int r = 0; r < kCluster; ++r)\n"
          "            st_async(rings[r] + 2 * s * STAGE + zoff[j], o, fulls[r] + 8 * s);\n")
OWN_Z = "          st_async(rings[rank] + 2 * s * STAGE + zoff[j], o, fulls[rank] + 8 * s);\n"
PEER_BYTES = "+ W_BYTES + Z_BYTES);"
JOINT = "wgmma_256(acc,"
# an n128 product over the joint tile's first 128 columns (W)
N128 = '''
#define REPRO_F8(i)                                                        \\
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \\
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_128(float (&d)[128], uint64_t da,
                                          uint64_t db, bool accumulate) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "''' + ", ".join(f"%{i}" for i in range(64)) + '''}, "
      "%64, %65, p, 1, 1, 0, 1;\\n}\\n"
      : REPRO_F8(0), REPRO_F8(8), REPRO_F8(16), REPRO_F8(24), REPRO_F8(32),
        REPRO_F8(40), REPRO_F8(48), REPRO_F8(56)
      : "l"(da), "l"(db), "r"(static_cast<int>(accumulate)));
}
#undef REPRO_F8

'''
ANCHOR = "// Output tile `tile` of a launch"
VARIANTS = {"cluster4": [("constexpr int kCluster = 2;",
                          "constexpr int kCluster = 4;")],
            "no_peer_z": [(PEER_Z, OWN_Z),
                          (PEER_BYTES, "+ W_BYTES + Z_BYTES / kCluster);")],
            "no_hash": [(HASH, NO_HASH)],
            "no_hash_no_z": [(HASH, NO_HASH), (JOINT, "wgmma_128(acc,"),
                             (ANCHOR, N128 + ANCHOR)]}
CHECKED = ("kernel", "cluster4", "before")


def variant_sources(before=None) -> dict:
    """Each variant's source: the patched copies, and ``before``'s file."""
    src = (ROOT / "src/repro_torch/csrc/zo_matmul.cu").read_text()
    texts = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source has the patched text "
                                   f"{old[:40]!r} {text.count(old)} times")
            text = text.replace(old, new)
        texts[name] = text
    if before is not None:
        texts["before"] = Path(before).read_text()
    return texts


def build_variants(nvcc: str, signatures, before=None) -> dict:
    header = (ROOT / "src/repro_torch/csrc/zo_hash.cuh").read_text()
    procs = {}
    for name, text in variant_sources(before).items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "zo_matmul.cu").write_text(text)
        (d / "zo_hash.cuh").write_text(header)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", "-o",
             str(d / "lib.so"), str(d / "zo_matmul.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("opt", "tenants"), default=None,
                    help="the single-lane (opt) or 16-lane shapes alone")
    ap.add_argument("--before", default=None, metavar="FILE",
                    help="another commit's zo_matmul.cu, timed as `before`")
    args = ap.parse_args()
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
    libs = build_variants(build._nvcc(), {
        f: build._SIGNATURES[f] for f in ("repro_zo_matmul",
                                          "repro_zo_matmul_users")},
        args.before)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    coeff = 1e-3
    salt = rng.leaf_salt("blocks/mlp/w_in/w")
    shapes = [s for s in SHAPES if args.only is None
              or (s[0] == 1) == (args.only == "opt")]
    for lanes, m, k, n in shapes:
        seeds = list(range(99, 99 + lanes))
        bases = [zp._base(s, salt, False) for s in seeds]
        x = torch.randn((lanes, m, k), generator=gen, device=dev).bfloat16()
        w = (torch.randn((W_LANES if lanes > 1 else 1, k, n), generator=gen,
                         device=dev) * 0.02).bfloat16()
        stride = k * n if lanes > 1 else 0
        cb = (ctypes.c_uint32 * lanes)(*bases)
        cc = (ctypes.c_float * lanes)(*[coeff] * lanes)

        def call(lib):
            y = torch.empty((lanes, m, n), dtype=x.dtype, device=dev)
            st = torch.cuda.current_stream().cuda_stream
            if lanes == 1:
                rc = lib.repro_zo_matmul(x.data_ptr(), w.data_ptr(),
                                         y.data_ptr(), 1, m, k, n, bases[0],
                                         0, coeff, 0, 0, 0, st)
            else:
                rc = lib.repro_zo_matmul_users(
                    x.data_ptr(), w.data_ptr(), y.data_ptr(), 1, m, k, n,
                    stride, W_LANES, cb, cc, lanes, 0, 0, st)
            cs.check(rc == 0, f"launch error {rc}")
            return y

        calls = {"kernel": lambda: call(build.library()),
                 **{name: (lambda lib=lib: call(lib))
                    for name, lib in libs.items()}}
        errs = {}
        for name in (c for c in CHECKED if c in calls):
            got = calls[name]()
            want = zp.zo_matmul_users_ref(x, w if lanes > 1 else w[0],
                                          seeds, salt, [coeff] * lanes)
            errs[name] = ((got.float() - want.float()).abs().max()
                          / want.float().abs().max()).item()
            cs.check(errs[name] <= cs.ZO_MM_BF16_RTOL,
                     f"{name} {lanes, m, k, n}: {errs[name]}")
            del got, want
        wl = w[torch.arange(lanes, device=dev) % w.shape[0]]
        calls["cublas_bf16"] = lambda: torch.bmm(x, wl)
        t = cs.time_interleaved(torch, calls, iters=20)
        bound = 2 * lanes * m * k * n / 989e12 * 1e3
        print(json.dumps({"shape": [lanes, m, k, n], "bound_ms": bound,
                          "rel_err": errs,
                          **{f"{name}_ms": v for name, v in t.items()},
                          "kernel_roofline_pct": 100 * bound / t["kernel"]}),
              flush=True)
        del x, w, wl
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA card (written for an H100) and the CUDA toolkit. Phases:

1. device: the card's name and power limit; TF32 off.
2. build: every kernel of ``src/repro_torch/csrc`` with nvcc for sm_90a.
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the main paths' shapes, with its time, the plain version's,
   one library call's where there is one, and the bound (the larger of
   bytes over 3.35 TB/s and operations over the peak rate of their type;
   bf16 tensor cores for the bf16 bodies of ``zo_matmul*`` and
   ``flash_attention``, their SIMT f32 bound beside it). A kernel and its
   library calls are timed in one process, in turns, as CUDA-graph
   replays (5 rounds of 200 calls, medians; ``time_interleaved``): every
   SDPA backend that takes the case, the fastest named as the library;
   cuBLAS SGEMM for the ``zo_matmul`` family, with bf16 cuBLAS of the
   unperturbed W beside it as the product's floor:
   ``zo_add``, ``flash_decode``, ``flash_prefill``; T0 ``zo_matmul`` and
   ``flash_attention``; Q0 ``zo_add_q`` and ``zo_matmul_q``; S0
   ``flash_verify`` (B 4, W 4, 32 heads of 64, page 16, positions 96-128,
   f32 and bf16, two GQA layouts, NaN in the trash page). The paged
   ``flash_decode`` / ``flash_prefill`` are checked at pages 8 and 16,
   f32 and bf16, KV 32 and 8, on ragged serving positions, the edges of
   a 64-key tile and a context up to 2048 (``ATTN_CHECKED``): two calls
   bit-equal, NaN in the trash page and in each slot's unread last-page
   tail leaving the output bit-equal, prefill's bf16 launches on its
   tensor-core body and f32 on its SIMT body; and timed in bf16 at B 4
   (the rows timed since the first port), at the serving admission's B 1
   prefill and a decode at positions up to 2047 (``ATTN_TIMED``), with
   the page gather + SDPA in one graph beside the pre-gathered
   yardstick, as context.
4. serving: ``repro_torch.launch.serve.run`` on full-width, 24-layer
   OPT-1.3B (bf16, random weights from a seed), paged KV with page size 16
   and chunked prefill C = 32, 4 slots, 8 greedy requests (96-token
   prompts, 32 new tokens): the CLI's six round-robin over two replayed
   ZO adapters, two more submitted for the base. The first-step logits must agree with the dense-mode engine
   (plain attention) within a bf16 tolerance, and a user's must differ
   from the base's on one prompt.
5. profile: a shorter run of the same path (4 requests, 16 new tokens)
   under ``torch.profiler``: the device's busy share of the serving wall
   time and the kernels that take the most device time.
S1. phase 4's requests with ``--spec-k 3`` (the base drafts through
   ``flash_decode``, each user's weights verify through ``flash_verify``):
   tokens held to phase 4's under the near-tie rule of
   ``_hold_to_plain``, acceptance, rounds, decode tok/s, TTFT, and the
   launches a call read off the code (24 a draft step, 24 a verify).
S2. a user with lr 1e-6 records (4 requests + 2 base): acceptance above
   0.9, fewer rounds than half the decode tokens, the plain tokens.
S4. 4 sampled requests (top-k 8) with ``--spec-k 3``: full length, two
   runs from one seed give the same tokens.
S5. phase 5's profile with ``--spec-k 3``.
T1. the train CLI (``launch.train.run``), full-width OPT-1.3B,
   ``mezo-fused``, 4 steps at B 8 x S 128: losses, step time, tokens/s,
   peak memory, launch counts, and a step-0 snapshot + replay-log restore
   bit-exact with the live parameters.
T4. one T1 step under the profiler.
T2. / T3. the Trainer with flash attention (OPT-1.3B, then RoBERTa-large,
   f32): 2 fused steps, the first loss against the materialized one.
Q1. the frozen int8 base: OPT-1.3B (bf16) and RoBERTa-large (f32)
   quantized with no deltas; the fused loss at +-eps (every projection
   through ``zo_matmul_q``) against the loss at ``ctx.materialize``
   (every quantized leaf through ``zo_add_q``); resident bytes and the
   fused forward's peak memory.
Q2. the train CLI with ``--quant int8`` (OPT-1.3B, ``mezo-fused``, 4 steps
   at B 8 x S 128): losses, step time, tokens/s, peak memory; q and scales
   bit-frozen, deltas moved; a bit-exact snapshot + replay restore; one
   step under the profiler.
Q3. serving phase 4's requests from one int8 base holding the two
   replayed users: within 0.15 of the dense-mode engine, a user differs
   from the base, the cache charges only per-user bytes; then one user's
   compact int8 delta (``export_delta`` -> ``put_delta``) against the
   replayed user's weights, serving the same requests closer to the
   replayed user than to the base.
S3. Q3's int8 base with ``--spec-k 3``, tokens held to Q3's plain ones
   under S1's rule.
U0. ``zo_add_users`` (U = 4 stacked f32 deltas of OPT-1.3B's ``w_in`` and
   LM head), ``zo_matmul_users`` (X (4, 1024, 2048) bf16 over a shared and
   a per-lane W) and ``zo_matmul_users(scale=)`` (a shared int8 W) at the
   ``w_in`` slice and LM head shapes: against their plain versions, every
   lane against a lone scalar launch at atol 0; times, bounds, and the
   library yardstick (one cuBLAS SGEMM ``torch.bmm``, TF32 off); and a
   bf16 (4, 24, 2048, 8192) stack updated in place on lanes 0 and 2 (U1's
   use), the other lanes bit-unchanged.
U1. the ``train_fleet`` CLI at full width (OPT-1.3B, 6 users on 4 slots,
   3 fused sgd steps each, B 8 x S 128): launches a dispatch (independent
   of U), every user's losses, parameters and replay log against a lone
   Trainer at atol 0, one eviction and re-admission bit-exact; U4 one of
   its dispatches under the profiler.
U2. the same with ``--quant int8``: q and scales frozen and shared by the
   slots.
U3. the user-axis fused loss over one shared base (bf16, then a frozen int8
   base), U = 4: every lane's loss equal to the scalar fused loss.
Then one ``{"kernels": [...]}`` line (each kernel with its launches on
every path above; each must have launched on one) and the final
``{"ok": true, ...}``.

Launch counts are reset just before each path and read just after, by
kernel and, for the two-body kernels, by body (``ops.BODIES``): T1-T4,
Q1, U1 and U3 must run every ``zo_matmul*`` / ``flash_attention``
launch on the body the dtype picks (bf16: tensor cores, f32: SIMT), and
the bf16 serving paths (phase 4, Q3, S1-S4) every ``flash_prefill``
launch on its tensor-core body. Any
failed check exits non-zero before the final line. Imports nothing of JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
WORK = ROOT / "build" / "chip_smoke"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# tolerances, stated before the first run on the card
ZO_GAUSS_ATOL = 1e-6     # f32 z: last ulps of logf/cosf only (no FMA)
ATTN_BF16_ATOL = 2e-2    # bf16 out: the plain version rounds probs to bf16
ATTN_F32_ATOL = 2e-5     # f32 out: summation order only
LOGITS_BF16_ATOL = 0.15  # 24 bf16 layers, chunked kernels vs dense plain
ZO_MM_F32_RTOL = 2e-5    # max|d| / max|Y|, f32 out: summation order only
ZO_MM_BF16_RTOL = 1e-2   # bf16 out: one rounding of Y (2^-8 relative)
OPT_FUSED_ATOL = 2e-2    # bf16: also the rounding of W' the materialized
#                          path does and the fused (f32 W') path does not
ROBERTA_FUSED_ATOL = 1e-4  # f32: summation order over 24 layers only
#   the same two limits hold Q1's frozen int8 base (fused f32 W' against
#   the materialized W' rounded to the leaf's dtype)
Q_EFF_ATOL = 1e-7        # + max|mat - base| / 127: one int8 step of the
#                          compact delta (tests/test_quant.py's bound, for
#                          f32 effective weights; a bf16 leaf adds one
#                          bf16 step of its own rounding)

# the training phases' shapes: full width and depth, batch 8 x 128 tokens
TRAIN_STEPS, TRAIN_B, TRAIN_S = 4, 8, 128


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_interleaved(torch, fns: dict, iters: int = 200, repeats: int = 5):
    """Median ms a call of each of ``fns`` (name -> fn, or name -> (fn,
    ctx) with ``ctx()`` a context manager held around the calls), timed in
    one process in turns: ``repeats`` rounds, each replaying every fn's
    CUDA graph of ``iters`` calls once between two CUDA events. Graph
    replays keep the host's launch cost out of the device time, so a
    kernel and its library call are compared on the card alone."""
    graphs = {}
    side = torch.cuda.Stream()
    for name, entry in fns.items():
        fn, ctx = entry if isinstance(entry, tuple) else (entry, None)
        with (ctx() if ctx else contextlib.nullcontext()):
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):          # warm-up off the graph
                fn()
                fn()
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(iters):
                    fn()
        graphs[name] = g
    torch.cuda.synchronize()
    samples: dict = {name: [] for name in fns}
    for _ in range(repeats):
        for name, g in graphs.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            samples[name].append(start.elapsed_time(end) / iters)
    del graphs
    torch.cuda.empty_cache()
    return {name: sorted(v)[len(v) // 2] for name, v in samples.items()}


def sdpa_backends(torch, call):
    """``{"sdpa_<backend>": (call, ctx)}`` for every SDPA backend that
    accepts ``call()``'s case (each one tried once under
    ``torch.nn.attention.sdpa_kernel``, eagerly and in a CUDA graph; one
    that refuses the case raises and is left out). The port calls none of
    them."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(be), warnings.catch_warnings():
                warnings.simplefilter("ignore")   # "kernel not used because"
                call()
                torch.cuda.synchronize()
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    call()
            torch.cuda.synchronize()
            del g
        except RuntimeError:
            torch.cuda.synchronize()
            continue
        out[f"sdpa_{be.name.lower()}"] = (call, lambda be=be: sdpa_kernel(be))
    check(bool(out), "no SDPA backend accepts the yardstick's case")
    return out


def kernel_vs_library(torch, kernel, library: dict, iters: int = 200):
    """The kernel and each library call through ``time_interleaved``:
    (kernel ms, fastest library ms, its name, every library ms)."""
    t = time_interleaved(torch, {"kernel": kernel, **library}, iters=iters)
    ms = t.pop("kernel")
    name = min(t, key=t.get)
    return ms, t[name], name, t


def bound(n_bytes: float, flops: float, kind: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def kernel_zo_add(torch, results):
    from repro_torch.core import rng
    from repro_torch.kernels import zo_perturb as zp
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    shapes = {"blocks/mlp/w_in/w": (24, 2048, 8192), "lm_head/w": (2048, 50272)}
    seed, coeff = 1234567, -0.00731
    for path, shape in shapes.items():
        w = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        salt = rng.leaf_salt(path)
        got = zp.zo_add_cuda(w, seed, salt, coeff)
        want = zp.zo_add_ref(w, seed, salt, coeff)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(torch.equal(got, want),
              f"zo_add {shape} Rademacher not bit-exact (max err {err})")
        n = w.numel()
        ms = time_ms(lambda: zp.zo_add_cuda(w, seed, salt, coeff, out=got),
                     iters=20)
        del want
        plain = time_ms(lambda: zp.zo_add_ref(w, seed, salt, coeff), iters=2,
                        warmup=1)
        b_ms, b_by = bound(4.0 * n, 2.0 * n, "f32")
        rows.append({"shape": list(shape), "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by})
        print(json.dumps({"phase": "kernel", "name": "zo_add",
                          "dist": "rademacher", "dtype": "bfloat16",
                          "shape": list(shape), "max_abs_err": err,
                          "tolerance": 0.0, "kernel_ms": ms,
                          "plain_ms": plain, "library_ms": None,
                          "bound_ms": b_ms, "bound_by": b_by}), flush=True)
        del w, got
        torch.cuda.empty_cache()
    # Gaussian: f32 zeros + 1.0 * z, so the output is z itself
    w = torch.zeros((2048, 8192), dtype=torch.float32, device=dev)
    salt = rng.leaf_salt("blocks/attn/wq/w")
    got = zp.zo_add_cuda(w, seed, salt, 1.0, dist="gaussian")
    want = zp.zo_add_ref(w, seed, salt, 1.0, dist="gaussian")
    gerr = (got - want).abs().max().item()
    check(gerr <= ZO_GAUSS_ATOL, f"zo_add Gaussian err {gerr} > "
          f"{ZO_GAUSS_ATOL}")
    check(abs(got.mean().item()) < 1e-2 and abs(got.std().item() - 1) < 1e-2,
          "zo_add Gaussian z is not N(0, 1)")
    print(json.dumps({"phase": "kernel", "name": "zo_add", "dist": "gaussian",
                      "dtype": "float32", "shape": [2048, 8192],
                      "max_abs_err": gerr, "tolerance": ZO_GAUSS_ATOL}),
          flush=True)
    # the path's two largest leaves together: one sweep's main cost
    results["zo_add"] = {
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "bytes", "library_ms": None}


def _paged_case(torch, b, ps, kvh, hd, n_live, pos, garbage):
    """Random pools with scrambled page tables; page 0 (trash) filled with
    ``garbage`` (a finite value or NaN)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    n_pages = 1 + b * n_live + 5
    k = torch.randn((n_pages, ps, kvh, hd), generator=gen, device=dev)
    v = torch.randn((n_pages, ps, kvh, hd), generator=gen, device=dev)
    k[0] = garbage
    v[0] = garbage
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    pages = torch.zeros((b, n_live), dtype=torch.int32, device=dev)
    for i, p in enumerate(pos):
        live = 1 + p // ps
        pages[i, :live] = perm[i * n_live:i * n_live + live].to(torch.int32)
    return k, v, pages, torch.tensor(pos, dtype=torch.int32, device=dev)


def _poison_unread(k, v, pages, last):
    """NaN wherever slot i's rows may not read: the trash page and, in
    each slot's last live page, the positions past ``last[i]``."""
    ps = k.shape[1]
    k[0], v[0] = float("nan"), float("nan")
    for i, t in enumerate(last):
        page = int(pages[i, t // ps])
        k[page, t % ps + 1:] = float("nan")
        v[page, t % ps + 1:] = float("nan")


def _attn_cost(q_rows_pos, kvh, g, hd, itemsize, q_numel):
    """Bytes and flops a paged attention call needs for this data: each
    row reads keys 0..qpos; K/V of a (slot, KV head) counted once at its
    longest row; q read, out written once."""
    keys = sum(max(r) + 1 for r in q_rows_pos)          # per KV head
    kv_bytes = 2 * keys * kvh * hd * itemsize
    flops = 4 * hd * g * kvh * sum(sum(p + 1 for p in r) for r in q_rows_pos)
    return kv_bytes + 2 * q_numel * itemsize, flops


ATTN_C = 32                  # the serving path's prefill chunk
# the paged kernels' correctness cases (phase 3): positions, n_live at
# page 16 (doubled at page 8): the serving path's ragged slots, the edges
# of a 64-key tile, and a long context up to OPT-1.3B's 2048 positions
ATTN_CHECKED = {"flash_decode": (([95, 110, 127, 40], 8),
                                 ([63, 64, 127, 128], 9),
                                 ([2047, 1640, 1480, 1030], 128)),
                "flash_prefill": (([64, 78, 96, 8], 8),
                                  ([63, 64, 127, 128], 11),
                                  ([2016, 1640, 1480, 1030], 128))}
# the timed cases, bf16 at OPT-1.3B's width (32 heads of 64, page 16):
# (kernel, label, positions, n_live). "B 4" keeps the shapes timed since
# the first port, "B 1" is the serving admission's prefill (one slot's
# chunk at a time), "long" a decode step at positions up to 2047
ATTN_TIMED = (("flash_decode", "B 4", [95, 110, 127, 40], 8),
              ("flash_decode", "long", [2047, 1640, 1480, 1030], 128),
              ("flash_prefill", "B 4", [64, 78, 96, 8], 8),
              ("flash_prefill", "B 1", [64], 8))


def _attn_fns(name):
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    if name == "flash_decode":
        return fd.flash_decode, fd.paged_attn_ref
    return fp.flash_prefill, fp.prefill_attn_ref


def check_paged_attention(torch):
    """Each paged kernel against its plain version at pages 8 and 16, f32
    and bf16, KV 32 (G 1) and 8 (G 4), on every ATTN_CHECKED case: within
    the limit, finite, two calls bit-equal, NaN in the trash page and in
    each slot's unread last-page tail leaving the output bit-equal, and
    every prefill launch on the body its dtype picks. Returns the worst
    error by kernel and dtype."""
    from repro_torch.kernels import build
    dev = torch.device("cuda")
    h, hd = 32, 64
    gen = torch.Generator(device=dev).manual_seed(3)
    errs: dict = {}
    for name, cases in ATTN_CHECKED.items():
        kern, ref = _attn_fns(name)
        c = 1 if name == "flash_decode" else ATTN_C
        for ps in (16, 8):
            for pos, n_live16 in cases:
                n_live = n_live16 * 16 // ps
                last = [p + c - 1 for p in pos]
                b = len(pos)
                for kvh in (32, 8):
                    for dt, tol in ((torch.float32, ATTN_F32_ATOL),
                                    (torch.bfloat16, ATTN_BF16_ATOL)):
                        label = (f"{name} {dt} page {ps} KV {kvh} pos "
                                 f"{pos}")
                        k, v, pages, _ = _paged_case(torch, b, ps, kvh, hd,
                                                     n_live, last, 1e4)
                        k, v = k.to(dt), v.to(dt)
                        pos_t = torch.tensor(pos, dtype=torch.int32,
                                             device=dev)
                        q_shape = (b, h, hd) if c == 1 else (b, c, h, hd)
                        q = torch.randn(q_shape, generator=gen,
                                        device=dev).to(dt)
                        body = "tc" if dt == torch.bfloat16 else "simt"
                        before = dict(build.BODIES)
                        got = kern(q, k, v, pages, pos_t)
                        if name == "flash_prefill":
                            moved = {bb: build.BODIES[f"{name}/{bb}"]
                                     - before[f"{name}/{bb}"]
                                     for bb in ("tc", "simt")}
                            check(moved[body] == 1 and sum(moved.values())
                                  == 1, f"{label}: bodies {moved}, "
                                        f"expected one {body}")
                        want = ref(q, k, v, pages, pos_t)
                        err = (got.float() - want.float()).abs().max().item()
                        check(err <= tol and torch.isfinite(got).all().item(),
                              f"{label}: max err {err} > {tol}")
                        check(torch.equal(kern(q, k, v, pages, pos_t), got),
                              f"{label}: two calls differ")
                        _poison_unread(k, v, pages, last)
                        check(torch.equal(kern(q, k, v, pages, pos_t), got),
                              f"{label}: NaN where no row reads reached the "
                              f"output")
                        key = (name, str(dt).split(".")[-1])
                        errs[key] = max(errs.get(key, 0.0), err)
    print(json.dumps({"phase": "kernel checks", "name": "paged attention",
                      "cases": {n: [p for p, _ in cs]
                                for n, cs in ATTN_CHECKED.items()},
                      "page_sizes": [16, 8], "kv_heads": [32, 8],
                      "max_abs_err": {f"{n} {d}": e
                                      for (n, d), e in errs.items()},
                      "tolerance_f32": ATTN_F32_ATOL,
                      "tolerance": ATTN_BF16_ATOL}), flush=True)
    return errs


def time_paged_attention(torch, name, pos, n_live, checked=True):
    """One ATTN_TIMED case in bf16: the kernel, its plain version, every
    SDPA backend over K/V gathered to logical order beforehand (the
    yardstick, as for every other attention row) and, as context only,
    every backend with the page gather and transposes inside the timed
    graph. ``checked``:
    the kernel's output is held to the plain version's first (off only
    for a deliberately patched tree, ``scripts/paged_attn_ablation.py``)."""
    import torch.nn.functional as F
    kern, ref = _attn_fns(name)
    dev = torch.device("cuda")
    h = kvh = 32
    hd, ps = 64, 16
    b = len(pos)
    rows = 1 if name == "flash_decode" else ATTN_C
    k, v, pages, _ = _paged_case(torch, b, ps, kvh, hd, n_live,
                                 [p + rows - 1 for p in pos], 0.0)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    q_shape = (b, h, hd) if rows == 1 else (b, rows, h, hd)
    q = torch.randn(q_shape, generator=gen, device=dev).to(torch.bfloat16)
    err = (kern(q, k, v, pages, pos_t).float()
           - ref(q, k, v, pages, pos_t).float()).abs().max().item()
    check(err <= ATTN_BF16_ATOL or not checked,
          f"{name} timed case {pos}: err {err}")
    plain = time_ms(lambda: ref(q, k, v, pages, pos_t), iters=20)
    pl = pages.long()
    t = n_live * ps
    qpos = pos_t.long()[:, None] + torch.arange(rows, device=dev)
    mask = (torch.arange(t, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]               # (B, 1, rows, T)
    qq = q.reshape(b, rows, h, hd).transpose(1, 2).contiguous()
    kk = k[pl].reshape(b, t, kvh, hd).transpose(1, 2).contiguous()
    vv = v[pl].reshape(b, t, kvh, hd).transpose(1, 2).contiguous()

    def gathered():
        kg = k[pl].reshape(b, t, kvh, hd).transpose(1, 2)
        vg = v[pl].reshape(b, t, kvh, hd).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q.reshape(b, rows, h, hd).transpose(1, 2), kg, vg,
            attn_mask=mask)

    library = sdpa_backends(torch, lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask))
    context = {f"gather_{n}": e for n, e in
               sdpa_backends(torch, gathered).items()}
    times = time_interleaved(torch, {"kernel": lambda: kern(
        q, k, v, pages, pos_t), **library, **context})
    ms = times.pop("kernel")
    lib_all = {n: times[n] for n in library}
    lib_name = min(lib_all, key=lib_all.get)
    rows_pos = [[p + r for r in range(rows)] for p in pos]
    n_bytes, flops = _attn_cost(rows_pos, kvh, h // kvh, hd, 2, q.numel())
    b_ms, b_by = bound(n_bytes + 8 * b, flops, "bf16")
    return {"shape": list(q_shape), "pos": pos, "page_size": ps,
            "n_live": n_live, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "library_ms": lib_all[lib_name],
            "library": lib_name, "library_ms_by_call": lib_all,
            "gather_sdpa_ms_by_call": {n: times[n] for n in context},
            "bound_ms": b_ms, "bound_by": b_by}


def kernel_attention(torch, results):
    errs = check_paged_attention(torch)
    for name, label, pos, n_live in ATTN_TIMED:
        row = time_paged_attention(torch, name, pos, n_live)
        print(json.dumps({"phase": "kernel", "name": name, "case": label,
                          **row, "max_abs_err_f32": errs[(name, "float32")],
                          "tolerance_f32": ATTN_F32_ATOL,
                          "tolerance": ATTN_BF16_ATOL}), flush=True)
        if label == "B 4":                  # the kernels line's row
            results[name] = {**{k: row[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library")}, "max_abs_err": errs[(name, "bfloat16")],
                "cases": {}}
        results[name]["cases"][label] = {k: row[k] for k in (
            "ms", "library_ms", "library", "bound_ms", "plain_ms")}


def _mm_row(bf16, m, k, n, n_bytes, lanes, t):
    """The timing and bound keys of a ``zo_matmul``-family row: kernel
    and library (cuBLAS SGEMM, TF32 off) ms from ``time_interleaved``, the
    bf16 cuBLAS product of the unperturbed W as the product's floor
    (context, not the yardstick), the bound at the peak of the body that
    runs (bf16 X, Rademacher z: bf16 tensor cores) and the SIMT body's f32
    bound beside it."""
    flops = 2.0 * lanes * m * k * n
    b_ms, b_by = bound(n_bytes, flops, "bf16" if bf16 else "f32")
    return {"body": "tc" if bf16 else "simt", "kernel_ms": t["kernel"],
            "library_ms": t["sgemm"], "library": "sgemm",
            "cublas_bf16_ms": t.get("cublas_bf16"), "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_f32_simt_ms": bound(n_bytes, flops, "f32")[0]}


def _mm_result(rows, opt):
    """The kernels line's entry: OPT-1.3B's two shapes summed (one w_in
    slice and the LM head), as zo_add's row sums its two largest leaves."""
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["kernel_ms"] for r in opt),
            "plain_ms": sum(r["plain_ms"] for r in opt),
            "bound_ms": sum(r["bound_ms"] for r in opt),
            "bound_by": "operations",
            "library_ms": sum(r["library_ms"] for r in opt),
            "library": "sgemm",
            "cublas_bf16_ms": sum(r["cublas_bf16_ms"] for r in opt),
            "bound_f32_simt_ms": sum(r["bound_f32_simt_ms"] for r in opt)}


def kernel_zo_matmul(torch, results):
    """T0: ``zo_matmul`` at the training path's shapes against its plain
    version; the library yardstick is cuBLAS SGEMM (TF32 off) of
    ``X.float() @ W'`` on a W' materialized beforehand."""
    from repro_torch.core import rng
    from repro_torch.kernels import zo_perturb as zp
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    seed, coeff = 987654321, 1e-3
    cases = [  # (name, M, K, N, dtype, leaf path, layer or None)
        ("opt w_in slice", 1024, 2048, 8192, torch.bfloat16,
         "blocks/mlp/w_in/w", 5),
        ("opt lm_head", 1024, 2048, 50272, torch.bfloat16, "lm_head/w",
         None),
        ("roberta w_in slice", 1024, 1024, 4096, torch.float32,
         "blocks/mlp/w_in/w", 5)]
    rows = []
    for label, m, k, n, dt, path, layer in cases:
        x = torch.randn((m, k), generator=gen, device=dev).to(dt)
        w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(dt)
        salt = rng.leaf_salt(path)
        if layer is None:
            kw = dict(seed=seed, salt=salt, prime_offset=0, prehashed=False)
        else:
            kw = dict(seed=rng.fold_leading(rng.leaf_base(seed, salt), layer),
                      salt=0, prime_offset=1, prehashed=True)
        tol = ZO_MM_F32_RTOL if dt == torch.float32 else ZO_MM_BF16_RTOL
        errs, abs_err = {}, 0.0
        for dist in ("rademacher", "gaussian"):
            got = zp.zo_matmul_cuda(x, w, coeff=coeff, dist=dist, **kw)
            want = zp.zo_matmul_ref(x, w, coeff=coeff, dist=dist, **kw)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs().max()
            err = (diff / want.float().abs().max()).item()
            check(err <= tol and torch.isfinite(got).all().item(),
                  f"zo_matmul {label} {dist}: max|d|/max|Y| {err} > {tol}")
            errs[dist] = err
            abs_err = max(abs_err, diff.item())
            del got, want
        plain = time_ms(lambda: zp.zo_matmul_ref(x, w, coeff=coeff, **kw),
                        iters=2, warmup=1)
        z = zp.tile_z(kw["seed"], kw["salt"], (k, n), 0, 0, "rademacher",
                      kw["prime_offset"], kw["prehashed"], device=dev)
        wp = w.float() + torch.tensor(coeff, dtype=torch.float32,
                                      device=dev) * z
        del z
        xf = x.float()
        t = time_interleaved(torch, {
            "kernel": lambda: zp.zo_matmul_cuda(x, w, coeff=coeff, **kw),
            "sgemm": lambda: xf @ wp,
            **({"cublas_bf16": lambda: x @ w} if dt == torch.bfloat16
               else {})})
        del wp, xf
        row = {"phase": "kernel", "name": "zo_matmul", "case": label,
               "shape": [m, k, n], "dtype": str(dt).split(".")[-1],
               **_mm_row(dt == torch.bfloat16, m, k, n,
                         (m * k + k * n + m * n) * x.element_size(), 1, t),
               "rel_err_rademacher": errs["rademacher"],
               "rel_err_gaussian": errs["gaussian"], "tolerance": tol,
               "max_abs_err": abs_err, "plain_ms": plain}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, w
        torch.cuda.empty_cache()
    results["zo_matmul"] = _mm_result(rows, rows[:2])


def _flash_cost(b, s, t, h, kvh, hd, causal, item):
    """Bytes (q, k, v read once, out written once) and flops (q.k and
    p.v, 2 * hd each, over the live (row, key) pairs)."""
    pairs = (sum(min(i + 1, t) for i in range(s)) if causal else s * t)
    flops = 4.0 * hd * b * h * pairs
    n_bytes = (2 * b * s * h * hd + 2 * b * t * kvh * hd) * item
    return n_bytes, flops


def kernel_flash_attention(torch, results):
    """T0: ``flash_attention`` against its plain version; the library
    yardstick is ``F.scaled_dot_product_attention`` on the same tensors."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    cases = [  # (label, B, S, H, KV, hd, causal, dtype)
        ("opt causal", 8, 128, 32, 32, 64, True, torch.bfloat16),
        ("roberta bidirectional", 8, 128, 16, 16, 64, False, torch.float32),
        ("ragged gqa causal", 3, 100, 8, 2, 16, True, torch.float32),
        ("ragged gqa bidirectional", 3, 100, 8, 2, 16, False,
         torch.bfloat16)]
    rows = []
    for label, b, s, h, kvh, hd, causal, dt in cases:
        q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((b, s, kvh, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, kvh, hd), generator=gen, device=dev).to(dt)
        got = fa.flash_attention_cuda(q, k, v, causal)
        want = fa.flash_attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = ATTN_F32_ATOL if dt == torch.float32 else ATTN_BF16_ATOL
        check(err <= tol and torch.isfinite(got).all().item(),
              f"flash_attention {label}: max err {err} > {tol}")
        plain = time_ms(lambda: fa.flash_attention_ref(q, k, v, causal),
                        iters=10)
        qq, kk, vv = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms, lib, lib_name, lib_all = kernel_vs_library(
            torch, lambda: fa.flash_attention_cuda(q, k, v, causal),
            sdpa_backends(torch, lambda: F.scaled_dot_product_attention(
                qq, kk, vv, is_causal=causal, enable_gqa=kvh != h)))
        n_bytes, flops = _flash_cost(b, s, s, h, kvh, hd, causal,
                                     q.element_size())
        # bf16 runs the tensor-core body: the bound at the bf16 peak; the
        # SIMT body's f32 bound beside it
        bf16 = dt == torch.bfloat16
        b_ms, b_by = bound(n_bytes, flops, "bf16" if bf16 else "f32")
        row = {"phase": "kernel", "name": "flash_attention", "case": label,
               "shape": [b, s, h, kvh, hd], "causal": causal,
               "dtype": str(dt).split(".")[-1],
               "body": "tc" if bf16 else "simt", "max_abs_err": err,
               "tolerance": tol, "kernel_ms": ms, "plain_ms": plain,
               "library_ms": lib, "library": lib_name,
               "library_ms_by_call": lib_all, "bound_ms": b_ms,
               "bound_by": b_by,
               "bound_f32_simt_ms": bound(n_bytes, flops, "f32")[0]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    main = rows[0]                       # the OPT-1.3B training shape
    results["flash_attention"] = {
        "max_abs_err": main["max_abs_err"], "ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library": main["library"]}


def kernel_zo_add_q(torch, results):
    """Q0: ``zo_add_q`` on OPT-1.3B's two largest leaves quantized (the
    stacked ``w_in`` and the LM head) against its plain version; no
    library call computes it."""
    from repro_torch.core import rng
    from repro_torch.kernels import zo_perturb as zp
    from repro_torch.optim.quant import quantize_leaf
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    seed, coeff = 24681357, 0.00513
    rows = []
    shapes = {"blocks/mlp/w_in/w": (24, 2048, 8192), "lm_head/w": (2048, 50272)}
    for path, shape in shapes.items():
        ql = quantize_leaf((torch.randn(shape, generator=gen, device=dev)
                            * 0.02).to(torch.bfloat16))
        q, sc, salt = ql.q, ql.scale, rng.leaf_salt(path)
        errs = {}
        for dist in ("rademacher", "gaussian"):
            got = zp.zo_add_q_cuda(q, sc, seed, salt, coeff, dist)
            want = zp.zo_add_q_ref(q, sc, seed, salt, coeff, dist)
            torch.cuda.synchronize()
            errs[dist] = (got - want).abs().max().item()
            if dist == "rademacher":
                check(torch.equal(got, want), f"zo_add_q {shape} Rademacher "
                      f"not bit-exact (max err {errs[dist]})")
            else:
                check(errs[dist] <= ZO_GAUSS_ATOL, f"zo_add_q {shape} "
                      f"Gaussian err {errs[dist]} > {ZO_GAUSS_ATOL}")
            del got, want
        ms = time_ms(lambda: zp.zo_add_q_cuda(q, sc, seed, salt, coeff),
                     iters=20)
        plain = time_ms(lambda: zp.zo_add_q_ref(q, sc, seed, salt, coeff),
                        iters=2, warmup=1)
        n = q.numel()
        b_ms, b_by = bound(5.0 * n + 4.0 * sc.numel(), 2.0 * n, "f32")
        row = {"phase": "kernel", "name": "zo_add_q", "shape": list(shape),
               "max_abs_err_rademacher": errs["rademacher"],
               "max_abs_err_gaussian": errs["gaussian"],
               "tolerance_gaussian": ZO_GAUSS_ATOL, "kernel_ms": ms,
               "plain_ms": plain, "library_ms": None, "bound_ms": b_ms,
               "bound_by": b_by}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del ql, q, sc
        torch.cuda.empty_cache()
    results["zo_add_q"] = {
        "max_abs_err": max(r["max_abs_err_rademacher"] for r in rows),
        "ms": sum(r["kernel_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "bytes", "library_ms": None}


def kernel_zo_matmul_q(torch, results):
    """Q0: ``zo_matmul_q`` at the frozen-base forward's shapes against its
    plain version; the library yardstick is cuBLAS SGEMM (TF32 off) of
    ``X.float() @ W'``, W' = q * s + c * z materialized beforehand."""
    from repro_torch.core import rng
    from repro_torch.kernels import zo_perturb as zp
    from repro_torch.optim.quant import quantize_leaf
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    seed, coeff = 135792468, -1e-3
    cases = [  # (name, M, K, N, X dtype, leaf path, layer or None)
        ("opt w_in slice", 1024, 2048, 8192, torch.bfloat16,
         "blocks/mlp/w_in/w", 5),
        ("opt lm_head", 1024, 2048, 50272, torch.bfloat16, "lm_head/w",
         None),
        ("roberta w_in slice", 1024, 1024, 4096, torch.float32,
         "blocks/mlp/w_in/w", 5)]
    rows = []
    for label, m, k, n, dt, path, layer in cases:
        x = torch.randn((m, k), generator=gen, device=dev).to(dt)
        ql = quantize_leaf(torch.randn((k, n), generator=gen, device=dev)
                           * 0.02)
        q, sc, salt = ql.q, ql.scale, rng.leaf_salt(path)
        if layer is None:
            kw = dict(seed=seed, salt=salt, prime_offset=0, prehashed=False)
        else:
            kw = dict(seed=rng.fold_leading(rng.leaf_base(seed, salt), layer),
                      salt=0, prime_offset=1, prehashed=True)
        tol = ZO_MM_F32_RTOL if dt == torch.float32 else ZO_MM_BF16_RTOL
        errs, abs_err = {}, 0.0
        for dist in ("rademacher", "gaussian"):
            got = zp.zo_matmul_q_cuda(x, q, sc, coeff=coeff, dist=dist, **kw)
            want = zp.zo_matmul_q_ref(x, q, sc, coeff=coeff, dist=dist, **kw)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs().max()
            err = (diff / want.float().abs().max()).item()
            check(err <= tol and torch.isfinite(got).all().item(),
                  f"zo_matmul_q {label} {dist}: max|d|/max|Y| {err} > {tol}")
            errs[dist] = err
            abs_err = max(abs_err, diff.item())
            del got, want
        plain = time_ms(lambda: zp.zo_matmul_q_ref(x, q, sc, coeff=coeff,
                                                   **kw), iters=2, warmup=1)
        wp = zp.zo_add_q_ref(q, sc, kw["seed"], kw["salt"], coeff,
                             prime_offset=kw["prime_offset"],
                             prehashed=kw["prehashed"])
        xf = x.float()
        wd = (q.float() * sc).to(dt)             # the dequantized base
        t = time_interleaved(torch, {
            "kernel": lambda: zp.zo_matmul_q_cuda(x, q, sc, coeff=coeff,
                                                  **kw),
            "sgemm": lambda: xf @ wp,
            **({"cublas_bf16": lambda: x @ wd} if dt == torch.bfloat16
               else {})})
        del wp, xf, wd
        row = {"phase": "kernel", "name": "zo_matmul_q", "case": label,
               "shape": [m, k, n], "dtype": str(dt).split(".")[-1],
               **_mm_row(dt == torch.bfloat16, m, k, n,
                         (m * k + m * n) * x.element_size()
                         + k * n + 4 * n, 1, t),
               "rel_err_rademacher": errs["rademacher"],
               "rel_err_gaussian": errs["gaussian"], "tolerance": tol,
               "max_abs_err": abs_err, "plain_ms": plain}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, ql, q, sc
        torch.cuda.empty_cache()
    results["zo_matmul_q"] = _mm_result(rows, rows[:2])


# ---------------------------------------------------------------------------
# U0: the user-batched kernels (the multi-tenant step)

U_COEFFS = [1e-3, -1e-3, 2e-3, -5e-4]     # 4 lanes: both signs, 2 eps


def kernel_zo_add_users(torch, results):
    """U0: ``zo_add_users`` on U = 4 stacked OPT-1.3B leaves (the f32
    deltas of the stacked ``w_in`` and of the LM head) against its plain
    version and against a lone ``zo_add`` launch per lane; no library
    call computes it."""
    from repro_torch.core import rng
    from repro_torch.kernels import zo_perturb as zp
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    seeds = [975318642 + 7 * i for i in range(4)]
    shapes = {"blocks/mlp/w_in/w": (4, 24, 2048, 8192),
              "lm_head/w": (4, 2048, 50272)}
    rows = []
    for path, shape in shapes.items():
        w = torch.randn(shape, generator=gen, device=dev) * 0.02
        salt = rng.leaf_salt(path)
        errs = {}
        for dist in ("rademacher", "gaussian"):
            got = zp.zo_add_users_cuda(w, seeds, salt, U_COEFFS, dist)
            want = zp.zo_add_users_ref(w, seeds, salt, U_COEFFS, dist)
            torch.cuda.synchronize()
            errs[dist] = (got - want).abs().max().item()
            tol = 0.0 if dist == "rademacher" else ZO_GAUSS_ATOL
            check(errs[dist] <= tol, f"zo_add_users {shape} {dist}: err "
                  f"{errs[dist]} > {tol}")
            del want
            for i in range(4):
                check(torch.equal(got[i], zp.zo_add_cuda(
                    w[i], seeds[i], salt, U_COEFFS[i], dist)),
                    f"zo_add_users {shape} {dist}: lane {i} differs from a "
                    f"lone zo_add launch")
            del got
        out = torch.empty_like(w)
        ms = time_ms(lambda: zp.zo_add_users_cuda(w, seeds, salt, U_COEFFS,
                                                  out=out), iters=10)
        del out
        plain = time_ms(lambda: zp.zo_add_users_ref(w, seeds, salt,
                                                    U_COEFFS),
                        iters=1, warmup=1)
        n = w.numel()
        b_ms, b_by = bound(8.0 * n, 2.0 * n, "f32")
        row = {"phase": "U0 kernel", "name": "zo_add_users", "dtype":
               "float32", "shape": list(shape),
               "max_abs_err_rademacher": errs["rademacher"],
               "max_abs_err_gaussian": errs["gaussian"],
               "tolerance_gaussian": ZO_GAUSS_ATOL,
               "lanes_equal_lone_launches": True, "kernel_ms": ms,
               "plain_ms": plain, "library_ms": None, "bound_ms": b_ms,
               "bound_by": b_by}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del w
        torch.cuda.empty_cache()
    # U1's use: the bf16 VEC=8 instantiation updating only the active
    # lanes of a stacked parameter in place; the others keep their bits
    path, lanes = "blocks/mlp/w_in/w", [0, 2]
    w = (torch.randn((4, 24, 2048, 8192), generator=gen, device=dev)
         * 0.02).to(torch.bfloat16)
    before = w.clone()
    salt = rng.leaf_salt(path)
    lane_seeds = [seeds[i] for i in lanes]
    lane_coeffs = [U_COEFFS[i] for i in lanes]
    zp.zo_add_users_cuda(w, lane_seeds, salt, lane_coeffs, out=w,
                         lanes=lanes)
    want = zp.zo_add_users_ref(before[lanes], lane_seeds, salt, lane_coeffs)
    torch.cuda.synchronize()
    err = (w[lanes].float() - want.float()).abs().max().item()
    check(err == 0.0, f"zo_add_users bf16 lanes={lanes} in place: err "
          f"{err} > 0 against the plain version")
    for j, i in enumerate(lanes):
        check(torch.equal(w[i], zp.zo_add_cuda(before[i], lane_seeds[j], salt,
                                                lane_coeffs[j])),
              f"zo_add_users bf16 lane {i} differs from a lone zo_add launch")
    frozen = [i for i in range(4) if i not in lanes]
    check(all(torch.equal(w[i], before[i]) for i in frozen),
          f"zo_add_users bf16 lanes={lanes}: lanes {frozen} moved")
    print(json.dumps({"phase": "U0 kernel", "name": "zo_add_users",
                      "dtype": "bfloat16", "shape": list(w.shape),
                      "lanes": lanes, "in_place": True,
                      "max_abs_err_rademacher": err,
                      "lanes_equal_lone_launches": True,
                      "other_lanes_unchanged": True}), flush=True)
    del w, before, want
    torch.cuda.empty_cache()
    results["zo_add_users"] = {
        "max_abs_err": max(r["max_abs_err_rademacher"] for r in rows),
        "ms": sum(r["kernel_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "bytes", "library_ms": None}


def kernel_zo_matmul_users(torch, results):
    """U0: ``zo_matmul_users`` (X (4, 1024, 2048) bf16 over a shared and a
    per-lane W) and ``zo_matmul_users(scale=)`` (a shared int8 W) at the
    ``w_in`` slice and LM head shapes, against their plain versions and a
    lone ``zo_matmul`` / ``zo_matmul_q`` launch per lane. The library
    yardstick is one cuBLAS SGEMM call, TF32 off, ``torch.bmm`` of
    ``X.float()`` with every lane's W' materialized beforehand."""
    from repro_torch.core import rng
    from repro_torch.kernels import zo_perturb as zp
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    seed0 = 864213579
    u = len(U_COEFFS)
    cases = [("opt w_in slice", 1024, 2048, 8192, "blocks/mlp/w_in/w", 5),
             ("opt lm_head", 1024, 2048, 50272, "lm_head/w", None)]
    rows = {"shared": [], "per-lane": [], "int8": []}
    for label, m, k, n, path, layer in cases:
        salt = rng.leaf_salt(path)
        seeds = [seed0 + 3 * i for i in range(u)]
        if layer is None:
            kw = dict(salt=salt, prime_offset=0, prehashed=False)
            lane_seeds = seeds
        else:
            kw = dict(salt=0, prime_offset=1, prehashed=True)
            lane_seeds = [rng.fold_leading(rng.leaf_base(s, salt), layer)
                          for s in seeds]
        x = torch.randn((u, m, k), generator=gen, device=dev).to(
            torch.bfloat16)
        for weight in rows:
            scale, kernel = None, "zo_matmul_users"
            if weight == "per-lane":
                w = (torch.randn((u, k, n), generator=gen, device=dev)
                     * 0.02).to(torch.bfloat16)
            elif weight == "shared":
                w = (torch.randn((k, n), generator=gen, device=dev)
                     * 0.02).to(torch.bfloat16)
            else:
                w = torch.randint(-127, 128, (k, n), generator=gen,
                                  device=dev, dtype=torch.int8)
                scale = 2.0 ** torch.randint(-12, -6, (n,), generator=gen,
                                             device=dev).float()
                kernel = "zo_matmul_users_q"

            def lane_w(i):
                return w[i] if w.dim() == 3 else w

            errs, abs_err = {}, 0.0
            for dist in ("rademacher", "gaussian"):
                got = zp.zo_matmul_users_cuda(x, w, lane_seeds,
                                              coeffs=U_COEFFS, dist=dist,
                                              scale=scale, **kw)
                want = zp.zo_matmul_users_ref(x, w, lane_seeds,
                                              coeffs=U_COEFFS, dist=dist,
                                              scale=scale, **kw)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs().max()
                err = (diff / want.float().abs().max()).item()
                check(err <= ZO_MM_BF16_RTOL
                      and torch.isfinite(got).all().item(),
                      f"{kernel} {label} {weight} {dist}: max|d|/max|Y| "
                      f"{err} > {ZO_MM_BF16_RTOL}")
                del want
                for i in range(u):
                    if scale is None:
                        lone = zp.zo_matmul_cuda(
                            x[i], lane_w(i), lane_seeds[i],
                            coeff=U_COEFFS[i], dist=dist, **kw)
                    else:
                        lone = zp.zo_matmul_q_cuda(
                            x[i], w, scale, lane_seeds[i],
                            coeff=U_COEFFS[i], dist=dist, **kw)
                    check(torch.equal(got[i], lone),
                          f"{kernel} {label} {weight} {dist}: lane {i} "
                          f"differs from a lone launch")
                    del lone
                errs[dist] = err
                abs_err = max(abs_err, diff.item())
                del got
            row = {"phase": "U0 kernel", "name": kernel, "case": label,
                   "weight": weight, "lanes": u, "shape": [m, k, n],
                   "dtype": "bfloat16",
                   "rel_err_rademacher": errs["rademacher"],
                   "rel_err_gaussian": errs["gaussian"],
                   "tolerance": ZO_MM_BF16_RTOL, "max_abs_err": abs_err,
                   "lanes_equal_lone_launches": True}
            if weight != "shared":   # the kernels line's two weights
                row.update(_users_times(torch, zp, x, w, scale, lane_seeds,
                                        kw, u, m, k, n, lane_w))
            print(json.dumps(row), flush=True)
            rows[weight].append(row)
            del w
            torch.cuda.empty_cache()
        del x
    # the kernels line: the per-lane W of the multi-tenant state (U1) for
    # zo_matmul_users, the shared int8 base (U3) for zo_matmul_users_q,
    # each summed over the two shapes
    for name, weight in (("zo_matmul_users", "per-lane"),
                         ("zo_matmul_users_q", "int8")):
        results[name] = _mm_result(rows[weight], rows[weight])


def _users_times(torch, zp, x, w, scale, lane_seeds, kw, u, m, k, n,
                 lane_w):
    """A U0 row's times: the kernel, one cuBLAS SGEMM ``torch.bmm`` of
    ``X.float()`` with every lane's W' made beforehand (the yardstick) and
    one bf16 ``torch.bmm`` of the unperturbed W (the product's floor),
    through ``time_interleaved``; the plain version's time; the bound."""
    plain = time_ms(lambda: zp.zo_matmul_users_ref(
        x, w, lane_seeds, coeffs=U_COEFFS, scale=scale, **kw),
        iters=1, warmup=1)
    wp = torch.stack([
        zp.zo_add_q_ref(w, scale, lane_seeds[i], kw["salt"], U_COEFFS[i],
                        prime_offset=kw["prime_offset"],
                        prehashed=kw["prehashed"])
        if scale is not None else
        zp.zo_add_ref(lane_w(i).float(), lane_seeds[i], kw["salt"],
                      U_COEFFS[i], prime_offset=kw["prime_offset"],
                      prehashed=kw["prehashed"])
        for i in range(u)])
    xf = x.float()
    wd = (w.float() * scale).to(x.dtype) if scale is not None else w
    wd = wd.expand(u, k, n) if wd.dim() == 2 else wd
    t = time_interleaved(torch, {
        "kernel": lambda: zp.zo_matmul_users_cuda(
            x, w, lane_seeds, coeffs=U_COEFFS, scale=scale, **kw),
        "sgemm": lambda: torch.bmm(xf, wp),
        "cublas_bf16": lambda: torch.bmm(x, wd)})
    del wp, xf, wd
    w_bytes = w.numel() * w.element_size() + (0 if scale is None else 4 * n)
    return {**_mm_row(x.dtype == torch.bfloat16, m, k, n,
                      2.0 * u * (m * k + m * n) + w_bytes, u, t),
            "plain_ms": plain}


def kernel_flash_verify(torch, results):
    """S0: the verify window at serving shapes (B 4, W = k + 1 = 4, 32
    heads of 64, page 16, ragged positions 96-128) in f32 and bf16, two
    GQA layouts (W * G = 16 rows, and 64 rows split over blockIdx.z), NaN
    in the trash page; times in bf16 at OPT-1.3B's shape."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_verify as fv
    dev = torch.device("cuda")
    b, w, h, hd, ps, n_live = 4, 4, 32, 64, 16, 8
    pos = [96, 110, 124, 101]
    cover = [p + w - 1 for p in pos]
    gen = torch.Generator(device=dev).manual_seed(5)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    errs = {}
    for kvh, dt, tol in ((32, torch.float32, ATTN_F32_ATOL),
                         (8, torch.float32, ATTN_F32_ATOL),
                         (2, torch.float32, ATTN_F32_ATOL),
                         (8, torch.bfloat16, ATTN_BF16_ATOL),
                         (2, torch.bfloat16, ATTN_BF16_ATOL),
                         (32, torch.bfloat16, ATTN_BF16_ATOL)):
        k, v, pages, _ = _paged_case(torch, b, ps, kvh, hd, n_live, cover,
                                     1e4)
        k, v = k.to(dt), v.to(dt)
        q = torch.randn((b, w, h, hd), generator=gen, device=dev).to(dt)
        got = fv.flash_verify(q, k, v, pages, pos_t)
        want = fv.verify_attn_ref(q, k, v, pages, pos_t)
        err = (got.float() - want.float()).abs().max().item()
        check(err <= tol and torch.isfinite(got).all().item(),
              f"flash_verify KV {kvh} {dt}: max err {err} > {tol}")
        k[0], v[0] = float("nan"), float("nan")
        check(torch.equal(fv.flash_verify(q, k, v, pages, pos_t), got),
              f"flash_verify KV {kvh} {dt}: NaN in the trash page reached "
              f"the output")
        errs[(kvh, str(dt))] = err
    # q, k, v, pages hold the bf16 case at OPT-1.3B's shape (KV 32)
    k[0], v[0] = 0.0, 0.0
    plain = time_ms(lambda: fv.verify_attn_ref(q, k, v, pages, pos_t),
                    iters=50)
    pl = pages.long()
    kk = k[pl].reshape(b, n_live * ps, h, hd).transpose(1, 2).contiguous()
    vv = v[pl].reshape(b, n_live * ps, h, hd).transpose(1, 2).contiguous()
    qpos = pos_t.long()[:, None] + torch.arange(w, device=dev)
    mask = (torch.arange(n_live * ps, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]               # (B, 1, W, T)
    qq = q.transpose(1, 2).contiguous()
    ms, lib, lib_name, lib_all = kernel_vs_library(
        torch, lambda: fv.flash_verify(q, k, v, pages, pos_t),
        sdpa_backends(torch, lambda: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask)))
    rows_pos = [[p + r for r in range(w)] for p in pos]
    n_bytes, flops = _attn_cost(rows_pos, h, 1, hd, 2, q.numel())
    b_ms, b_by = bound(n_bytes + 4 * (pages.numel() + b), flops, "bf16")
    err = max(e for (_, dt), e in errs.items() if "bfloat16" in dt)
    print(json.dumps({"phase": "kernel", "name": "flash_verify",
                      "shape": [b, w, h, hd], "pos": pos, "page_size": ps,
                      "n_live": n_live,
                      "max_abs_err_by_kv_dtype": {f"{kv} {dt}": e for
                                                  (kv, dt), e in
                                                  errs.items()},
                      "tolerance_f32": ATTN_F32_ATOL,
                      "max_abs_err": err, "tolerance": ATTN_BF16_ATOL,
                      "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
                      "library": lib_name, "library_ms_by_call": lib_all,
                      "bound_ms": b_ms, "bound_by": b_by}), flush=True)
    results["flash_verify"] = {"max_abs_err": err, "ms": ms,
                               "plain_ms": plain, "bound_ms": b_ms,
                               "bound_by": b_by, "library_ms": lib,
                               "library": lib_name}


# ---------------------------------------------------------------------------
# phase 4: the main path


def _write_adapter(path: Path, seed: int):
    """4 replay records, K = 2, |lr * g| >= 1e-2 so updates survive bf16."""
    import numpy as np
    rng = np.random.default_rng(seed)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "replay.jsonl", "w") as f:
        for step in range(4):
            gs = (rng.choice([-1.0, 1.0], size=2)
                  * rng.uniform(1.0, 2.0, size=2)).astype(np.float32)
            f.write(json.dumps({"step": step,
                                "seed": int(rng.integers(2**31)),
                                "gs": gs.tolist(), "lr": 1e-2,
                                "eps": 1e-3}) + "\n")


def _recorded(torch, engine_mod, fn):
    """Call ``fn()`` recording each request's first-step logits (the row
    the engine picks the first token from): (fn's result, {rid: row})."""
    first = {}
    orig = engine_mod.ServeEngine._activate

    def recording(self, slot, req, logits_row, plen):
        first[req.rid] = torch.from_numpy(logits_row.copy())
        return orig(self, slot, req, logits_row, plen)

    engine_mod.ServeEngine._activate = recording
    try:
        return fn(), first
    finally:
        engine_mod.ServeEngine._activate = orig


N_BASE = 2   # base requests beside the CLI's mix (phases 4 and Q3)


def _serve(torch, serve_mod, engine_mod, argv, params=None, hook=None):
    """Build the CLI's engine (``build_engine``, on ``params`` when given),
    submit ``N_BASE`` requests for the base model beside the CLI's
    requests -- with adapters the CLI serves only its users, as the JAX
    CLI does -- call ``hook(engine)``, serve them all, and record each
    request's first-step logits."""
    import numpy as np
    from repro_torch.serve import Request
    args = serve_mod.build_parser().parse_args(argv)

    def run():
        engine = serve_mod.build_engine(args, params)
        prompts = np.random.default_rng(args.seed + 1).integers(
            0, engine.cfg.vocab, (N_BASE, args.prompt_len), dtype=np.int32)
        for p in prompts:
            engine.submit(Request(prompt=p, max_new=args.gen, user=None))
        if hook is not None:
            hook(engine)
        t0 = time.perf_counter()
        comps = engine.run()
        return engine, comps, time.perf_counter() - t0
    (engine, comps, dt), first = _recorded(torch, engine_mod, run)
    return args, engine, comps, dt, first


SERVE_KERNELS = ("zo_add", "flash_decode", "flash_prefill")


def main_path(torch, paths):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import engine as engine_mod
    users = {}
    for i, user in enumerate(("alice", "bob")):
        users[user] = WORK / user
        _write_adapter(users[user], 100 + i)
    common = ["--arch", "opt-1.3b", "--device", "cuda", "--slots", "4",
              "--requests", str(8 - N_BASE), "--prompt-len", "96", "--gen",
              "32", "--seed", "0"]
    for user, path in users.items():
        common += ["--adapter", f"{user}={path}"]
    paged = common + ["--paged", "--page-size", "16", "--prefill-chunk", "32"]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    args, engine, comps, dt, first = _serve(torch, serve_mod, engine_mod,
                                            paged)
    torch.cuda.synchronize()
    launches = _snapshot(ops)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(serve_mod.summary(args, engine, comps, dt), flush=True)
    print(json.dumps({"phase": "main_path", "launches": launches,
                      "peak_memory_gib": peak_gb,
                      "materialize_s": engine.store.stats["materialize_s"],
                      "seconds": dt}), flush=True)
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the serving path")
    _check_prefill_body("serve", launches)
    paths["serve"] = launches
    cfg = engine.cfg
    check(len(comps) == 8, f"{len(comps)} completions, expected 8")
    check(sorted({str(c.user) for c in comps}) == ["None", "alice", "bob"],
          f"served users {sorted({str(c.user) for c in comps})}")
    for comp in comps:
        t = comp.tokens
        check(t.shape == (32,) and int(t.min()) >= 0
              and int(t.max()) < cfg.vocab,
              f"rid {comp.rid}: bad tokens {t.tolist()}")
        check(torch.isfinite(first[comp.rid]).all().item(),
              f"rid {comp.rid}: non-finite first-step logits")

    # a user's first-step logits differ from the base's on the same prompt
    model, store = engine.model, engine.store
    c0 = comps[0]
    check(c0.user == "alice", f"rid 0 served by {c0.user}, expected alice")
    prompt = torch.as_tensor(c0.prompt, dtype=torch.long,
                             device="cuda")[None]
    base_lg, _ = model.prefill(store.materialize(None),
                               model.init_cache(1, 96, device="cuda"), prompt)
    diff_user = (first[0] - base_lg[0, -1].float().cpu()).abs().max().item()
    check(diff_user > LOGITS_BF16_ATOL,
          f"alice's logits equal the base's (max diff {diff_user})")
    del engine, store, model, base_lg
    torch.cuda.empty_cache()

    # the dense-mode engine (plain attention) as the reference
    _, _, dense_comps, _, dense_first = _serve(torch, serve_mod, engine_mod,
                                               common)
    worst = max((first[r] - dense_first[r]).abs().max().item()
                for r in first)
    same_first = sum(int(a.tokens[0] == d.tokens[0])
                     for a, d in zip(comps, dense_comps))
    print(json.dumps({"phase": "reference", "first_logits_max_abs_err":
                      worst, "tolerance": LOGITS_BF16_ATOL,
                      "user_vs_base_max_abs_diff": diff_user,
                      "first_tokens_equal": same_first}), flush=True)
    check(worst <= LOGITS_BF16_ATOL,
          f"paged/chunked first-step logits differ from dense by {worst}")
    return paged, common, comps


def _profiled(torch, fn):
    """Run ``fn`` under ``torch.profiler``: (wall us, device us by kernel
    name). Kernels on one stream do not overlap, so their durations add."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    return wall_us, by_name


def _profile_line(phase, wall_us, by_name, **extra):
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    port: dict = {}                # the port's kernels by function name
    for name, us in by_name.items():
        if "repro_torch::" in name:
            fn = name.replace("(anonymous namespace)::", "")
            fn = fn.split("<")[0].split("(")[0].split("::")[-1]
            port[fn] = port.get(fn, 0.0) + us / 1e3
    print(json.dumps({
        "phase": phase, **extra, "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3 if by_name else "not measured",
        "device_busy_share": busy_us / wall_us if by_name
        else "not measured",
        "top_kernels_ms": {name[:60]: us / 1e3 for name, us in top},
        "port_kernels_ms": port}), flush=True)


def profile_path(torch, paged_argv, phase="profile"):
    """Device busy share of serving (4 requests, 16 new tokens)."""
    from repro_torch.launch import serve as serve_mod
    argv = list(paged_argv)
    argv[argv.index("--requests") + 1] = "4"
    argv[argv.index("--gen") + 1] = "16"
    engine = serve_mod.build_engine(serve_mod.build_parser().parse_args(argv))
    for user in engine.store.users():          # replay outside the window
        engine.store.materialize(user)
    wall_us, by_name = _profiled(torch, engine.run)
    _profile_line(phase, wall_us, by_name, requests=4, gen=16,
                  decode_steps=engine.stats.decode_steps)


# ---------------------------------------------------------------------------
# S1-S5: self-speculative serving (the base drafts, base+delta verifies)

SPEC_K = 3
# launches a spec round makes, read off the code: every decode_step and
# verify_window call runs its attention kernel once in each of OPT-1.3B's
# 24 layers (a draft step is one decode_step with the base weights; a
# verify is one verify_window call for each distinct active user)
SPEC_PER_CALL = {"flash_decode": 24, "flash_verify": 24}


def _count_calls(counts):
    """A ``_serve`` hook counting the engine's decode_step and
    verify_window calls into ``counts``."""
    import dataclasses

    def hook(engine):
        model = engine.model

        def counted(name):
            fn = getattr(model, name)

            def call(*a, **kw):
                counts[name] = counts.get(name, 0) + 1
                return fn(*a, **kw)
            return call
        engine.model = dataclasses.replace(
            model, decode_step=counted("decode_step"),
            verify_window=counted("verify_window"))
    return hook


def _record_rows(rows):
    """A ``_serve`` hook recording, for every decode call, the logits row
    each written slot picks its next token from: rows[(rid, index of that
    token)]."""
    import dataclasses

    import numpy as np

    def hook(engine):
        fn = engine.model.decode_step

        def call(params, cache, toks, pos, pages=None, write_mask=None):
            lg, cache = fn(params, cache, toks, pos, pages=pages,
                           write_mask=write_mask)
            host = lg[:, -1].float().cpu()
            live = (engine._active if write_mask is None
                    else write_mask.cpu().numpy())
            for slot in np.flatnonzero(live):
                rows[(engine._req[slot].rid, len(engine._out[slot]))] = \
                    host[slot]
            return lg, cache
        engine.model = dataclasses.replace(engine.model, decode_step=call)
    return hook


def _hold_to_plain(torch, label, argv, params, spec, plain):
    """The rule for tokens on the card, stated before the first run: each
    request's speculative tokens equal the plain engine's, or at the first
    position where they differ the plain engine's logits for the two
    tokens lie within LOGITS_BF16_ATOL (a bf16 near-tie that the verify
    window's M = B * W projections may flip: cuBLAS picks its algorithm
    by M). The plain logits come from a rerun of the plain
    engine, made only when some request differs. Returns (identical
    requests, {rid: gap}) and fails on a wider gap."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import engine as engine_mod
    check([c.rid for c in spec] == [c.rid for c in plain],
          f"{label}: completions differ in rids")
    first_diff = {}
    for a, b in zip(spec, plain):
        check(a.tokens.shape == b.tokens.shape,
              f"{label} rid {a.rid}: {a.tokens.shape} tokens, plain "
              f"{b.tokens.shape}")
        ne = (a.tokens != b.tokens).nonzero()[0]
        if ne.size:
            first_diff[a.rid] = (int(ne[0]), int(b.tokens[ne[0]]),
                                 int(a.tokens[ne[0]]))
    gaps = {}
    if first_diff:
        rows = {}
        _, _, rerun, _, first = _serve(torch, serve_mod, engine_mod, argv,
                                       params=params,
                                       hook=_record_rows(rows))
        for c in rerun:
            rows[(c.rid, 0)] = first[c.rid]
        check([c.tokens.tolist() for c in rerun]
              == [c.tokens.tolist() for c in plain],
              f"{label}: the plain engine's rerun gave other tokens")
        for rid, (j, want, got) in first_diff.items():
            row = rows[(rid, j)]
            gaps[rid] = abs(row[want] - row[got]).item()
            check(gaps[rid] <= LOGITS_BF16_ATOL,
                  f"{label} rid {rid}: token {j} is {got}, plain {want}, "
                  f"plain logits {gaps[rid]} apart > {LOGITS_BF16_ATOL}")
    return len(spec) - len(first_diff), gaps


def _spec_run(torch, paths, label, argv, params=None):
    """Serve ``argv`` with ``--spec-k`` through ``_serve``: launch counts
    against the calls, tokens in range; returns (args, engine,
    completions, seconds)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import engine as engine_mod
    calls = {}
    ops.reset_launches()
    args, engine, comps, dt, first = _serve(
        torch, serve_mod, engine_mod, argv, params=params,
        hook=_count_calls(calls))
    torch.cuda.synchronize()
    launches = _snapshot(ops)
    paths[label] = launches
    print(serve_mod.summary(args, engine, comps, dt), flush=True)
    _check_prefill_body(label, launches)
    for name, per in SPEC_PER_CALL.items():
        fn = "decode_step" if name == "flash_decode" else "verify_window"
        check(launches[name] == per * calls.get(fn, 0) > 0,
              f"{label}: {launches[name]} {name} launches for "
              f"{calls.get(fn, 0)} {fn} calls (expected {per} a call)")
    for comp in comps:
        t = comp.tokens
        check(t.shape == (args.gen,) and int(t.min()) >= 0
              and int(t.max()) < engine.cfg.vocab,
              f"{label} rid {comp.rid}: bad tokens {t.tolist()}")
        check(torch.isfinite(first[comp.rid]).all().item(),
              f"{label} rid {comp.rid}: non-finite first-step logits")
    st = engine.stats
    n = max(len(comps), 1)
    print(json.dumps({
        "phase": label, "spec_k": engine.spec_k,
        "accept_rate": st.spec_accept_rate, "drafted": st.spec_drafted,
        "accepted": st.spec_accepted, "rounds": st.decode_steps,
        "decode_tokens": st.decode_tokens, "decode_tok_s": st.decode_tps,
        "ttft_avg_s": st.ttft_s / n, "seconds": dt,
        "accept_rate_by_user": {
            str(u): [c.accept_rate for c in comps if c.user == u]
            for u in sorted({c.user for c in comps}, key=str)},
        "calls": calls, "launches": launches}), flush=True)
    return args, engine, comps, dt


def s1_spec_serving(torch, paths, paged_argv, plain):
    """S1: phase 4's requests with --spec-k 3 against phase 4's tokens."""
    argv = paged_argv + ["--spec-k", str(SPEC_K)]
    _, engine, comps, _ = _spec_run(torch, paths, "S1 spec", argv)
    check(len(comps) == len(plain),
          f"S1: {len(comps)} completions, expected {len(plain)}")
    check(engine.stats.spec_drafted > 0, "S1: nothing drafted")
    same, gaps = _hold_to_plain(torch, "S1", paged_argv, None, comps, plain)
    print(json.dumps({"phase": "S1 tokens", "identical_requests": same,
                      "requests": len(comps), "near_tie_gaps": gaps,
                      "tolerance": LOGITS_BF16_ATOL}), flush=True)


def s2_tiny_delta(torch, paths, common):
    """S2: a user whose records barely move the weights (lr 1e-6) drafts
    nearly its own target: acceptance above 0.9, fewer rounds than half
    the decode tokens, the plain engine's tokens."""
    import numpy as np
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import engine as engine_mod
    path = WORK / "tiny"
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    with open(path / "replay.jsonl", "w") as f:
        for step in range(4):
            f.write(json.dumps({"step": step,
                                "seed": int(rng.integers(2**31)),
                                "gs": rng.normal(size=2).astype(
                                    np.float32).tolist(),
                                "lr": 1e-6, "eps": 1e-3}) + "\n")
    argv = list(common)
    while "--adapter" in argv:
        i = argv.index("--adapter")
        del argv[i:i + 2]
    argv[argv.index("--requests") + 1] = "4"
    argv += ["--adapter", f"tiny={path}", "--paged", "--page-size", "16",
             "--prefill-chunk", "32"]
    _, plain_eng, plain, _, _ = _serve(torch, serve_mod, engine_mod, argv)
    plain_tps = plain_eng.stats.decode_tps
    del plain_eng
    _, engine, comps, _ = _spec_run(torch, paths, "S2 spec tiny",
                                    argv + ["--spec-k", str(SPEC_K)])
    st = engine.stats
    check(st.spec_accept_rate > 0.9,
          f"S2: acceptance {st.spec_accept_rate} <= 0.9")
    check(st.decode_steps < st.decode_tokens / 2,
          f"S2: {st.decode_steps} rounds for {st.decode_tokens} tokens")
    same, gaps = _hold_to_plain(torch, "S2", argv, None, comps, plain)
    print(json.dumps({"phase": "S2 tokens", "identical_requests": same,
                      "requests": len(comps), "near_tie_gaps": gaps,
                      "plain_decode_tok_s": plain_tps,
                      "spec_decode_tok_s": st.decode_tps}), flush=True)


def s3_int8_spec(torch, paths, paged_argv, base, plain):
    """S3: Q3's int8 base drafts for itself and its users; tokens held
    against Q3's plain tokens."""
    argv = paged_argv + ["--spec-k", str(SPEC_K)]
    _, engine, comps, _ = _spec_run(torch, paths, "S3 spec int8", argv,
                                    params=base)
    same, gaps = _hold_to_plain(torch, "S3", paged_argv, base, comps, plain)
    print(json.dumps({"phase": "S3 tokens", "identical_requests": same,
                      "requests": len(comps), "near_tie_gaps": gaps,
                      "tolerance": LOGITS_BF16_ATOL}), flush=True)


def s4_sampled(torch, paths, paged_argv):
    """S4: 4 sampled requests (top-k 8) with --spec-k 3: full length, and
    two runs from one seed give the same tokens."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    argv = list(paged_argv)
    argv[argv.index("--requests") + 1] = "4"
    argv += ["--spec-k", str(SPEC_K), "--sample", "--topk", "8"]
    args = serve_mod.build_parser().parse_args(argv)
    runs = []
    for i in range(2):
        ops.reset_launches()
        engine, comps, dt = serve_mod.run(args)
        torch.cuda.synchronize()
        if i == 0:
            paths["S4 spec sampled"] = _snapshot(ops)
            _check_prefill_body("S4 spec sampled", paths["S4 spec sampled"])
        runs.append([c.tokens.tolist() for c in comps])
        check(len(comps) == 4 and all(
            len(c.tokens) == args.gen and 0 <= min(c.tokens) and
            max(c.tokens) < engine.cfg.vocab for c in comps),
            f"S4 run {i}: incomplete or bad sampled completions")
    check(runs[0] == runs[1], "S4: one seed gave two token streams")
    st = engine.stats
    print(json.dumps({"phase": "S4 spec sampled", "requests": 4,
                      "reproduced": True, "accept_rate": st.spec_accept_rate,
                      "rounds": st.decode_steps,
                      "decode_tok_s": st.decode_tps, "seconds": dt,
                      "launches": paths["S4 spec sampled"]}), flush=True)


# ---------------------------------------------------------------------------
# T1-T4: fused MeZO training


def _leaf_counts(cfg):
    """Launches a fused step must make at K = 1 on the layernorm, biased
    configs of this path (OPT-1.3B, RoBERTa-large), read off the code:
    every floating 2-D weight the forward uses goes through ``zo_matmul``
    (``PerturbCtx.matmul``), every norm scale/bias and projection bias
    through ``zo_add`` (``PerturbCtx.perturb``), embeddings through
    ``z_rows`` (no kernel); the sgd update sweeps every leaf once with
    ``zo_add``; ``flash_attention`` runs once a layer a forward."""
    fwd_mm, fwd_add, n_leaves = _forward_counts(cfg)
    return {"zo_matmul": 2 * fwd_mm,
            "zo_add": n_leaves + 2 * fwd_add,
            "flash_attention": (2 * cfg.n_layers
                                if cfg.attn_impl == "flash" else 0),
            "zo_matmul_q": 0, "zo_add_q": 0}


def _forward_counts(cfg):
    """(2-D weights a fused forward multiplies by, norm/bias leaves it
    perturbs, leaves of the tree) on the configs of these paths."""
    from repro_torch.models.transformer import param_shapes
    per_layer_mm = 6                       # wq wk wv wo w_in w_out
    per_layer_add = 4 + 6                  # 2 norms' scale+bias, 6 biases
    head_mm = 1                            # lm_head, or the CLS head
    head_add = 2 + (1 if cfg.n_classes else 0)   # ln_f, cls_head/b
    return (cfg.n_layers * per_layer_mm + head_mm,
            cfg.n_layers * per_layer_add + head_add,
            len(param_shapes(cfg)))


def _snapshot(ops):
    """Launches since the last reset: by kernel, and for the two-body
    kernels by body too (``"zo_matmul/tc"``, ``"zo_matmul/simt"``)."""
    return {**ops.LAUNCHES, **ops.BODIES}


def _check_bodies(label, launches, want, bf16):
    """The two-body kernels' launches ``want`` (read off the code) are all
    on the tensor-core body on a bf16 path -- every path here draws
    Rademacher z -- and all on the SIMT body on an f32 one
    (``csrc/zo_matmul.cu``'s and ``csrc/flash_attention.cu``'s rule)."""
    body, other = ("tc", "simt") if bf16 else ("simt", "tc")
    exp = {}
    for k, n in want.items():
        if f"{k}/tc" in launches:
            exp[f"{k}/{body}"], exp[f"{k}/{other}"] = n, 0
    got = {k: launches[k] for k in exp}
    print(json.dumps({"phase": f"{label} bodies", "launches": got,
                      "expected": exp}), flush=True)
    check(got == exp, f"{label}: launches by body {got} != expected {exp}")


def _check_prefill_body(label, launches):
    """A bf16 serving path runs every flash_prefill launch on the
    tensor-core body (``csrc/flash_prefill.cu``'s rule)."""
    _check_bodies(label, launches,
                  {"flash_prefill": launches["flash_prefill"]}, True)


def _check_launches(label, launches, cfg, steps):
    want = {k: steps * v for k, v in _leaf_counts(cfg).items()}
    got = {k: launches[k] for k in want}
    print(json.dumps({"phase": label, "launches": launches,
                      "expected": want}), flush=True)
    check(got == want, f"{label}: launches {got} != expected {want}")
    _check_bodies(label, launches, want, cfg.dtype == "bfloat16")


def _batches(cfg, bsz, seq):
    """The CLI's batch stream for ``cfg`` (seed 0)."""
    from repro_torch.data.synthetic import lm_batches, sst2_batches
    gen = sst2_batches if cfg.n_classes else lm_batches
    return gen(bsz, seq, cfg.vocab, seed=0)


def _first_batch(torch, cfg, bsz, seq):
    return {k: torch.as_tensor(v).to("cuda")
            for k, v in next(_batches(cfg, bsz, seq)).items()}


def _timed_steps(torch, strategy, loss_fn, state, batch, mcfg, n):
    """Mean host-clock seconds of ``n`` synchronized steps."""
    from repro_torch.core import rng
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        state, _ = strategy.step(loss_fn, state, batch,
                                 rng.fold_seed(12345, i), mcfg)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n, state


def train_main_path(torch, paths):
    """T1: the CLI, full-width OPT-1.3B, 4 fused steps at B 8, S 128."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    ckpt = WORK / "train_opt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", "opt-1.3b", "--optimizer", "mezo-fused", "--steps",
            str(TRAIN_STEPS), "--batch", str(TRAIN_B), "--seq",
            str(TRAIN_S), "--ckpt-dir", str(ckpt), "--log-every", "1",
            "--seed", "0"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    tr = train_mod.run(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _snapshot(ops)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    paths["train_opt"] = launches
    cfg = tr.mcfg
    check(len(tr.losses) == TRAIN_STEPS
          and all(math.isfinite(x) for x in tr.losses),
          f"T1 losses {tr.losses}")
    _check_launches("T1 launches", launches, cfg, TRAIN_STEPS)

    # step-0 snapshot + replay of the log tail == the live parameters
    mgr = CheckpointManager(str(ckpt), mezo_cfg=tr.tcfg.mezo,
                            update_rule=tr.strategy.update)
    like = tr.strategy.init_state(
        {k: torch.empty_like(v) for k, v in tr.params.items()},
        tr.tcfg.mezo)
    t1 = time.perf_counter()
    restored, nxt = mgr.restore(like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    mgr.log.close()
    check(nxt == TRAIN_STEPS, f"T1 restore resumes at {nxt}")
    diff = [k for k in tr.params
            if not torch.equal(restored.params[k], tr.params[k])]
    check(not diff, f"T1 restore differs from the live params in {diff[:3]}")
    del restored, like
    torch.cuda.empty_cache()

    batch = _first_batch(torch, cfg, TRAIN_B, TRAIN_S)
    state = tr.strategy.init_state(tr.params, tr.tcfg.mezo)
    torch.cuda.reset_peak_memory_stats()
    step_s, state = _timed_steps(torch, tr.strategy, tr.model.loss, state,
                                 batch, tr.tcfg.mezo, 2)
    step_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(json.dumps({"phase": "T1 train", "losses": tr.losses,
                      "run_seconds": dt, "restore_seconds": restore_s,
                      "restore_bit_exact": True, "step_s": step_s,
                      "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
                      "peak_memory_gib": peak_gb,
                      "step_peak_memory_gib": step_peak_gb}), flush=True)
    return tr, state, batch


def profile_train(torch, tr, state, batch, label="T4 profile"):
    """T4 (and Q2's): one fused OPT-1.3B step under the profiler; T4's
    launches against one T1 step's, read off the code."""
    from repro_torch.core import rng
    from repro_torch.kernels import ops

    def one():
        tr.strategy.step(tr.model.loss, state, batch, rng.fold_seed(777, 0),
                         tr.tcfg.mezo)
    ops.reset_launches()
    wall_us, by_name = _profiled(torch, one)
    _profile_line(label, wall_us, by_name, steps=1)
    if tr.tcfg.quant == "none":
        _check_launches(f"{label} launches", _snapshot(ops), tr.mcfg, 1)


def train_fused_vs_materialized(torch, paths, arch, label, tol):
    """T2 / T3: the Trainer API with attn_impl="flash", 2 fused steps; the
    first loss against the materialized one (add_scaled_z through the
    zo_add kernel, then the unperturbed forward, chunked attention)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import MezoConfig, add_scaled_z, rng
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.runtime import Trainer, TrainerConfig
    base = get_config(arch)
    cfg = dataclasses.replace(base, attn_impl="flash")
    mcfg = MezoConfig(eps=1e-3, lr=1e-4)
    tr = Trainer(cfg, TrainerConfig(optimizer="mezo-fused", mezo=mcfg,
                                    n_steps=2, log_every=1, seed=0,
                                    device="cuda"),
                 _batches(cfg, TRAIN_B, TRAIN_S))
    params = tr.init_params()
    # the materialized reference on the first step's batch and direction
    batch = _first_batch(torch, cfg, TRAIN_B, TRAIN_S)
    s = rng.fold_seed(rng.fold_seed(0, 0), 0)
    eps = torch.tensor(mcfg.eps, dtype=torch.float32)
    chunked = build_model(dataclasses.replace(base, attn_impl="chunked"))
    with torch.no_grad():
        lp = chunked.loss(add_scaled_z(params, s, eps), batch)
        lm = chunked.loss(add_scaled_z(params, s, -eps), batch)
    mat = float(0.5 * (lp + lm))
    torch.cuda.empty_cache()
    ops.reset_launches()
    t0 = time.perf_counter()
    tr.train(params)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _snapshot(ops)
    paths[label] = launches
    _check_launches(f"{label} launches", launches, cfg, 2)
    err = abs(tr.losses[0] - mat)
    print(json.dumps({"phase": label, "arch": arch, "losses": tr.losses,
                      "materialized_loss": mat, "abs_err": err,
                      "tolerance": tol, "seconds": dt}), flush=True)
    check(all(math.isfinite(x) for x in tr.losses),
          f"{label}: losses {tr.losses}")
    check(err <= tol, f"{label}: fused loss {tr.losses[0]} vs materialized "
          f"{mat}: {err} > {tol}")


# ---------------------------------------------------------------------------
# Q1-Q3: the int8 base


def _gib(n_bytes) -> float:
    return n_bytes / 2**30


def q1_frozen_base(torch, paths, arch, tol):
    """Q1: full-width ``arch`` quantized with no deltas (a frozen base);
    the fused loss at +-eps against the loss at ``ctx.materialize``."""
    from repro_torch.configs import get_config
    from repro_torch.core import PerturbCtx
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim.quant import (is_quantized, quantize_tree,
                                         quantized_bytes, tensor_bytes)
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    full_bytes = sum(tensor_bytes(t) for t in params.values())
    qparams = quantize_tree(params)
    del params
    torch.cuda.empty_cache()
    resident, f32_eq = quantized_bytes(qparams)
    n_q = sum(is_quantized(v) for v in qparams.values())
    batch = _first_batch(torch, cfg, TRAIN_B, TRAIN_S)
    eps, seed = 1e-3, 4242
    fwd_mm, fwd_add, n_leaves = _forward_counts(cfg)
    fused, mat = {}, {}
    with torch.no_grad():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        for c in (eps, -eps):
            fused[c] = float(model.loss(qparams, batch,
                                        perturb=PerturbCtx(seed, c)))
        torch.cuda.synchronize()
        fused_s = (time.perf_counter() - t0) / 2
        fused_launches = _snapshot(ops)
        peak = torch.cuda.max_memory_allocated()
        ops.reset_launches()
        for c in (eps, -eps):
            mat[c] = float(model.loss(PerturbCtx(seed, c).materialize(
                qparams), batch))
        torch.cuda.synchronize()
        mat_launches = _snapshot(ops)
    label = f"Q1 {arch}"
    paths[f"{label} fused"] = fused_launches
    paths[f"{label} materialized"] = mat_launches
    want_fused = {"zo_matmul_q": 2 * fwd_mm, "zo_add": 2 * fwd_add,
                  "zo_matmul": 0, "zo_add_q": 0}
    want_mat = {"zo_add_q": 2 * n_q, "zo_add": 2 * (n_leaves - n_q),
                "zo_matmul_q": 0, "zo_matmul": 0}
    err = max(abs(fused[c] - mat[c]) for c in fused)
    print(json.dumps({
        "phase": label, "dtype": cfg.dtype, "batch": [TRAIN_B, TRAIN_S],
        "quantized_leaves": n_q, "fused_loss": list(fused.values()),
        "materialized_loss": list(mat.values()), "max_abs_err": err,
        "tolerance": tol, "fused_forward_s": fused_s,
        "resident_bytes": resident, "f32_equivalent_bytes": f32_eq,
        "unquantized_bytes": full_bytes,
        "resident_gib": _gib(resident),
        "f32_over_resident": f32_eq / resident,
        "unquantized_over_resident": full_bytes / resident,
        "fused_peak_memory_gib": _gib(peak),
        "fused_peak_over_resident_gib": _gib(peak - before),
        "launches_fused": fused_launches, "expected_fused": want_fused,
        "launches_materialized": mat_launches,
        "expected_materialized": want_mat}), flush=True)
    check(all(math.isfinite(v) for v in [*fused.values(), *mat.values()]),
          f"{label}: losses {fused} {mat}")
    check({k: fused_launches[k] for k in want_fused} == want_fused,
          f"{label}: fused launches {fused_launches} != {want_fused}")
    _check_bodies(f"{label} fused", fused_launches, want_fused,
                  cfg.dtype == "bfloat16")
    check({k: mat_launches[k] for k in want_mat} == want_mat,
          f"{label}: materialize launches {mat_launches} != {want_mat}")
    check(err <= tol, f"{label}: fused vs materialized {err} > {tol}")


def q2_int8_train(torch, paths):
    """Q2: the train CLI with ``--quant int8``, OPT-1.3B, 4 fused steps."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.optim.quant import is_quantized, quantize_tree
    ckpt = WORK / "train_opt_int8"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", "opt-1.3b", "--optimizer", "mezo-fused", "--steps",
            str(TRAIN_STEPS), "--batch", str(TRAIN_B), "--seq",
            str(TRAIN_S), "--ckpt-dir", str(ckpt), "--log-every", "1",
            "--seed", "0", "--quant", "int8"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    tr = train_mod.run(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _snapshot(ops)
    peak_gb = _gib(torch.cuda.max_memory_allocated())
    paths["Q2 train int8"] = launches
    cfg = tr.mcfg
    check(len(tr.losses) == TRAIN_STEPS
          and all(math.isfinite(x) for x in tr.losses),
          f"Q2 losses {tr.losses}")
    fwd_mm, fwd_add, n_leaves = _forward_counts(cfg)
    want = {"zo_add": TRAIN_STEPS * (2 * (fwd_mm + fwd_add) + n_leaves),
            "zo_matmul_q": 0, "zo_matmul": 0, "zo_add_q": 0}
    print(json.dumps({"phase": "Q2 launches", "launches": launches,
                      "expected": want}), flush=True)
    check({k: launches[k] for k in want} == want,
          f"Q2: launches {launches} != expected {want}")

    # q and the scales bit-frozen (against the same seed's init), deltas
    # moved
    q0 = quantize_tree(tr.init_params())
    moved = 0.0
    for k, leaf in tr.params.items():
        if is_quantized(leaf):
            check(torch.equal(leaf.q, q0[k].q)
                  and torch.equal(leaf.scale, q0[k].scale),
                  f"Q2: {k} int8 values or scales moved")
            moved += leaf.delta.abs().sum().item()
    del q0
    check(moved > 0.0, "Q2: no delta moved")

    # step-0 snapshot + replay of the log tail == the live state
    mgr = CheckpointManager(str(ckpt), mezo_cfg=tr.tcfg.mezo,
                            update_rule=tr.strategy.update)
    t1 = time.perf_counter()
    restored, nxt = mgr.restore(tr.strategy.init_state(tr.params,
                                                       tr.tcfg.mezo))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    mgr.log.close()
    check(nxt == TRAIN_STEPS, f"Q2 restore resumes at {nxt}")
    for k, live in tr.params.items():
        got = restored.params[k]
        same = (torch.equal(got.q, live.q) and torch.equal(got.scale,
                                                           live.scale)
                and torch.equal(got.delta, live.delta)
                if is_quantized(live) else torch.equal(got, live))
        check(same, f"Q2 restore differs from the live params at {k}")
    del restored
    torch.cuda.empty_cache()

    batch = _first_batch(torch, cfg, TRAIN_B, TRAIN_S)
    state = tr.strategy.init_state(tr.params, tr.tcfg.mezo)
    torch.cuda.reset_peak_memory_stats()
    step_s, state = _timed_steps(torch, tr.strategy, tr.model.loss, state,
                                 batch, tr.tcfg.mezo, 2)
    step_peak_gb = _gib(torch.cuda.max_memory_allocated())
    profile_train(torch, tr, state, batch, "Q2 profile")
    print(json.dumps({"phase": "Q2 train int8", "losses": tr.losses,
                      "run_seconds": dt, "restore_seconds": restore_s,
                      "restore_bit_exact": True, "step_s": step_s,
                      "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
                      "peak_memory_gib": peak_gb,
                      "step_peak_memory_gib": step_peak_gb,
                      "delta_abs_sum": moved}), flush=True)


def q3_int8_serving(torch, paths, paged_argv, dense_argv):
    """Q3: phase 4's requests from one int8 base; then a compact user."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import build_model
    from repro_torch.optim.quant import is_quantized, quantize_tree
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve import engine as engine_mod
    cfg = get_config("opt-1.3b")
    base = quantize_tree(build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda"))
    ops.reset_launches()
    args, engine, comps, dt, first = _serve(torch, serve_mod, engine_mod,
                                            paged_argv, params=base)
    torch.cuda.synchronize()
    launches = _snapshot(ops)
    paths["Q3 serve int8"] = launches
    print(serve_mod.summary(args, engine, comps, dt), flush=True)
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"Q3: kernel {name} was not launched serving the int8 base")
    _check_prefill_body("Q3 serve int8", launches)
    check(len(comps) == 8, f"Q3: {len(comps)} completions, expected 8")
    check(sorted({str(c.user) for c in comps}) == ["None", "alice", "bob"],
          f"Q3 served users {sorted({str(c.user) for c in comps})}")
    for comp in comps:
        t = comp.tokens
        check(t.shape == (32,) and int(t.min()) >= 0
              and int(t.max()) < cfg.vocab,
              f"Q3 rid {comp.rid}: bad tokens {t.tolist()}")
        check(torch.isfinite(first[comp.rid]).all().item(),
              f"Q3 rid {comp.rid}: non-finite first-step logits")
    store, model = engine.store, engine.model
    del engine

    # the cache charges each user's own bytes only: deltas and the small
    # unquantized leaves, never the shared int8 values and scales
    per_user = shared = 0
    for user in store.users():
        for k, leaf in store.materialize(user).items():
            if is_quantized(leaf):
                check(leaf.q is base[k].q, f"Q3: {user} copied {k}'s q")
                per_user += leaf.delta.numel() * 4
                shared += leaf.q.numel() + leaf.scale.numel() * 4
            else:
                per_user += leaf.numel() * leaf.element_size()
    cached = store.cached_bytes()
    check(cached == per_user, f"Q3: cached_bytes {cached} != {per_user}")

    c0 = comps[0]
    check(c0.user == "alice", f"Q3 rid 0 served by {c0.user}")
    prompt = torch.as_tensor(c0.prompt, dtype=torch.long,
                             device="cuda")[None]
    base_lg, _ = model.prefill(base, model.init_cache(1, 96, device="cuda"),
                               prompt)
    base_row = base_lg[0, -1].float().cpu()
    diff_user = (first[0] - base_row).abs().max().item()
    check(diff_user > LOGITS_BF16_ATOL,
          f"Q3: alice's logits equal the base's (max diff {diff_user})")

    # the dense-mode engine on the same int8 base as the reference
    _, _, dense_comps, _, dense_first = _serve(torch, serve_mod, engine_mod,
                                               dense_argv, params=base)
    worst = max((first[r] - dense_first[r]).abs().max().item()
                for r in first)
    check(worst <= LOGITS_BF16_ATOL,
          f"Q3: paged/chunked first-step logits differ from dense by "
          f"{worst}")

    # alice's compact int8 delta against her replayed weights
    t0 = time.perf_counter()
    store.put_delta("alice_int8", store.export_delta("alice"))
    compact = store.materialize("alice_int8")
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    mat = store.materialize("alice")
    eff = (lambda x: x.dequantize_f32() if is_quantized(x) else x.float())
    worst_eff = 0.0
    for k, b in base.items():
        bound_k = (eff(mat[k]) - eff(b)).abs().max().item() / 127.0 \
            + Q_EFF_ATOL
        if not is_quantized(b) and b.dtype == torch.bfloat16:
            # a bf16 leaf stores both sides rounded to bf16: one more
            # bf16 step at the leaf's magnitude
            bound_k += (torch.finfo(torch.bfloat16).eps
                        * eff(mat[k]).abs().max().item())
        e = (eff(compact[k]) - eff(mat[k])).abs().max().item()
        check(e <= bound_k, f"Q3: compact {k} off by {e} > {bound_k}")
        worst_eff = max(worst_eff, e / bound_k)
    # the compact user serves alice's requests
    alice = [c for c in comps if c.user == "alice"]
    eng = ServeEngine(cfg, store, n_slots=4, max_len=96 + 32, seed=0,
                      paged=True, page_size=16, prefill_chunk=32,
                      device="cuda")
    for c in alice:
        eng.submit(Request(prompt=c.prompt, max_new=32, user="alice_int8"))
    compact_comps, compact_first = _recorded(torch, engine_mod, eng.run)
    check(len(compact_comps) == len(alice), "Q3: compact user's requests")
    for comp in compact_comps:
        t = comp.tokens
        check(t.shape == (32,) and int(t.min()) >= 0
              and int(t.max()) < cfg.vocab,
              f"Q3 compact rid {comp.rid}: bad tokens {t.tolist()}")
    c_row = compact_first[compact_comps[0].rid]
    check(torch.isfinite(c_row).all().item(),
          "Q3: compact user's first-step logits are not finite")
    compact_vs_user = (c_row - first[0]).abs().max().item()
    check(compact_vs_user < diff_user,
          f"Q3: the compact user's logits are {compact_vs_user} from the "
          f"replayed user's, the base's {diff_user}")
    print(json.dumps({
        "phase": "Q3 serve int8", "first_logits_max_abs_err": worst,
        "tolerance": LOGITS_BF16_ATOL, "user_vs_base_max_abs_diff": diff_user,
        "cached_bytes": cached, "per_user_bytes": per_user,
        "shared_int8_bytes_not_charged": shared,
        "compact_seconds": compact_s,
        "compact_weight_err_over_bound": worst_eff,
        "compact_vs_replayed_first_logits": compact_vs_user,
        "compact_tokens_equal_replayed": sum(
            int((a.tokens == b.tokens).all())
            for a, b in zip(compact_comps, alice)),
        "launches": launches}), flush=True)
    return base, comps


# ---------------------------------------------------------------------------
# U1-U4: multi-tenant training (one TrainEngine over one resident base)

FLEET_USERS, FLEET_SLOTS, FLEET_STEPS = 6, 4, 3


def _fleet_counts(cfg, quant, dispatches):
    """Launches the CLI's run must make, read off the code (K = 1, the
    chunked attention, every lane active or not): a dispatch runs ONE
    2U-lane forward -- each projection one ``zo_matmul_users`` (over an
    int8 base with deltas: one ``zo_add_users`` for its per-lane W'
    instead), each norm/bias leaf one ``zo_add_users`` -- and the sgd
    update sweeps every leaf once with ``zo_add_users``; no scalar
    kernel runs. Independent of U."""
    fwd_mm, fwd_add, n_leaves = _forward_counts(cfg)
    if quant == "int8":
        per = {"zo_add_users": fwd_mm + fwd_add + n_leaves,
               "zo_matmul_users": 0}
    else:
        per = {"zo_add_users": fwd_add + n_leaves,
               "zo_matmul_users": fwd_mm}
    per.update({"zo_matmul_users_q": 0, "zo_matmul": 0, "zo_add": 0,
                "zo_matmul_q": 0, "zo_add_q": 0, "flash_attention": 0})
    return per, {k: v * dispatches for k, v in per.items()}


def _lone_trainer(torch, cfg, user, quant, mz, log_dir):
    """A lone port Trainer of ``user`` (the derived seed, the CLI's batch
    stream, the CLI's seeded init) whose checkpoint manager writes the
    replay log but skips the step-0 snapshot (a multi-GB write that the
    comparison does not read). Returns (losses, final params)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.engine import SGD
    from repro_torch.launch.train_fleet import user_batches
    from repro_torch.models import build_model
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.train import derive_user_seed

    class LogOnly(CheckpointManager):
        def on_step(self, step, state, aux=None, direction_mask=None):
            self.log.append(step, aux.seed, aux.gs, self.cfg.lr,
                            self.cfg.eps, mask=direction_mask)

    fn = user_batches(cfg, user, TRAIN_B, TRAIN_S, 0)
    tr = Trainer(cfg, TrainerConfig(
        estimator="fused", update="sgd", mezo=mz, quant=quant,
        n_steps=FLEET_STEPS, seed=derive_user_seed(0, user), device="cuda",
        log_every=10 ** 6), iter([fn(t) for t in range(FLEET_STEPS)]),
        log_fn=lambda s: None)
    tr.ckpt = LogOnly(str(log_dir), mezo_cfg=mz, update_rule=SGD)
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")
    final = tr.train(params)
    tr.ckpt.log.close()
    return tr.losses, final


def _same_leaf(torch, a, b) -> bool:
    from repro_torch.optim.quant import is_quantized
    if is_quantized(a):
        return (torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
                and torch.equal(a.delta, b.delta))
    return torch.equal(a, b)


def u_fleet(torch, paths, quant):
    """U1 (bf16 base) / U2 (``--quant int8``): the ``train_fleet`` CLI at
    full width, 6 users on 4 slots, 3 steps, B 8 x S 128, mezo-fused +
    sgd; every user against a lone Trainer; one eviction and re-admission;
    the launches of the run; for U1 one dispatch under the profiler
    (U4)."""
    import shutil
    from repro_torch.core.engine import MezoConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import train_fleet
    from repro_torch.optim.quant import is_quantized, quantize_tree
    from repro_torch.train import TrainEngine, TrainJob
    label = "U2 fleet int8" if quant == "int8" else "U1 fleet"
    root = WORK / ("fleet_" + quant)
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", "opt-1.3b", "--device", "cuda", "--users",
            str(FLEET_USERS), "--slots",
            str(FLEET_SLOTS), "--steps", str(FLEET_STEPS), "--batch",
            str(TRAIN_B), "--seq", str(TRAIN_S), "--estimator", "fused",
            "--update", "sgd", "--seed", "0", "--quant", quant,
            "--log-dir", str(root / "engine"), "--out",
            str(root / "summary.json")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    engine, results = train_fleet.run(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _snapshot(ops)
    peak = _gib(torch.cuda.max_memory_allocated())
    paths[label] = launches
    st, cfg, store = engine.stats, engine.cfg, engine.store
    mz = MezoConfig(eps=1e-3, lr=1e-4)
    check(st.finished == FLEET_USERS and st.admitted == FLEET_USERS,
          f"{label}: {st}")
    check(st.user_steps == FLEET_USERS * FLEET_STEPS, f"{label}: {st}")
    per, want = _fleet_counts(cfg, quant, st.dispatches)
    got = {k: launches[k] for k in want}
    print(json.dumps({"phase": f"{label} launches", "launches": launches,
                      "expected": want, "per_dispatch": per,
                      "dispatches": st.dispatches}), flush=True)
    check(got == want, f"{label}: launches {got} != expected {want}")
    _check_bodies(label, launches, want, cfg.dtype == "bfloat16")
    resident = None
    if quant == "int8":
        # q and the scales: the CLI's seeded init quantized, bit-frozen
        q0 = quantize_tree(engine.model.init(
            torch.Generator(device="cuda").manual_seed(0), "cuda"))
        for k, leaf in store.base.items():
            if is_quantized(leaf):
                check(torch.equal(leaf.q, q0[k].q)
                      and torch.equal(leaf.scale, q0[k].scale),
                      f"{label}: {k}'s int8 values or scales moved")
                lanes = engine._state.params[k]
                check(lanes.q is leaf.q and lanes.scale is leaf.scale,
                      f"{label}: the slots copied {k}'s int8 base")
        del q0
        resident = sum(leaf.q.numel() + 4 * leaf.scale.numel()
                       for leaf in store.base.values() if is_quantized(leaf))
    if quant == "none":
        u4_profile(torch, engine)
    state_gib = _gib(sum(
        (v.delta.numel() * 4 if is_quantized(v) and v.delta is not None
         else 0) if is_quantized(v) else v.numel() * v.element_size()
        for v in engine._state.params.values()))
    del engine
    torch.cuda.empty_cache()
    store.cache_bytes = 1          # keep one materialized user at a time

    # every user against a lone Trainer: losses, parameters, replay log
    t1 = time.perf_counter()
    for r in results:
        losses, final = _lone_trainer(torch, cfg, r.user, quant, mz,
                                      root / f"lone_{r.user}")
        check(r.losses == losses, f"{label} {r.user}: losses {r.losses} != "
              f"lone {losses}")
        mat = store.materialize(r.user)
        for k, leaf in final.items():
            check(_same_leaf(torch, leaf, mat[k]),
                  f"{label} {r.user}: {k} differs from the lone run")
        log = (root / "engine" / f"{r.user}.jsonl").read_bytes()
        check(log == (root / f"lone_{r.user}" / "replay.jsonl").read_bytes(),
              f"{label} {r.user}: replay log differs from the lone run's")
        del final, mat
        torch.cuda.empty_cache()
    lone_s = time.perf_counter() - t1

    # one eviction and re-admission: user-0 evicted after one step,
    # user-1 trains in its slot meanwhile, user-0 resumes from its log
    from repro_torch.serve import AdapterStore
    ev = train_fleet.user_batches
    fresh = AdapterStore(store.base, mezo_cfg=store.cfg, device="cuda",
                         update_rule=store.rule)
    ops.reset_launches()
    eng = TrainEngine(cfg, fresh, n_slots=1, seed=0, mezo_cfg=mz)
    eng.submit(TrainJob(user="user-0", batches=ev(cfg, "user-0", TRAIN_B,
                                                  TRAIN_S, 0),
                        n_steps=FLEET_STEPS))
    eng.step()
    first = eng.evict("user-0")
    eng.submit(TrainJob(user="user-1", batches=ev(cfg, "user-1", TRAIN_B,
                                                  TRAIN_S, 0), n_steps=1))
    eng.submit(TrainJob(user="user-0", batches=ev(cfg, "user-0", TRAIN_B,
                                                  TRAIN_S, 0),
                        n_steps=FLEET_STEPS))
    resumed = [r for r in eng.run()
               if r.user == "user-0" and not r.evicted][0]
    torch.cuda.synchronize()
    paths[f"{label} evict"] = _snapshot(ops)
    del eng
    want_losses = [r for r in results if r.user == "user-0"][0].losses
    check(first.evicted and resumed.start_step == 1,
          f"{label}: eviction {first.n_steps}, resumed at "
          f"{resumed.start_step}")
    check(first.losses + resumed.losses == want_losses,
          f"{label}: evicted + resumed losses {first.losses} + "
          f"{resumed.losses} != {want_losses}")
    a, b = fresh.materialize("user-0"), store.materialize("user-0")
    for k in a:
        check(_same_leaf(torch, a[k], b[k]),
              f"{label}: the re-admitted user-0 differs at {k}")
    del a, b, fresh, store
    torch.cuda.empty_cache()
    print(json.dumps({
        "phase": label, "users": FLEET_USERS, "slots": FLEET_SLOTS,
        "steps": FLEET_STEPS, "batch": [TRAIN_B, TRAIN_S],
        "dispatches": st.dispatches, "user_steps": st.user_steps,
        "user_steps_per_s": st.user_steps_per_s,
        "dispatch_s": st.train_s / st.dispatches,
        "tokens_per_s": st.user_steps * TRAIN_B * TRAIN_S / st.train_s,
        "run_seconds": dt, "peak_memory_gib": peak,
        "stacked_state_gib": state_gib, "int8_resident_bytes": resident,
        "lanes_bit_equal_lone_trainers": True, "lone_check_seconds": lone_s,
        "evict_readmit_bit_exact": True,
        "losses": {r.user: r.losses for r in results}}), flush=True)


def u4_profile(torch, engine):
    """U4: one U1 dispatch (4 active lanes, both signs: 8 lanes) under
    the profiler, on the engine's stacked state after the CLI's run."""
    import numpy as np
    from repro_torch.core import rng
    from repro_torch.launch.train_fleet import user_batches
    cfg = engine.cfg
    lanes = [user_batches(cfg, f"user-{i}", TRAIN_B, TRAIN_S, 0)(0)
             for i in range(FLEET_SLOTS)]
    batch = {k: torch.from_numpy(np.stack([b[k] for b in lanes])).to("cuda")
             for k in lanes[0]}
    seeds = [rng.fold_seed(4321, i) for i in range(FLEET_SLOTS)]
    eps = torch.full((FLEET_SLOTS,), 1e-3)
    lr = torch.full((FLEET_SLOTS,), 1e-4)

    def one():
        engine._state, _ = engine.strategy.step_users(
            engine.model.loss, engine._state, batch, seeds, engine.mz,
            [True] * FLEET_SLOTS, eps=eps, lr=lr)
    one()                                   # warm (allocator, cuBLAS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    wall_us, by_name = _profiled(torch, one)
    _profile_line("U4 profile", wall_us, by_name, dispatches=1,
                  lanes=2 * FLEET_SLOTS, dispatch_s_unprofiled=warm_s)


def u3_shared_base(torch, paths, base):
    """U3: the user-axis fused loss over one shared base, U = 4 lanes
    (two seeds, both signs), over the bf16 base and a frozen int8 base
    (Q1's path batched): each lane's loss against the scalar fused loss
    at atol 0; launches; peak memory against Q1's. The shared base is a
    user-stacked tree of one lane (views ``v[None]``; a frozen int8 leaf
    has no lane axis), so lane i reads it as lane i % 1."""
    from repro_torch.configs import get_config
    from repro_torch.core import PerturbCtx
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim.quant import is_quantized, quantize_tree
    cfg = get_config("opt-1.3b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    if base == "int8":
        params = quantize_tree(params)
        torch.cuda.empty_cache()
    batch = _first_batch(torch, cfg, TRAIN_B, TRAIN_S)
    u = len(U_COEFFS)
    seeds = [4242, 4242, 77, 77]
    coeffs = [1e-3, -1e-3, 1e-3, -1e-3]
    lanes_batch = {k: v[None].expand(u, *v.shape) for k, v in batch.items()}
    fwd_mm, fwd_add, _ = _forward_counts(cfg)
    mm = "zo_matmul_users_q" if base == "int8" else "zo_matmul_users"
    want = {mm: fwd_mm, "zo_add_users": fwd_add, "zo_matmul": 0,
            "zo_matmul_q": 0, "zo_add": 0}
    label = f"U3 shared {base}"
    with torch.no_grad():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        shared = {k: v if is_quantized(v) else v[None]
                  for k, v in params.items()}
        got = model.loss(shared, lanes_batch, perturb=PerturbCtx(
            seed=seeds, coeff=coeffs))
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        launches = _snapshot(ops)
        peak = torch.cuda.max_memory_allocated()
        paths[label] = launches
        scalar = [model.loss(params, batch, perturb=PerturbCtx(s, c))
                  for s, c in zip(seeds, coeffs)]
    got = got.tolist()
    scalar = [x.item() for x in scalar]
    print(json.dumps({
        "phase": label, "lanes": u, "batch": [TRAIN_B, TRAIN_S],
        "losses": got, "scalar_losses": scalar,
        "user_axis_forward_s": fwd_s, "peak_memory_gib": _gib(peak),
        "peak_over_resident_gib": _gib(peak - before),
        "launches": launches, "expected": want}), flush=True)
    check(got == scalar, f"{label}: lane losses {got} != scalar {scalar}")
    check({k: launches[k] for k in want} == want,
          f"{label}: launches {launches} != {want}")
    _check_bodies(label, launches, want, cfg.dtype == "bfloat16")


def main():
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda is not available: this smoke test needs a card")

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"phase": "device", "kind": kind,
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    # 2. build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0}),
          flush=True)

    # 3. kernels against their plain versions (T0 for the training pair)
    results: dict = {}
    kernel_zo_add(torch, results)
    kernel_attention(torch, results)
    kernel_zo_matmul(torch, results)
    kernel_flash_attention(torch, results)
    kernel_zo_add_q(torch, results)
    kernel_zo_matmul_q(torch, results)
    kernel_zo_add_users(torch, results)
    kernel_zo_matmul_users(torch, results)
    kernel_flash_verify(torch, results)                   # S0
    torch.cuda.empty_cache()

    # 4-5. the serving path, and where its time goes
    paths: dict = {}
    paged_argv, dense_argv, plain = main_path(torch, paths)
    profile_path(torch, paged_argv)
    # S1-S5: self-speculative serving (S3 follows Q3)
    s1_spec_serving(torch, paths, paged_argv, plain)
    s2_tiny_delta(torch, paths, dense_argv)
    s4_sampled(torch, paths, paged_argv)
    profile_path(torch, paged_argv + ["--spec-k", str(SPEC_K)],
                 phase="S5 profile spec")
    torch.cuda.empty_cache()

    # T1 + T4: the training CLI, then one profiled step
    tr, state, batch = train_main_path(torch, paths)
    profile_train(torch, tr, state, batch)
    del tr, state, batch
    torch.cuda.empty_cache()
    # T2, T3: flash attention, fused vs materialized
    train_fused_vs_materialized(torch, paths, "opt-1.3b", "T2 flash",
                                OPT_FUSED_ATOL)
    torch.cuda.empty_cache()
    train_fused_vs_materialized(torch, paths, "roberta-large",
                                "T3 roberta", ROBERTA_FUSED_ATOL)

    # Q1-Q3: the int8 base
    torch.cuda.empty_cache()
    q1_frozen_base(torch, paths, "opt-1.3b", OPT_FUSED_ATOL)
    torch.cuda.empty_cache()
    q1_frozen_base(torch, paths, "roberta-large", ROBERTA_FUSED_ATOL)
    torch.cuda.empty_cache()
    q2_int8_train(torch, paths)
    torch.cuda.empty_cache()
    base, q3_plain = q3_int8_serving(torch, paths, paged_argv, dense_argv)
    s3_int8_spec(torch, paths, paged_argv, base, q3_plain)
    del base, q3_plain

    # U1-U4: multi-tenant training over one resident base
    torch.cuda.empty_cache()
    u_fleet(torch, paths, "none")
    torch.cuda.empty_cache()
    u_fleet(torch, paths, "int8")
    for base in ("bf16", "int8"):
        torch.cuda.empty_cache()
        u3_shared_base(torch, paths, base)

    # 6. the kernels line, then the result
    from repro_torch.kernels import ops
    replaces = {"zo_add": "src/repro/kernels/zo_perturb.py:90",
                "flash_decode": "src/repro/kernels/flash_decode.py:57",
                "flash_prefill": "src/repro/kernels/flash_prefill.py:45",
                "zo_matmul": "src/repro/kernels/zo_perturb.py:214",
                "flash_attention": "src/repro/kernels/flash_attention.py:32",
                "zo_add_q": "src/repro/kernels/zo_perturb.py:99",
                "zo_matmul_q": "src/repro/kernels/zo_perturb.py:234",
                "zo_add_users": "src/repro/kernels/zo_perturb.py:165",
                "zo_matmul_users": "src/repro/kernels/zo_perturb.py:332",
                "zo_matmul_users_q": "src/repro/kernels/zo_perturb.py:352",
                "flash_verify": "src/repro/kernels/flash_verify.py:38"}
    sources = {"zo_add_q": "zo_add", "zo_matmul_q": "zo_matmul",
               "zo_add_users": "zo_add", "zo_matmul_users": "zo_matmul",
               "zo_matmul_users_q": "zo_matmul"}
    kernels = []
    for name, rep in replaces.items():
        r = results[name]
        by_path = {p: launches[name] for p, launches in paths.items()}
        total = sum(by_path.values())
        check(total > 0, f"kernel {name} was launched on no main path")
        kernels.append({"name": name, "route": "cuda",
                        "source": "src/repro_torch/csrc/"
                                  f"{sources.get(name, name)}.cu",
                        "replaces": rep, "launches": total,
                        "launches_by_path": by_path,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        **{k: r[k] for k in ("library", "cublas_bf16_ms",
                                             "bound_f32_simt_ms", "cases")
                           if k in r},
                        **({"launches_by_body": {
                            b: sum(p[f"{name}/{b}"] for p in paths.values())
                            for b in ("tc", "simt")}}
                           if f"{name}/tc" in ops.BODIES else {})})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA card (written for an H100) and the CUDA toolkit. Phases:

1. device: the card's name and power limit; TF32 off.
2. build: every kernel of ``src/repro_torch/csrc`` with nvcc for sm_90a.
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the main path's shapes, with its time, the plain version's,
   one library call's where there is one, and the bound (the larger of
   bytes over 3.35 TB/s and operations over the peak rate of their type).
4. main path: ``repro_torch.launch.serve.run`` on full-width, 24-layer
   OPT-1.3B (bf16, random weights from a seed), paged KV with page size 16
   and chunked prefill C = 32, 4 slots, 8 greedy requests (96-token
   prompts, 32 new tokens) round-robin over two replayed ZO adapters and
   the base. Launch counts are reset just before the run and read just
   after; every kernel must have launched. The first-step logits must
   agree with the dense-mode engine (plain attention) within a bf16
   tolerance, and a user's must differ from the base's on one prompt.
5. profile: a shorter run of the same path (4 requests, 16 new tokens)
   under ``torch.profiler``: the device's busy share of the serving wall
   time and the kernels that take the most device time.
6. one ``{"kernels": [...]}`` line, then the final ``{"ok": true, ...}``.

Any failed check exits non-zero before the final line. Imports nothing of
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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


def _attn_cost(q_rows_pos, kvh, g, hd, itemsize, q_numel):
    """Bytes and flops a paged attention call needs for this data: each
    row reads keys 0..qpos; K/V of a (slot, KV head) counted once at its
    longest row; q read, out written once."""
    keys = sum(max(r) + 1 for r in q_rows_pos)          # per KV head
    kv_bytes = 2 * keys * kvh * hd * itemsize
    flops = 4 * hd * g * kvh * sum(sum(p + 1 for p in r) for r in q_rows_pos)
    return kv_bytes + 2 * q_numel * itemsize, flops


def kernel_attention(torch, results):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    dev = torch.device("cuda")
    b, h, kvh, hd, ps, n_live, c = 4, 32, 32, 64, 16, 8, 32
    dec_pos = [95, 110, 127, 40]
    pre_pos = [64, 78, 96, 8]
    cover = [max(p, q + c - 1) for p, q in zip(dec_pos, pre_pos)]
    gen = torch.Generator(device=dev).manual_seed(3)
    for name in ("flash_decode", "flash_prefill"):
        q_shape = (b, h, hd) if name == "flash_decode" else (b, c, h, hd)
        pos = dec_pos if name == "flash_decode" else pre_pos
        kern = fd.flash_decode if name == "flash_decode" else fp.flash_prefill
        ref = fd.paged_attn_ref if name == "flash_decode" \
            else fp.prefill_attn_ref
        errs = {}
        for dt, tol in ((torch.float32, ATTN_F32_ATOL),
                        (torch.bfloat16, ATTN_BF16_ATOL)):
            k, v, pages, _ = _paged_case(torch, b, ps, kvh, hd, n_live,
                                         cover, 1e4)
            k, v = k.to(dt), v.to(dt)
            pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
            q = torch.randn(q_shape, generator=gen, device=dev).to(dt)
            got = kern(q, k, v, pages, pos_t)
            want = ref(q, k, v, pages, pos_t)
            err = (got.float() - want.float()).abs().max().item()
            check(err <= tol and torch.isfinite(got).all().item(),
                  f"{name} {dt}: max err {err} > {tol}")
            errs[dt] = err
            # trash page poisoned with NaN: never read, output unchanged
            k[0], v[0] = float("nan"), float("nan")
            check(torch.equal(kern(q, k, v, pages, pos_t), got),
                  f"{name} {dt}: NaN in the trash page reached the output")
        # q, k, v, pages, pos now hold the bf16 case at the main path's
        # shapes; times on those
        k[0], v[0] = 0.0, 0.0
        ms = time_ms(lambda: kern(q, k, v, pages, pos_t), iters=200)
        plain = time_ms(lambda: ref(q, k, v, pages, pos_t), iters=50)
        # library yardstick: SDPA over the K/V gathered to logical order
        pl = pages.long()
        kk = k[pl].reshape(b, n_live * ps, kvh, hd).transpose(1, 2)
        vv = v[pl].reshape(b, n_live * ps, kvh, hd).transpose(1, 2)
        kk, vv = kk.contiguous(), vv.contiguous()
        rows = 1 if name == "flash_decode" else c
        qpos = pos_t.long()[:, None] + torch.arange(rows, device=dev)
        mask = (torch.arange(n_live * ps, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]           # (B, 1, rows, T)
        qq = q.reshape(b, rows, h, hd).transpose(1, 2).contiguous()
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask), iters=200)
        rows_pos = [[p + r for r in range(rows)] for p in pos]
        n_bytes, flops = _attn_cost(rows_pos, kvh, h // kvh, hd, 2,
                                    q.numel())
        b_ms, b_by = bound(n_bytes + 8 * b, flops, "bf16")
        print(json.dumps({"phase": "kernel", "name": name,
                          "shape": list(q_shape), "pos": pos,
                          "page_size": ps, "n_live": n_live,
                          "max_abs_err_f32": errs[torch.float32],
                          "tolerance_f32": ATTN_F32_ATOL,
                          "max_abs_err": errs[torch.bfloat16],
                          "tolerance": ATTN_BF16_ATOL, "kernel_ms": ms,
                          "plain_ms": plain, "library_ms": lib,
                          "bound_ms": b_ms, "bound_by": b_by}), flush=True)
        results[name] = {"max_abs_err": errs[torch.bfloat16], "ms": ms,
                         "plain_ms": plain, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": lib}


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


def _serve(torch, serve_mod, engine_mod, argv):
    """Run the CLI's ``run`` and record each request's first-step logits
    (the row the engine picks the first token from)."""
    first = {}
    orig = engine_mod.ServeEngine._activate

    def recording(self, slot, req, logits_row, plen):
        first[req.rid] = torch.from_numpy(logits_row.copy())
        return orig(self, slot, req, logits_row, plen)

    engine_mod.ServeEngine._activate = recording
    try:
        args = serve_mod.build_parser().parse_args(argv)
        engine, comps, dt = serve_mod.run(args)
    finally:
        engine_mod.ServeEngine._activate = orig
    return args, engine, comps, dt, first


def main_path(torch, results):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import engine as engine_mod
    users = {}
    for i, user in enumerate(("alice", "bob")):
        users[user] = WORK / user
        _write_adapter(users[user], 100 + i)
    common = ["--arch", "opt-1.3b", "--device", "cuda", "--slots", "4",
              "--requests", "8", "--prompt-len", "96", "--gen", "32",
              "--seed", "0"]
    for user, path in users.items():
        common += ["--adapter", f"{user}={path}"]
    paged = common + ["--paged", "--page-size", "16", "--prefill-chunk", "32"]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    args, engine, comps, dt, first = _serve(torch, serve_mod, engine_mod,
                                            paged)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(serve_mod.summary(args, engine, comps, dt), flush=True)
    print(json.dumps({"phase": "main_path", "launches": launches,
                      "peak_memory_gib": peak_gb,
                      "materialize_s": engine.store.stats["materialize_s"],
                      "seconds": dt}), flush=True)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
        results[name]["launches"] = n
    cfg = engine.cfg
    check(len(comps) == 8, f"{len(comps)} completions, expected 8")
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
    return paged


def profile_path(torch, paged_argv):
    """Device busy share of serving, from the profiler's kernel events
    (kernels on one stream do not overlap, so their durations add)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve as serve_mod
    argv = list(paged_argv)
    argv[argv.index("--requests") + 1] = "4"
    argv[argv.index("--gen") + 1] = "16"
    engine = serve_mod.build_engine(serve_mod.build_parser().parse_args(argv))
    for user in engine.store.users():          # replay outside the window
        engine.store.materialize(user)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(json.dumps({
        "phase": "profile", "requests": 4, "gen": 16,
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3 if by_name else "not measured",
        "device_busy_share": busy_us / wall_us if by_name
        else "not measured",
        "decode_steps": engine.stats.decode_steps,
        "top_kernels_ms": {name[:60]: us / 1e3 for name, us in top}}),
        flush=True)


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

    # 3. kernels
    results: dict = {}
    kernel_zo_add(torch, results)
    kernel_attention(torch, results)

    # 4. main path
    paged_argv = main_path(torch, results)

    # 5. where the serving time goes
    profile_path(torch, paged_argv)

    # 6. the kernels line, then the result
    replaces = {"zo_add": "src/repro/kernels/zo_perturb.py:90",
                "flash_decode": "src/repro/kernels/flash_decode.py:57",
                "flash_prefill": "src/repro/kernels/flash_prefill.py:45"}
    kernels = []
    for name in ("zo_add", "flash_decode", "flash_prefill"):
        r = results[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{name}.cu",
                        "replaces": replaces[name],
                        "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

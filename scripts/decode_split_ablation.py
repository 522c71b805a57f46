#!/usr/bin/env python3
"""Where ``flash_decode``'s split route spends its time, on the card.

  python3 scripts/decode_split_ablation.py [--chunks 64,128,256,512]

At every G >= 2 layout of ``chip_smoke.REAL_HEADS``, short and long
(``chip_smoke.GQA_DECODE_TIMED``: B 4, bf16, page 16), prints one JSON
line a case:

* ``kernels_us``: the device time of each of the route's two kernels (the
  chunk partials, the merge) a call, from ``torch.profiler`` over 50
  eager calls;
* ``ms``: CUDA-graph replays in turns (``chip_smoke.time_interleaved``)
  of the split route under its own plan (``split_plan``), under each
  fixed chunk length of ``--chunks`` (at most 32 chunks: a longer table
  takes longer chunks), each first held to the plain version within the
  bf16 limit (and a CUDA graph of the call bit-equal to the eager call);
* the bytes bound and the plan's chunk length.

Prints the card's name and power limit first. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _fixed_plan(chunk):
    def plan(hd, n_keys):
        c = max(chunk, 64 * -(-n_keys // (64 * 32)))
        return c, -(-n_keys // c)
    return plan


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", default="64,128,256,512")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd
    if not torch.cuda.is_available():
        cs.fail("torch.cuda is not available: this script needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)

    @contextlib.contextmanager
    def planned(plan):
        orig = fd.split_plan
        fd.split_plan = plan
        try:
            yield
        finally:
            fd.split_plan = orig

    for arch, (h, kvh, hd) in cs.REAL_HEADS.items():
        if h == kvh:
            continue
        for label, pos, n_live in cs.GQA_DECODE_TIMED:
            b = len(pos)
            k, v, pages, pos_t = cs._paged_case(torch, b, 16, kvh, hd,
                                                n_live, pos, 0.0)
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
            q = torch.randn((b, h, hd), generator=gen,
                            device=dev).to(torch.bfloat16)
            want = fd.paged_attn_ref(q, k, v, pages, pos_t).float()

            def call():
                return fd.flash_decode(q, k, v, pages, pos_t)

            fns = {"plan": call}
            plans = {"plan": None}
            for c in (int(x) for x in args.chunks.split(",")):
                plans[f"chunk {c}"] = _fixed_plan(c)
                fns[f"chunk {c}"] = (call, lambda p=plans[f"chunk {c}"]:
                                     planned(p))
            for name, plan in plans.items():
                with (planned(plan) if plan else contextlib.nullcontext()):
                    err = (call().float() - want).abs().max().item()
                cs.check(err <= cs.ATTN_BF16_ATOL,
                         f"{arch} {label} {name}: err {err}")
            # a CUDA graph of the call gives the eager call's bits
            eager = call()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                call()
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                graphed = call()
            g.replay()
            torch.cuda.synchronize()
            cs.check(torch.equal(graphed, eager),
                     f"{arch} {label}: the graph's output differs")
            del g
            ms = cs.time_interleaved(torch, fns)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    call()
                torch.cuda.synchronize()
            us: dict = {}
            for ev in prof.events():
                if ev.device_type == DeviceType.CUDA and \
                        "flash_decode" in ev.name:
                    key = ev.name.split("<")[0].split("::")[-1]
                    us[key] = us.get(key, 0.0) + \
                        ev.time_range.elapsed_us() / 50
            n_bytes, flops = cs._attn_cost([[p] for p in pos], kvh, h // kvh,
                                           hd, 2, q.numel())
            print(json.dumps({
                "case": f"{arch} {label}", "heads": [h, kvh, hd],
                "pos": pos, "n_live": n_live,
                "plan_chunk": fd.split_plan(hd, n_live * 16)[0],
                "ms": ms, "kernels_us": us,
                "bound_ms": cs.bound(n_bytes + 8 * b, flops, "bf16")[0]}),
                flush=True)


if __name__ == "__main__":
    main()

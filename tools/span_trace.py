"""Device time and idle time of a benchmark cell's window, put down to
the program's spans (``repro_torch.core.spans``), on a CUDA card.

    python3 tools/span_trace.py --workload opt-1.3b.fused-b16s512 \
        --seed 3000001 --turns off,on,on,off --sync-check --cross-check

From the root of a checkout. Sets the cell up as ``perfbench/run.py``
does, then runs one window a turn under the device-only profile of
``perfbench/trace.py`` (``perfbench/spans.py``'s ``traced``, which also
keeps each event's launch record), with the span recorder on or off.
Every turn prints the benchmark's own readers over its trace
(``train_tokens_per_s``, ``device_idle_pct.train``, ``step_mfu_pct.train``,
``launches_per_step.train``) and the host durations of the launch calls;
a turn with the spans on adds the share of device time put down to a
span, the device and idle seconds by span, and the per-layer numbers of
``PERF.md`` section 3 (``host_busy_pct.train`` split into the time in
launch calls, ``host_launch_pct.train``, and the rest). The trace is
read from the profiler's raw records on ``time.time_ns``, where
``perfbench/trace.py`` reads ``prof.events()`` and times the window on
``perf_counter``, so these readings of the benchmark's metrics are not
taken exactly as the benchmark takes them. ``--sync-check``
runs one more step (or dispatch) under
``torch.cuda.set_sync_debug_mode("warn")`` and lists each host sync it
reports with the spans open around it; ``--cross-check`` times one
perturbed norm and one perturbed head with its loss at the cell's shapes
with CUDA events (20 calls between two events, the median of 5), for
comparison with the attributed shares. One JSON line a turn on standard
output, the whole record in ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

READERS = ("train_tokens_per_s", "device_idle_pct.train",
           "step_mfu_pct.train", "launches_per_step.train",
           "zo_matmul_roofline", "zo_add_roofline")


def _trace_of(window):
    """The window as ``perfbench/trace.py`` reduces it (us, host s)."""
    from perfbench.trace import Trace
    t0 = window.t0_ns
    return Trace([(d.name, (d.start_ns - t0) / 1e3, (d.end_ns - t0) / 1e3)
                  for d in window.devices],
                 (window.t1_ns - window.t0_ns) / 1e9)


def _self_s_by_name(spans) -> dict:
    from perfbench import spans as ps
    out = {}
    for s, own in zip(spans, ps.self_ns(spans)):
        out[s.name] = out.get(s.name, 0.0) + own / 1e9
    return out


def turn(cell, drv, n, device, on: bool) -> dict:
    from perfbench import bench
    from perfbench import spans as ps
    from perfbench.drivers.trainer import sync
    from repro_torch.core import spans as rs
    pauses = []

    def timed_gc(phase, info):
        pauses.append((phase, info["generation"], time.perf_counter()))

    gc.callbacks.append(timed_gc)
    if on:
        rs.enable()
    try:
        work, win = ps.traced(lambda: drv.window(n), lambda: sync(device))
    finally:
        rs.disable()
        gc.callbacks.remove(timed_gc)
    anchor, spans = rs.take()
    trace = _trace_of(win)
    run = bench.RunRecord(cell=cell, setup_s=0.0, window_s=trace.window_s,
                          work=work, mem_peak=0, mem_start=0,
                          counters=drv.counters(), trace=trace)
    gc_s = [0.0, 0.0, 0.0]
    for (p0, g, t0), (_, _, t1) in zip(pauses[::2], pauses[1::2]):
        gc_s[g] += t1 - t0
    row = {"spans": on, "window_s": trace.window_s, "gc_s_by_generation":
           gc_s, "gc_full": sum(1 for p, g, _ in pauses
                                if p == "start" and g == 2),
           "device_s": trace.busy_s, "n_events": len(win.devices),
           "n_launch_records": len(win.launches)}
    lus = ps.launch_us(win)
    if lus:
        row.update({
            "launch_s": sum(lus) / 1e6,
            "launch_us_p50": lus[len(lus) // 2],
            "launch_us_p99": lus[min(len(lus) - 1, int(0.99 * len(lus)))],
            "launch_s_over_50us": sum(u for u in lus if u > 50) / 1e6})
    for name in READERS:
        row[name] = bench.reader(name)(run)
    if not on:
        return row
    attr = ps.Attribution(anchor, spans, win)
    by_self = attr.device_self_s()
    engine = run.counters.get("engine", {})
    row.update({
        "attributed_pct": 100.0 * attr.attributed_share(),
        "device_sum_s": attr.device_s,
        "self_sum_s": sum(by_self.values()),
        "host_busy_pct.train": ps.host_busy_pct(anchor, spans, win.t0_ns,
                                                win.t1_ns),
        "host_launch_pct.train": ps.host_launch_pct(anchor, spans, win),
        "host_launch_over_50us_pct": ps.host_launch_pct(anchor, spans, win,
                                                        over_us=50.0),
        "norm_device_pct.train": ps.device_pct(attr, "model.norm"),
        "head_loss_device_pct.train": ps.device_pct(attr, "model.head_loss"),
        "admit_ms_per_job": ps.ms_per_span(spans, "engine.admit"),
        "flush_ms_per_job": ps.ms_per_span(spans, "engine.flush"),
        "flush_sync_ms_per_job": ps.ms_per_span(spans, "engine.flush.sync"),
        "admitted": engine.get("admitted"),
        "finished": engine.get("finished"),
        "span_counts": ps.counts(spans),
        "device_under_s": {k: attr.device_under_s(k) for k in sorted(
            {s.name for s in spans})},
        "host_ms_per_span": {k: ps.ms_per_span(spans, k) for k in sorted(
            {s.name for s in spans})},
        "host_self_s_by_span": _self_s_by_name(spans),
        "by_span_and_kernel": sorted(attr.by_span_and_kernel().items(),
                                     key=lambda kv: -kv[1])[:40],
        **attr.breakdown(top=16)})
    return row


def sync_check(drv) -> dict:
    """One unit under the sync debug mode: each reported host sync with
    the innermost span open around it."""
    import torch

    from perfbench import spans as ps
    from repro_torch.core import spans as rs
    hits = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            hits.append((time.perf_counter_ns(), f"{filename}:{lineno}"))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        rs.enable()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            drv.window(1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            rs.disable()
    _, spans = rs.take()
    where = ps.owners(spans, [(s.t0_ns, s.t1_ns) for s in spans],
                      {i: t for i, (t, _) in enumerate(hits)})
    rows = []
    for i, (_, loc) in enumerate(hits):
        o = where[i]
        names = []
        while o >= 0:
            names.append(spans[o].name)
            o = spans[o].parent
        rows.append({"at": loc, "spans": names,
                     "in_sync_span": any(n.endswith(ps.SYNC_SUFFIX)
                                         for n in names)})
    return {"n_syncs": len(rows),
            "outside_sync_spans": [r for r in rows if not r["in_sync_span"]],
            "syncs": rows}


def _cuda_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device ms of one ``fn()``: the median over ``reps`` of the time
    between two CUDA events around ``calls`` back-to-back calls, so the
    host runs ahead of the device as it does in a step."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def cross_check(cell, drv) -> dict:
    """CUDA-event medians of one perturbed norm and one perturbed head
    with its loss, at the cell's shapes (a ``Trainer`` cell)."""
    import torch

    from repro_torch.core.perturb_ctx import PerturbCtx
    from repro_torch.models import layers as L
    from repro_torch.models import runtime as RT
    tr = drv.trainer
    plan, cfg, params = tr.model.plan, tr.model.plan.cfg, drv.params
    mz = cell.mezo
    batch = {k: torch.as_tensor(v).to(drv.device)
             for k, v in tr.batches.batch(0).items()}
    eps = torch.tensor(mz["eps"], dtype=torch.float32)
    ctx = PerturbCtx(seed=12345, coeff=eps, dist=mz["dist"])
    b, s = batch["tokens"].shape
    x = torch.randn(b, s, cfg.d_model, device=drv.device).to(L.dtype_of(cfg))
    blocks = RT.nest(params, plan.stack.scope)
    bp = RT._index(blocks, 0)
    sl = plan.stack.sublayers[0]
    lctx = RT._sub(RT._sub(ctx, plan.stack.scope).at_layer(0), sl.ln)
    aux = torch.zeros((), dtype=torch.float32, device=drv.device)

    def norm():
        L.norm_apply(cfg, RT._get(bp, sl.ln), x, lctx)

    def head_loss():
        RT._ce(plan, RT._head(plan, params, x, perturb=ctx), batch, aux)

    return {"norm_ms": _cuda_ms(norm), "head_loss_ms": _cuda_ms(head_loss)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--turns", default="off,on,on,off")
    ap.add_argument("--sync-check", action="store_true")
    ap.add_argument("--cross-check", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from perfbench import bench
    from perfbench.drivers.trainer import sync
    device = torch.device("cuda:0")
    cell = bench.load_cell(args.workload)
    drv = bench.driver_module(cell).Driver(cell, args.seed, device,
                                           args.seconds)
    n = drv.setup()
    sync(device)
    record = {"workload": cell.name, "seed": args.seed, "units": n,
              "card": torch.cuda.get_device_name(device), "turns": []}
    for t in args.turns.split(","):
        row = turn(cell, drv, n, device, t == "on")
        record["turns"].append(row)
        brief = {k: v for k, v in row.items() if not isinstance(v,
                                                               (dict, list))}
        print(json.dumps(brief), flush=True)
    if args.sync_check:
        record["sync_check"] = sync_check(drv)
        sc = record["sync_check"]
        print(json.dumps({"n_syncs": sc["n_syncs"],
                          "outside": sc["outside_sync_spans"]}), flush=True)
    if args.cross_check:
        record["cross_check"] = cross_check(cell, drv)
        print(json.dumps(record["cross_check"]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

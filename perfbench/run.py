"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The run loads the cell's files, builds the
program and its kernels (from the cache under ``build/`` after the first
run in the checkout), makes the weights and the batches from ``--seed``
on the card, warms up the cell's own shapes and sizes the window, then
measures for about ``--seconds`` seconds: the end-to-end metrics with
``--trace 0``, the per-layer ones under the device trace with
``--trace 1``. Once the window has closed it frees the program's state,
follows the program's first steps with the plain reference, and prints
the numbers compared beside their limits on standard error, then one
JSON line on standard output (its last line).

It exits non-zero and prints no result without enough CUDA cards, when
the program cannot be loaded, or when ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``repro`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """Top-level names in ``sys.modules`` that the port must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in FORBIDDEN if t in tops)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             start: float = PROCESS_START) -> dict:
    """Everything of a run after the look for a card: returns the result
    line as a dict (the tests call it on the CPU at small sizes)."""
    import torch

    from perfbench import bench, compare
    from perfbench import trace as tr
    from perfbench.drivers.trainer import sync

    device = torch.device(device)
    cuda = device.type == "cuda"
    drv = bench.driver_module(cell).Driver(cell, seed, device, seconds)
    drv.marks.append(("imports", time.perf_counter()))
    n = drv.setup()
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        mem_start = torch.cuda.memory_allocated(device)
    else:
        mem_start = 0
    setup_s = time.perf_counter() - start

    def body():
        return drv.window(n)

    trace_on, trace = bool(trace), None
    if trace_on:
        work, trace = tr.traced(body, lambda: sync(device))
        window_s = trace.window_s
    else:
        t0 = time.perf_counter()
        work = body()
        sync(device)
        window_s = time.perf_counter() - t0
    mem_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = bench.RunRecord(cell=cell, setup_s=setup_s, window_s=window_s,
                          work=work, mem_peak=mem_peak, mem_start=mem_start,
                          counters=drv.counters(), trace=trace)
    prog = drv.program_readings()
    drv.free()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = drv.reference_readings()
    upd = drv.update_readings(prog)
    parts, prev = [], start
    for part, t in drv.marks:
        parts.append(f"{part} {t - prev:.2f}")
        prev = t
    print(f"[perfbench] set-up parts (s): {', '.join(parts)}",
          file=sys.stderr)
    print(f"[perfbench] {cell.name}: set-up {setup_s:.1f} s, window "
          f"{window_s:.2f} s ({n} units), reference "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    numbers = drv.numbers(prog, ref, upd)
    correct, checks = compare.verdict(numbers, cell.workload["limits"])

    metrics = {}
    for m in (cell.per_layer if trace_on else cell.end_to_end):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(correct), "attempted": int(work["steps"]),
              "failed": 0, "metrics": metrics, "device": dev}
    if trace_on:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from perfbench import bench
    cell = bench.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0")
    found = loaded_forbidden()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; the port "
              f"must load none of {', '.join(FORBIDDEN)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

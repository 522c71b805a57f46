"""Finds a cell's files by the names in ``BENCHMARK.json``.

* ``perfbench/configs/<config>.json``: the configuration as it is run
  (``file`` in ``configs``): its ``model`` block is the port's
  ``ModelConfig`` and its ``mezo`` block the training recipe;
* ``perfbench/workloads/<cell>.json``: the cell: its ``driver`` (a
  module ``perfbench/drivers/<driver>.py``), the program path it drives
  and the ``traffic`` parameters the generator reads, and the
  ``limits`` of its correctness numbers;
* ``perfbench/metrics/<metric>.py``: one reader a metric, ``read(run)``
  returning a number or ``None`` where the run has nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict                 # the cell's entry in BENCHMARK.json
    config: dict                # perfbench/configs/<config>.json
    workload: dict              # perfbench/workloads/<cell>.json
    end_to_end: List[dict]      # the metrics this cell reports
    per_layer: List[dict]

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def mezo(self) -> dict:
        return self.config["mezo"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    workload = load_json(HERE / "workloads" / f"{name}.json")
    return Cell(name=name, entry=entry, config=config, workload=workload,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _applies(m, name)])


def driver_module(cell: Cell):
    return importlib.import_module(
        f"perfbench.drivers.{cell.workload['driver']}")


def reader(metric: str):
    """The ``read`` function of ``perfbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class RunRecord:
    """What a run measured, as the metric readers see it."""
    cell: Cell
    setup_s: float
    window_s: float
    work: dict                  # steps, tokens, flops, bounds (drivers)
    mem_peak: int               # max_memory_allocated over the window
    mem_start: int              # memory_allocated at the window's start
    counters: dict              # the program's own counters
    trace: Optional[object] = None   # trace.Trace of a --trace 1 run

"""Model FLOPs of the window's steps (``perfbench/flops.py``: every
projection and attention a forward needs, 2K forwards a step) over the
traced window's time and the peak of the configuration's precision
(``perfbench/peaks.py``)."""

from perfbench import flops


def read(run):
    if run.trace is None or not run.work.get("flops"):
        return None
    return 100.0 * run.work["flops"] / (run.trace.window_s
                                        * flops.peak_flops(run.cell.model))

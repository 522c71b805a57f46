"""Device kernels in the traced window (copies and fills left out) per
step of the driven entry: a ``Trainer`` step, or a ``TrainEngine``
dispatch."""


def read(run):
    steps = run.work.get("dispatches") or run.work.get("steps")
    if run.trace is None or not steps or not run.trace.events:
        return None
    return run.trace.n_kernels / steps

"""``torch.cuda.max_memory_allocated()`` over the window (reset after
set-up), in GiB."""


def read(run):
    return run.mem_peak / 2 ** 30 if run.mem_peak else None

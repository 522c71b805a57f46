"""Process start to the window's start: imports, the kernel build or
load, weights, warm-up and the window's sizing."""


def read(run):
    return run.setup_s

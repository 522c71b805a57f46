"""The window's peak allocation less what was allocated at its start:
memory a step takes beyond the resident state, in GiB."""


def read(run):
    if not run.mem_peak:
        return None
    return (run.mem_peak - run.mem_start) / 2 ** 30

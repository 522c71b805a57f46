"""Share of the traced window in which no device event ran:
``100 * (1 - busy / window)``, busy being the union of the device
events' intervals."""


def read(run):
    if run.trace is None or not run.trace.events:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)

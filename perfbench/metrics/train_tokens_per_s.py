"""Training tokens consumed in the window (B x S a user-step, summed over
users) over the window's whole host time."""


def read(run):
    tokens = run.work.get("tokens")
    return tokens / run.window_s if tokens else None

"""Share of the multi-tenant engine's lanes that advanced a user:
``TrainStats.user_steps / (dispatches x n_slots)`` over the window."""


def read(run):
    c = run.counters.get("engine")
    if not c or not c.get("dispatches"):
        return None
    return 100.0 * c["user_steps"] / (c["dispatches"] * c["n_slots"])

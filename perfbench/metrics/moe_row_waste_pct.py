"""Share of the expert rows the window's MoE calls computed that no
routed token filled: ``100 * (rows - assignments) / rows``, from the
program's counters (``moe.rows``: experts x capacity a call;
``moe.assignments``: tokens x top-k a call)."""


def read(run):
    c = run.counters.get("moe")
    if not c or not c.get("rows"):
        return None
    return 100.0 * (c["rows"] - c["assignments"]) / c["rows"]

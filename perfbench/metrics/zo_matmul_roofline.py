"""``zo_matmul``'s share of its roofline: the least time the window's
perturbed projections need (``flops.zo_matmul_bound_s``: per product the
larger of operations over the body's peak and bytes over HBM bandwidth)
over the device time of the kernel's bodies in the trace
(``zo_matmul_tc_kernel``, ``zo_matmul_simt_kernel``: every entry point,
the users and int8 forms included)."""

PATTERNS = (r"zo_matmul_tc_kernel", r"zo_matmul_simt_kernel")


def read(run):
    bound = run.work.get("zo_matmul_bound_s")
    if run.trace is None or not bound:
        return None
    t = run.trace.device_s(PATTERNS)
    return 100.0 * bound / t if t > 0 else None

"""``zo_add``'s share of its roofline: the bytes the window's sweeps
must read and write (``flops.zo_add_bytes_per_step``: each leaf read and
written once a sweep) over HBM bandwidth, over the device time of the
``zo_add`` kernels in the trace (``zo_add_kernel``,
``zo_add_users_kernel``, ``zo_add_q_kernel``)."""

from perfbench.peaks import HBM_BYTES_PER_S

PATTERNS = (r"zo_add_kernel", r"zo_add_users_kernel", r"zo_add_q_kernel")


def read(run):
    by = run.work.get("zo_add_bytes")
    if run.trace is None or not by:
        return None
    t = run.trace.device_s(PATTERNS)
    return 100.0 * by / HBM_BYTES_PER_S / t if t > 0 else None

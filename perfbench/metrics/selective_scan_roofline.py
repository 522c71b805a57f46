"""``selective_scan``'s share of its roofline: the least time the
window's scans need (``flops_hybrid.selective_scan_bound_s``: per scan
the larger of the least bytes over HBM bandwidth and the exponentials
and FMAs over the SFU and FP32 pipes together) over the device time of
the kernel's body in the
trace (``selective_scan_kernel``, ``csrc/selective_scan.cu``)."""

PATTERNS = (r"selective_scan_kernel",)


def read(run):
    bound = run.work.get("selective_scan_bound_s")
    if run.trace is None or not bound:
        return None
    t = run.trace.device_s(PATTERNS)
    return 100.0 * bound / t if t > 0 else None

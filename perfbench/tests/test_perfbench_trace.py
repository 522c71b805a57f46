"""The trace reduction and the metric readers against a synthetic
device trace."""

import pytest

from perfbench import bench
from perfbench.peaks import HBM_BYTES_PER_S, PEAK_FLOPS
from perfbench.trace import Trace, short_name

K_TC = "void repro_torch::(anonymous namespace)::zo_matmul_tc_kernel<2>(x)"
K_ADD = "void repro_torch::(anonymous namespace)::zo_add_kernel<float>(x)"
GEMM = "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x128x8"
# (name, start us, end us): two streams overlap on 150-200
EVENTS = [(K_TC, 0.0, 200.0), (GEMM, 150.0, 300.0),
          ("Memcpy DtoH (Device -> Pageable)", 400.0, 410.0),
          (K_ADD, 500.0, 600.0), (K_TC, 900.0, 1000.0)]


def trace():
    return Trace(EVENTS, window_s=1e-3)


def run(trace=None, **work):
    cell = bench.load_cell("opt-1.3b.fused-b16s512")
    return bench.RunRecord(cell=cell, setup_s=12.5, window_s=2.0,
                           work=work, mem_peak=3 * 2 ** 30,
                           mem_start=2 ** 30,
                           counters={"engine": {"dispatches": 4,
                                                "user_steps": 24,
                                                "n_slots": 8}},
                           trace=trace)


def test_union_gaps_and_counts():
    t = trace()
    assert t.busy_s == pytest.approx(510e-6)      # 0-300, 400-410, ...
    assert t.n_kernels == 4
    assert t.device_s(["zo_matmul_tc_kernel"]) == pytest.approx(300e-6)
    gaps = t.idle_gaps()
    assert gaps["before Memcpy DtoH "] == pytest.approx(100e-6)
    assert gaps["before zo_matmul_tc_kernel"] == pytest.approx(300e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["zo_matmul_tc_kernel", pytest.approx(3e-4)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_short_names():
    assert short_name(K_TC) == "zo_matmul_tc_kernel"
    assert short_name(GEMM) == GEMM[:60]


def test_readers():
    t = trace()
    r = run(t, steps=2, tokens=8192, flops=5e10, zo_matmul_bound_s=150e-6,
            zo_add_bytes=HBM_BYTES_PER_S * 50e-6)
    read = {m: bench.reader(m)(r) for m in (
        "device_idle_pct.train", "step_mfu_pct.train", "zo_matmul_roofline",
        "zo_add_roofline", "launches_per_step.train", "transient_mem_GiB",
        "peak_mem_GiB", "train_tokens_per_s", "setup_s",
        "lane_occupancy_pct")}
    assert read["device_idle_pct.train"] == pytest.approx(49.0)
    assert read["step_mfu_pct.train"] == pytest.approx(
        100 * 5e10 / (1e-3 * PEAK_FLOPS["bfloat16"]))
    assert read["zo_matmul_roofline"] == pytest.approx(50.0)
    assert read["zo_add_roofline"] == pytest.approx(50.0)
    assert read["launches_per_step.train"] == 2.0
    assert read["transient_mem_GiB"] == 2.0
    assert read["peak_mem_GiB"] == 3.0
    assert read["train_tokens_per_s"] == 4096.0
    assert read["setup_s"] == 12.5
    assert read["lane_occupancy_pct"] == 75.0


def test_readers_without_a_trace_read_nothing():
    r = run(None, steps=2, tokens=8192, flops=5e10, zo_matmul_bound_s=1.0,
            zo_add_bytes=1.0)
    for m in ("device_idle_pct.train", "step_mfu_pct.train",
              "zo_matmul_roofline", "zo_add_roofline",
              "launches_per_step.train"):
        assert bench.reader(m)(r) is None, m
    # a trace without the kernel: no roofline share, never 0
    r = run(Trace([(GEMM, 0.0, 10.0)], 1e-4), steps=1,
            zo_matmul_bound_s=1e-6, zo_add_bytes=1e3)
    assert bench.reader("zo_matmul_roofline")(r) is None
    assert bench.reader("zo_add_roofline")(r) is None

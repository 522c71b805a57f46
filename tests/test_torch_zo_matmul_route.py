"""The tensor-core route of ``zo_matmul`` (``csrc/zo_matmul.cu``:
``use_tc``, ``use_tma``), modelled on the CPU.

bf16 X with Rademacher z runs on the tensor cores; there the launcher
takes the Hopper body (TMA loads, 128 x 128 tiles on 2-CTA clusters, one
n256 ``wgmma`` over the joint [W | z] tile) where TMA can load X and W --
a bf16 W, 16-byte rows (K, N and W's lane stride multiples of 8 bf16)
and 16-byte bases -- and the 256 x 64 body otherwise (an int8 q, K = 33,
an unaligned base). f32 X or Gaussian z take the SIMT body. Neither M
nor the lane count decides it. ``route`` below repeats the rule; the
card holds ``repro_zo_matmul_body`` to the same table, and the Hopper
body's tile walk (every output tile written, at the cells' shapes and
the edges) and values to the plain version (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest

from repro_torch.kernels.zo_perturb import MM_BODIES


def route(dtype, dist, int8, k, n, w_stride, x_addr, w_addr):
    """``repro_zo_matmul_body``: 0 SIMT, 1 the 256 x 64 tensor-core body,
    2 the Hopper body."""
    if (dtype, dist) != ("bfloat16", "rademacher"):
        return 0
    tma = (not int8 and k % 8 == 0 and n % 8 == 0 and w_stride % 8 == 0
           and x_addr % 16 == 0 and w_addr % 16 == 0)
    return 2 if tma else 1


# The four cells' products: (lanes, M a lane, K, N, W lane stride); bf16
# OPT-1.3B at B 16 x S 512 (q/k/v/o, w_in, w_out), the tenants cell's
# 16 lanes of B 4 x S 256 over 8 slots' stacked weights, and RoBERTa's
# f32 projections (both RoBERTa cells)
CELL_SHAPES = {
    "opt fused wq": (1, 8192, 2048, 2048, 0, "bfloat16", 2),
    "opt fused w_in": (1, 8192, 2048, 8192, 0, "bfloat16", 2),
    "opt fused w_out": (1, 8192, 8192, 2048, 0, "bfloat16", 2),
    "tenants wq": (16, 1024, 2048, 2048, 2048 * 2048, "bfloat16", 2),
    "tenants w_in": (16, 1024, 2048, 8192, 2048 * 8192, "bfloat16", 2),
    "tenants w_out": (16, 1024, 8192, 2048, 8192 * 2048, "bfloat16", 2),
    "roberta wq": (1, 8192, 1024, 1024, 0, "float32", 0),
    "roberta w_in": (1, 8192, 1024, 4096, 0, "float32", 0),
}


@pytest.mark.parametrize("cell", sorted(CELL_SHAPES))
def test_route_at_the_cells_shapes(cell):
    """Every bf16 product of the OPT cells takes the Hopper body, the f32
    RoBERTa products the SIMT body, whatever the lanes and M."""
    lanes, m, k, n, stride, dtype, want = CELL_SHAPES[cell]
    assert route(dtype, "rademacher", False, k, n, stride, 0, 0) == want
    assert MM_BODIES[want] == ("simt", "tc", ("tc", "tc_tma"))[want]


@pytest.mark.parametrize("seed", range(4))
def test_route_is_tma_exactly_where_tma_can_load(seed):
    """Over random K, N, lane strides and base offsets: the Hopper body
    iff bf16 X and W, Rademacher z, and every row, lane stride and base
    a multiple of 16 bytes; the 256 x 64 body for the other bf16 /
    Rademacher launches; the SIMT body for f32 or Gaussian."""
    r = np.random.default_rng(seed)
    seen = set()
    for _ in range(2000):
        dtype = ("bfloat16", "float32")[int(r.integers(2))]
        dist = ("rademacher", "gaussian")[int(r.integers(2))]
        int8 = bool(r.integers(2))
        k, n = (int(v) * int(r.choice([1, 8]))
                for v in r.integers(1, 1100, 2))
        stride = int(r.choice([0, k * n, k * n + int(r.integers(1, 8))]))
        x_addr, w_addr = (int(v) for v in r.choice([0, 2, 8, 16, 4096], 2))
        got = route(dtype, dist, int8, k, n, stride, x_addr, w_addr)
        rows_16b = all(2 * v % 16 == 0 for v in (k, n, stride))
        bases_16b = x_addr % 16 == 0 and w_addr % 16 == 0
        if dtype == "float32" or dist == "gaussian":
            assert got == 0
        else:
            assert got == (2 if rows_16b and bases_16b and not int8 else 1)
        seen.add(got)
    assert seen == {0, 1, 2}

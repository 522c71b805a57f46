"""Port parity: the four attention kernels' plain versions at head dim 112.

kimi-k2-1t-a32b attends with 64 heads of 112 over 8 KV heads, the one
head dim of the repo's configs that is not a power of two. The port's
plain versions (the CPU path of ``ops.flash_attention``,
``ops.paged_decode_attn``, ``ops.paged_prefill_attn`` and
``ops.paged_verify_attn``) are held against the JAX Pallas kernels in
interpret mode at hd 112, GQA 8 over 2, on the same numpy inputs, in f32
(summation order: 2e-5) and bf16 (one rounding of the output, and the
paged plain versions' bf16 probabilities: 2e-2); the paged cases use
ragged positions over a scrambled page table with garbage in the trash
page. The CUDA kernels are held against the plain versions at hd 112 on
the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import flash_attention as j_fa  # noqa: E402
from repro.kernels.flash_decode import flash_decode as j_decode  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill as j_prefill  # noqa
from repro.kernels.flash_verify import flash_verify as j_verify  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_decode import KERNEL_HEAD_DIMS  # noqa: E402

torch.set_num_threads(1)

HD, H, KV, PS = 112, 8, 2, 8
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]


def _as(dtype, *arrays):
    """numpy arrays -> (JAX arrays, torch tensors), the f32 ones in
    ``dtype`` (the bf16 rounding done once, by JAX, and shared)."""
    jx, tx = [], []
    for a in arrays:
        if a.dtype != np.float32:                 # page tables, positions
            jx.append(jnp.asarray(a))
            tx.append(torch.from_numpy(a))
            continue
        jx.append(jnp.asarray(a, getattr(jnp, dtype)))
        tx.append(torch.from_numpy(np.array(jx[-1].astype(jnp.float32)))
                  .to(getattr(torch, dtype)))
    return jx, tx


def _check(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=0,
                               atol=TOL[dtype])


def _paged(seed, b, c, n_live, pos):
    """Queries (B, C, H, hd) and pools with a scrambled page table (page
    0 = trash, filled with garbage) covering pos .. pos + C - 1."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * n_live + 3
    q = rng.normal(size=(b, c, H, HD)).astype(np.float32)
    k = rng.normal(size=(n_pages, PS, KV, HD)).astype(np.float32)
    v = rng.normal(size=(n_pages, PS, KV, HD)).astype(np.float32)
    k[0] = v[0] = 7.0
    pos = np.asarray(pos, np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    pages = np.zeros((b, n_live), np.int32)
    for i in range(b):
        live = 1 + (pos[i] + c - 1) // PS
        pages[i, :live] = perm[i * n_live:i * n_live + live]
    return q, k, v, pages, pos


def test_kernels_take_head_dim_112():
    assert 112 in KERNEL_HEAD_DIMS


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention(dtype, causal):
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(2, 20, n, HD)).astype(np.float32)
              for n in (H, KV, KV)]
    (jq, jk, jv), (q, k, v) = _as(dtype, *arrays)
    want = j_fa.flash_attention(jq, jk, jv, causal=causal, blocks=(8, 16),
                                interpret=True)
    _check(ops.flash_attention(q, k, v, causal), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode(dtype):
    q, k, v, pages, pos = _paged(1, 4, 1, 4, (PS - 2, PS, 2 * PS + 3, 0))
    (jq, jk, jv, jp, jpos), (tq, tk, tv, tp, tpos) = _as(
        dtype, q[:, 0], k, v, pages, pos)
    want = j_decode(jq, jk, jv, jp, jpos, interpret=True)
    _check(ops.paged_decode_attn(tq, tk, tv, tp, tpos), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_prefill(dtype):
    q, k, v, pages, pos = _paged(2, 4, 5, 5, (PS - 2, PS, 2 * PS + 3, 0))
    (jq, jk, jv, jp, jpos), tx = _as(dtype, q, k, v, pages, pos)
    want = j_prefill(jq, jk, jv, jp, jpos, interpret=True)
    _check(ops.paged_prefill_attn(*tx), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_verify(dtype):
    q, k, v, pages, pos = _paged(3, 4, 4, 5, (PS - 2, PS, 2 * PS + 3, 0))
    (jq, jk, jv, jp, jpos), tx = _as(dtype, q, k, v, pages, pos)
    want = j_verify(jq, jk, jv, jp, jpos, interpret=True)
    _check(ops.paged_verify_attn(*tx), want, dtype)

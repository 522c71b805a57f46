"""Port parity: paged decode / chunked-prefill attention.

The port's plain versions (the CPU path of ``ops.paged_decode_attn`` /
``ops.paged_prefill_attn``) against the JAX Pallas kernels in interpret
mode and against ``paged_attn_ref`` / ``prefill_attn_ref``, at atol 1e-5
in f32 (summation order only): GQA layouts, ragged positions straddling
page boundaries, scrambled page tables, garbage in the trash page, a
chunk wider than a page, and C = 1 == decode, at page sizes 8 and 16;
and the serving path's shapes at small width: one slot's 32-token chunk
starting at 64 and at 78 (the admission prefills one slot at a time),
and a ragged 4-slot decode straddling the edges of a 64-key tile. The
CUDA kernels are held against the plain versions on the card by
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_decode import flash_decode as j_flash_decode  # noqa: E402,E501
from repro.kernels.flash_decode import paged_attn_ref as j_paged_ref  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill as j_flash_prefill  # noqa: E402,E501
from repro.kernels.flash_prefill import prefill_attn_ref as j_prefill_ref  # noqa: E402,E501
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5
PS = 8
RAGGED_POS = (PS - 2, PS, 2 * PS + 3, 0)
# GQA layouts at page sizes 8 (the ids these tests always had) and 16
# (the serving path's)
LAYOUTS = [pytest.param(kvh, g, ps, id=f"{kvh}-{g}" + ("" if ps == 8 else
                                                       f"-ps{ps}"))
           for kvh, g in [(1, 4), (2, 2), (4, 1)] for ps in (8, 16)]


def _ragged(ps):
    """RAGGED_POS at page size ps."""
    return (ps - 2, ps, 2 * ps + 3, 0)


def _case(seed, b, c, h, kvh, hd, n_live, pos, garbage=0.0, ps=PS):
    """Queries + pools with a scrambled page table (page 0 = trash, filled
    with ``garbage``), covering positions pos .. pos + c - 1."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * n_live + 3
    q = rng.normal(size=(b, c, h, hd)).astype(np.float32)
    k = rng.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32)
    k[0] = garbage
    v[0] = garbage
    pos = np.asarray(pos, np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    pages = np.zeros((b, n_live), np.int32)
    for i in range(b):
        live = 1 + (pos[i] + c - 1) // ps
        pages[i, :live] = perm[i * n_live:i * n_live + live]
    return q, k, v, pages, pos


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _decode_vs_jax(q, k, v, pages, pos):
    """The port's CPU decode against the Pallas kernel (interpret mode)
    and the JAX plain version; q (B, H, hd)."""
    got = ops.paged_decode_attn(*_t(q, k, v, pages, pos)).numpy()
    want_k = np.asarray(j_flash_decode(*_j(q, k, v, pages, pos),
                                       interpret=True))
    want_r = np.asarray(j_paged_ref(*_j(q, k, v, pages, pos)))
    np.testing.assert_allclose(got, want_k, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_r, rtol=0, atol=ATOL)


def _prefill_vs_jax(q, k, v, pages, pos):
    """The same for a chunk, q (B, C, H, hd)."""
    got = ops.paged_prefill_attn(*_t(q, k, v, pages, pos)).numpy()
    want_k = np.asarray(j_flash_prefill(*_j(q, k, v, pages, pos),
                                        interpret=True))
    want_r = np.asarray(j_prefill_ref(*_j(q, k, v, pages, pos)))
    np.testing.assert_allclose(got, want_k, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_r, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kvh,g,ps", LAYOUTS)
def test_decode_matches_jax_kernel_and_ref(kvh, g, ps):
    q, k, v, pages, pos = _case(0, 4, 1, kvh * g, kvh, 16, 4,
                                (ps - 1, ps, 2 * ps + 3, 0), garbage=7.0,
                                ps=ps)
    _decode_vs_jax(q[:, 0], k, v, pages, pos)


@pytest.mark.parametrize("kvh,g,ps", LAYOUTS)
def test_prefill_matches_jax_kernel_and_ref(kvh, g, ps):
    q, k, v, pages, pos = _case(1, 4, 4, kvh * g, kvh, 16, 4, _ragged(ps),
                                garbage=-3.0, ps=ps)
    _prefill_vs_jax(q, k, v, pages, pos)


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("start", [64, 78])
def test_prefill_serving_admission_chunk(start, ps):
    """One slot's 32-token chunk (the serving engine admits one slot at a
    time) at OPT's G = 1, starting on a 64-key tile edge and inside a
    tile; the table is one page longer than the chunk needs."""
    c = 32
    q, k, v, pages, pos = _case(6, 1, c, 2, 2, 16, (start + c) // ps + 2,
                                (start,), garbage=9.0, ps=ps)
    _prefill_vs_jax(q, k, v, pages, pos)


@pytest.mark.parametrize("ps", [8, 16])
def test_decode_ragged_across_tile_edges(ps):
    """A 4-slot decode step at positions on both sides of 64-key tile
    edges (63 | 64, 127 | 128), with GQA."""
    q, k, v, pages, pos = _case(7, 4, 1, 4, 2, 16, 128 // ps + 2,
                                (63, 64, 127, 128), garbage=5.0, ps=ps)
    _decode_vs_jax(q[:, 0], k, v, pages, pos)


def test_chunk_wider_than_page():
    for ps in (PS, 16):
        q, k, v, pages, pos = _case(2, 2, 2 * ps + 3, 4, 2, 16, 4,
                                    (3, ps + 1), ps=ps)
        got = ops.paged_prefill_attn(*_t(q, k, v, pages, pos)).numpy()
        want = np.asarray(j_prefill_ref(*_j(q, k, v, pages, pos)))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_chunk_of_one_is_decode():
    for ps in (PS, 16):
        q, k, v, pages, pos = _case(3, 4, 1, 4, 2, 16, 4, _ragged(ps),
                                    ps=ps)
        tq, tk, tv, tp, tpos = _t(q, k, v, pages, pos)
        pre = fp.prefill_attn_ref(tq, tk, tv, tp, tpos)[:, 0]
        dec = fd.paged_attn_ref(tq[:, 0].contiguous(), tk, tv, tp, tpos)
        assert torch.equal(pre, dec)


def test_launchers_reject_cpu_tensors():
    q, k, v, pages, pos = _t(*_case(4, 2, 1, 4, 2, 16, 2, (1, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        fd.flash_decode(q[:, 0], k, v, pages, pos)
    with pytest.raises(ValueError, match="CUDA"):
        fp.flash_prefill(q, k, v, pages, pos)

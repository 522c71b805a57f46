"""Port parity: the speculative verify window's paged attention.

The port's plain version (the CPU path of ``ops.paged_verify_attn``)
against the JAX Pallas kernel in interpret mode and against JAX's
``verify_attn_ref``, on the same numpy inputs: GQA layouts, ragged
positions straddling page boundaries, scrambled page tables, causal
masking inside the window, finite poison in the trash page, W = 1 equal
to ``paged_attn_ref`` bit for bit, a single live page. Tolerance: atol
2e-5, rtol 2e-4 in f32 (the JAX tests' limits; summation order only).
The CUDA kernel is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` S0.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_verify import flash_verify as j_flash_verify  # noqa: E402,E501
from repro.kernels.flash_verify import verify_attn_ref as j_verify_ref  # noqa: E402,E501
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import flash_verify as fv  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 2e-4
PS = 8
# windows that start on the last row of a page, on a fresh page, mid-page,
# and a slot whose whole history is shorter than the window
RAGGED_POS = (PS - 2, PS, 2 * PS + 3, 0)


def _case(seed, b, w, h, kvh, hd, n_live, pos, garbage=None):
    """Window queries + pools with a scrambled page table (page 0 = trash)
    covering each window (pos + w - 1), as the engine's ``_live_pages(pos
    + d)`` guarantees; ``garbage`` fills the trash page."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * n_live + 3
    q = rng.normal(size=(b, w, h, hd)).astype(np.float32)
    k = rng.normal(size=(n_pages, PS, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(n_pages, PS, kvh, hd)).astype(np.float32)
    if garbage is not None:
        k[0] = garbage
        v[0] = garbage
    pos = np.asarray(pos, np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    pages = np.zeros((b, n_live), np.int32)
    for i in range(b):
        live = 1 + (pos[i] + w - 1) // PS
        pages[i, :live] = perm[i * n_live:i * n_live + live]
    return q, k, v, pages, pos


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _port(*arrays):
    return ops.paged_verify_attn(*_t(*arrays)).numpy()


def _jax_both(*arrays):
    return (np.asarray(j_flash_verify(*_j(*arrays), interpret=True)),
            np.asarray(j_verify_ref(*_j(*arrays))))


@pytest.mark.parametrize("kvh,g", [(1, 4), (2, 2), (4, 1)])
def test_matches_jax_kernel_and_ref_gqa(kvh, g):
    case = _case(0, 4, 4, kvh * g, kvh, 16, 4, RAGGED_POS)
    got = _port(*case)
    for want in _jax_both(*case):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_causal_inside_window():
    """Offset w sees window keys [0, w] and nothing later: poisoning the
    K/V at window position j changes offsets >= j only, in the port as in
    the JAX kernel."""
    w, j = 4, 2
    q, k, v, pages, pos = _case(1, 2, w, 2, 1, 16, 3, (3, PS - 1))
    base = _port(q, k, v, pages, pos)
    k2, v2 = k.copy(), v.copy()
    for b in range(2):
        p = pos[b] + j
        k2[pages[b, p // PS], p % PS] = 1e3
        v2[pages[b, p // PS], p % PS] = 1e3
    got = _port(q, k2, v2, pages, pos)
    np.testing.assert_allclose(got[:, :j], base[:, :j], rtol=1e-6)
    assert not np.allclose(got[:, j:], base[:, j:])
    for want in _jax_both(q, k2, v2, pages, pos):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_ignores_trash_page_contents():
    """Dead table entries point at physical page 0; finite poison there
    reaches no slot's window."""
    case = _case(2, 3, 3, 4, 2, 16, 4, (3, PS, 2 * PS - 2))
    clean = _port(*case)
    q, k, v, pages, pos = case
    k, v = k.copy(), v.copy()
    k[0] = 1e4
    v[0] = 1e4
    poisoned = _port(q, k, v, pages, pos)
    np.testing.assert_allclose(poisoned, clean, rtol=1e-6)
    for want in _jax_both(q, k, v, pages, pos):
        np.testing.assert_allclose(poisoned, want, rtol=RTOL, atol=ATOL)


def test_w1_equals_paged_attn_ref_bitwise():
    """A one-token window is paged decode attention: the plain version
    equals ``paged_attn_ref`` bit for bit, as the JAX package pins."""
    q, k, v, pages, pos = _t(*_case(3, 3, 1, 4, 2, 16, 4, (PS - 1, PS, 5)))
    ours = fv.verify_attn_ref(q, k, v, pages, pos)
    theirs = fd.paged_attn_ref(q[:, 0].contiguous(), k, v, pages, pos)
    assert torch.equal(ours[:, 0], theirs)
    jk, jr = _jax_both(*[a.numpy() for a in (q, k, v, pages, pos)])
    np.testing.assert_allclose(ours.numpy(), jk, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours.numpy(), jr, rtol=RTOL, atol=ATOL)


def test_single_live_page():
    case = _case(4, 2, 3, 2, 1, 16, 1, (0, 2))
    got = _port(*case)
    for want in _jax_both(*case):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_launcher_rejects_cpu_tensors():
    q, k, v, pages, pos = _t(*_case(5, 2, 2, 2, 1, 16, 2, (1, 2)))
    with pytest.raises(ValueError, match="flash_verify: q must be a CUDA"):
        fv.flash_verify(q, k, v, pages, pos)

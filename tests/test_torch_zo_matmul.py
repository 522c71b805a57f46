"""Port parity: ``z_rows`` and the fused perturbed matmul ``zo_matmul``.

On the CPU the port's plain ``zo_matmul_ref`` is held against the JAX
Pallas kernel in interpret mode: within 1e-5 in f32 (summation order
only; prehashed stacked slices included) and within one bf16 ulp of the
result in bf16 (both dot f32 and round once). Against the JAX jnp
fallback (``x @ perturb(w)``), on a ragged shape, within 1e-5 in f32.
``z_rows`` equals the gathered field bit for bit with Rademacher z. The
card's bf16 tensor-core arithmetic, ``X W + c (X z)`` (int8: ``s (X q) +
c (X z)``), written out in f32, is within one bf16 ulp of the Pallas
kernel in bf16. The CUDA kernel is held against the plain version on the
card by ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import rng as jrng  # noqa: E402
from repro.core.perturb_ctx import PerturbCtx as JPerturbCtx  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import zo_perturb as jzo  # noqa: E402
from repro_torch.core import rng as trng  # noqa: E402
from repro_torch.core.perturb_ctx import PerturbCtx  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import zo_perturb as tzo  # noqa: E402

torch.set_num_threads(1)

MM_ATOL = 1e-5
GAUSS_ATOL = 1e-6        # Gaussian z: f32 log/cos last ulps (torch vs XLA)


def _xw(m, k, n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, k)) * 0.5).astype(dtype)
    w = (rng.normal(size=(k, n)) * 0.1).astype(dtype)
    return x, w


@pytest.mark.parametrize("dist,atol", [("rademacher", 0.0),
                                       ("gaussian", GAUSS_ATOL)])
def test_z_rows_matches_jax_and_field_gather(dist, atol):
    seed, salt = 5, 99
    ids = np.array([[0, 63, 7], [5, 5, 31]], np.int32)
    for off in (0, 1):
        base = trng.fold_leading(trng.leaf_base(seed, salt), 2) if off \
            else trng.leaf_base(seed, salt)
        got = trng.z_rows(base, torch.from_numpy(ids), 48, dist=dist,
                          prime_offset=off).numpy()
        want = np.asarray(jrng.z_rows(np.uint32(base), jnp.asarray(ids), 48,
                                      dist=dist, prime_offset=off))
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        field = trng.z_field(None, 0, (64, 48), dist=dist, base=base,
                             prime_offset=off).numpy()
        np.testing.assert_array_equal(got, field[ids])


@pytest.mark.parametrize("dist", ["rademacher", "gaussian"])
@pytest.mark.parametrize("mkn", [(8, 128, 128), (16, 96, 160),
                                 (32, 100, 60), (7, 33, 130)], ids=str)
def test_plain_zo_matmul_matches_pallas_interpret_f32(mkn, dist):
    m, k, n = mkn
    x, w = _xw(m, k, n)
    seed, salt, coeff = 7, 123, 0.01
    want = np.asarray(jzo.zo_matmul(jnp.asarray(x), jnp.asarray(w),
                                    np.uint32(seed), salt, coeff, dist=dist,
                                    blocks=(32, 32, 32), interpret=True))
    got = tzo.zo_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), seed,
                            salt, coeff, dist)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MM_ATOL)
    # ops dispatch: a CPU tensor takes the plain version
    np.testing.assert_array_equal(
        ops.zo_matmul(torch.from_numpy(x), torch.from_numpy(w), seed, salt,
                      coeff, dist).numpy(), got.numpy())


@pytest.mark.parametrize("dist", ["rademacher", "gaussian"])
def test_prehashed_stacked_slice_matches_pallas(dist):
    """A layer of a stacked (L, K, N) leaf: the layer folded into the base,
    prime_offset 1, equals the Pallas kernel's prehashed slice and the
    whole stacked field's slice."""
    (L, k, n), seed, salt = (3, 32, 64), 11, 4242
    x, w = _xw(8, k, n, seed=1)
    full_z = trng.z_field(seed, salt, (L, k, n), dist=dist)
    for layer in (0, L - 1):
        base = trng.fold_leading(trng.leaf_base(seed, salt), layer)
        got = tzo.zo_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                base, 0, 0.5, dist, prime_offset=1,
                                prehashed=True)
        want = np.asarray(jzo.zo_matmul(
            jnp.asarray(x), jnp.asarray(w), np.uint32(base), 0, 0.5,
            dist=dist, blocks=(8, 16, 32), interpret=True, prime_offset=1,
            prehashed=True))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MM_ATOL)
        direct = torch.from_numpy(x) @ (torch.from_numpy(w)
                                        + 0.5 * full_z[layer])
        np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=0,
                                   atol=MM_ATOL)


def test_plain_zo_matmul_bf16_within_one_ulp_of_pallas():
    """bf16 in, bf16 out: both sides dot f32 and round the result once,
    so they differ by at most one bf16 ulp of the result."""
    x, w = _xw(16, 64, 96, seed=2)
    jx = jnp.asarray(x, jnp.bfloat16)
    jw = jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(jzo.zo_matmul(jx, jw, np.uint32(3), 77, 0.02,
                                    blocks=(16, 32, 32), interpret=True)
                      .astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).bfloat16()
    got = tzo.zo_matmul_ref(tx, tw, 3, 77, 0.02)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("mkn", [(16, 64, 96), (7, 33, 130)], ids=str)
def test_tensor_core_decomposition_matches_pallas_bf16(mkn, quant):
    """The card's bf16 body computes ``X W + c (X z)`` (int8: ``s (X q) +
    c (X z)``) as two products of exact bf16 inputs with f32 sums. Its
    arithmetic, written out here in f32 on the same bf16 X, int8 q and
    power-of-two scales, is the Pallas kernel's f32 W' dot up to
    summation order and one rounding of W': within one bf16 ulp of the
    kernel's bf16 result, the ZO_MM_BF16 limit's class."""
    m, k, n = mkn
    x, w = _xw(m, k, n, seed=4)
    jx = jnp.asarray(x, jnp.bfloat16)
    seed, salt, coeff = 5, 321, np.float32(0.02)
    xf = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    z = tzo.tile_z(seed, salt, (k, n), 0, 0, "rademacher")
    assert set(torch.unique(z).tolist()) <= {-1.0, 1.0}   # exact in bf16
    if quant:
        rng = np.random.default_rng(6)
        q = rng.integers(-127, 128, (k, n), dtype=np.int8)
        sc = (2.0 ** rng.integers(-9, -4, n)).astype(np.float32)
        want = jzo.zo_matmul(jx, jnp.asarray(q), np.uint32(seed), salt, coeff,
                             blocks=(8, 32, 32), interpret=True,
                             scale=jnp.asarray(sc))
        prod = (xf @ torch.from_numpy(q.astype(np.float32))) \
            * torch.from_numpy(sc)
    else:
        jw = jnp.asarray(w, jnp.bfloat16)
        want = jzo.zo_matmul(jx, jw, np.uint32(seed), salt, coeff,
                             blocks=(8, 32, 32), interpret=True)
        prod = xf @ torch.from_numpy(np.array(jw.astype(jnp.float32)))
    got = (prod + float(coeff) * (xf @ z)).bfloat16().float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)


def test_ragged_matmul_matches_jax_jnp_fallback():
    """(16, 64) @ (64, 200): JAX's ctx takes its jnp fallback
    ``x @ perturb(w)``; the port's ctx the zo_matmul plain version."""
    x, w = _xw(16, 64, 200, seed=3)
    seed, coeff = 21, 1e-3
    want = JPerturbCtx(seed=np.uint32(seed), coeff=np.float32(coeff)).scope(
        "lm_head").matmul(jnp.asarray(x), jnp.asarray(w), "w")
    got = PerturbCtx(seed=seed, coeff=np.float32(coeff)).scope(
        "lm_head").matmul(torch.from_numpy(x), torch.from_numpy(w), "w")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MM_ATOL)
    salt = trng.leaf_salt("lm_head/w")
    ref = np.asarray(jref.zo_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                        np.uint32(seed), salt, coeff))
    np.testing.assert_allclose(
        tzo.zo_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), seed,
                          salt, coeff).numpy(), ref, rtol=0, atol=MM_ATOL)


def test_cuda_launcher_rejects_cpu_tensors():
    x, w = torch.zeros(4, 8), torch.zeros(8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tzo.zo_matmul_cuda(x, w, 1, 2, 0.5)

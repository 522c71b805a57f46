"""Port parity: the user-batched kernels ``zo_add_users`` and
``zo_matmul_users`` (with and without ``scale=``).

On the CPU the port's plain versions are held against the JAX Pallas
kernels in interpret mode (``repro.kernels.ops``): ``zo_add_users`` bit
for bit with Rademacher z and within 1e-6 with Gaussian z (f32 log/cos
last ulps); ``zo_matmul_users`` within 1e-5 (f32 summation order).
Inside the port every lane equals the scalar ``ops.zo_add`` /
``ops.zo_matmul`` with that lane's (seed, coeff) at atol 0, a per-lane
stacked W equals a loop of JAX scalar ``zo_matmul`` calls, prehashed
bases equal raw (seed, salt), and ``lanes=`` touches only its lanes.
The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` (U0).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import rng as trng  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import zo_perturb as tzo  # noqa: E402

torch.set_num_threads(1)

MM_ATOL = 1e-5
GAUSS_ATOL = 1e-6
SEEDS = np.array([42, 7, 1000, 3], np.uint32)
COEFFS = np.array([0.125, -0.5, 0.01, 0.0], np.float32)
DISTS = [("rademacher", 0.0), ("gaussian", GAUSS_ATOL)]


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dist,atol", DISTS)
def test_zo_add_users_matches_jax_and_scalar_lanes(dist, atol):
    w = _rand((4, 128, 256), 1)
    want = np.asarray(jops.zo_add_users(jnp.asarray(w), jnp.asarray(SEEDS),
                                        77, jnp.asarray(COEFFS), dist=dist))
    got = ops.zo_add_users(torch.from_numpy(w), SEEDS, 77, COEFFS,
                           dist=dist)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    for i in range(4):
        lone = ops.zo_add(torch.from_numpy(w[i]), int(SEEDS[i]), 77,
                          COEFFS[i], dist=dist)
        np.testing.assert_array_equal(got[i].numpy(), lone.numpy(),
                                      err_msg=f"lane {i}")


@pytest.mark.parametrize("shape", [(), (37,), (3, 5, 7)], ids=str)
def test_zo_add_users_any_rank_bf16_and_prehashed_layer(shape):
    """Any leaf rank the scalar zo_add takes; a prehashed layer base with
    prime_offset 1 (a layer slice of a stacked leaf) equals raw lanes."""
    w = torch.from_numpy(_rand((3,) + shape, 2)).to(torch.bfloat16)
    seeds = SEEDS[:3]
    got = ops.zo_add_users(w, seeds, 5, COEFFS[:3])
    bases = [trng.fold_leading(trng.leaf_base(int(s), 5), 2) for s in seeds]
    pre = ops.zo_add_users(w, bases, 0, COEFFS[:3], prime_offset=1,
                           prehashed=True)
    for i in range(3):
        assert torch.equal(got[i], ops.zo_add(w[i], int(seeds[i]), 5,
                                              COEFFS[i]))
        assert torch.equal(pre[i], ops.zo_add(w[i], bases[i], 0, COEFFS[i],
                                              prime_offset=1,
                                              prehashed=True))


def test_zo_add_users_lanes_touch_only_their_lanes():
    w = torch.from_numpy(_rand((4, 16, 24), 3))
    keep = w.clone()
    out = ops.zo_add_users(w, SEEDS[[1, 3]], 9, COEFFS[[1, 3]], out=w,
                           lanes=[1, 3])
    assert out is w
    for lane, i in ((1, 1), (3, 3)):
        assert torch.equal(w[lane], ops.zo_add(keep[lane], int(SEEDS[i]), 9,
                                               COEFFS[i]))
    assert torch.equal(w[0], keep[0]) and torch.equal(w[2], keep[2])
    with pytest.raises(ValueError, match="out="):
        ops.zo_add_users(w, SEEDS[:1], 9, COEFFS[:1], lanes=[0])


@pytest.mark.parametrize("dist,atol", DISTS)
def test_zo_matmul_users_shared_w_matches_jax_and_scalar_lanes(dist, atol):
    x = _rand((4, 64, 128), 4, 0.1)
    w = _rand((128, 256), 5, 0.1)
    want = np.asarray(jops.zo_matmul_users(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(SEEDS), 123,
        jnp.asarray(COEFFS), dist=dist))
    got = ops.zo_matmul_users(torch.from_numpy(x), torch.from_numpy(w),
                              SEEDS, 123, COEFFS, dist=dist)
    assert got.shape == (4, 64, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MM_ATOL)
    for i in range(4):
        lone = ops.zo_matmul(torch.from_numpy(x[i]), torch.from_numpy(w),
                             int(SEEDS[i]), 123, COEFFS[i], dist=dist)
        np.testing.assert_array_equal(got[i].numpy(), lone.numpy())


@pytest.mark.parametrize("dist", ["rademacher", "gaussian"])
def test_zo_matmul_users_per_lane_w_matches_jax_scalar_loop(dist):
    """A stacked (P, K, N) W -- what vmap makes of the scalar zo_matmul in
    the reference's multi-tenant step -- against a loop of JAX scalar
    zo_matmul calls; 2P lanes read W lane i % P (both signs of P users)."""
    p = 2
    x = _rand((2 * p, 32, 128), 6, 0.1)
    w = _rand((p, 128, 128), 7, 0.1)
    seeds, coeffs = SEEDS[:2 * p], COEFFS[:2 * p]
    got = ops.zo_matmul_users(torch.from_numpy(x), torch.from_numpy(w),
                              seeds, 31, coeffs, dist=dist)
    for i in range(2 * p):
        want = np.asarray(jops.zo_matmul(
            jnp.asarray(x[i]), jnp.asarray(w[i % p]), jnp.uint32(seeds[i]),
            31, jnp.float32(coeffs[i]), dist=dist))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0,
                                   atol=MM_ATOL, err_msg=f"lane {i}")
        lone = ops.zo_matmul(torch.from_numpy(x[i]),
                             torch.from_numpy(w[i % p]), int(seeds[i]), 31,
                             coeffs[i], dist=dist)
        np.testing.assert_array_equal(got[i].numpy(), lone.numpy())


@pytest.mark.parametrize("dist", ["rademacher", "gaussian"])
def test_zo_matmul_users_int8_matches_jax_and_scalar_lanes(dist):
    rng = np.random.default_rng(8)
    x = _rand((4, 32, 128), 9, 0.1)
    q = rng.integers(-127, 128, (128, 128)).astype(np.int8)
    scale = (2.0 ** rng.integers(-12, -6, 128)).astype(np.float32)
    want = np.asarray(jops.zo_matmul_users(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(SEEDS), 9,
        jnp.asarray(COEFFS), dist=dist, scale=jnp.asarray(scale)))
    got = ops.zo_matmul_users(torch.from_numpy(x), torch.from_numpy(q),
                              SEEDS, 9, COEFFS, dist=dist,
                              scale=torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MM_ATOL)
    for i in range(4):
        lone = ops.zo_matmul(torch.from_numpy(x[i]), torch.from_numpy(q),
                             int(SEEDS[i]), 9, COEFFS[i], dist=dist,
                             scale=torch.from_numpy(scale))
        np.testing.assert_array_equal(got[i].numpy(), lone.numpy())


@pytest.mark.parametrize("scaled", [False, True])
def test_zo_matmul_users_prehashed_matches_raw(scaled):
    x = torch.from_numpy(_rand((4, 32, 128), 10, 0.1))
    w = torch.from_numpy(_rand((128, 128), 11, 0.1))
    kw = {}
    if scaled:
        w = torch.clamp(torch.round(w * 1000), -127, 127).to(torch.int8)
        kw["scale"] = torch.full((128,), 2.0 ** -10)
    raw = ops.zo_matmul_users(x, w, SEEDS, 55, COEFFS, **kw)
    bases = [trng.leaf_base(int(s), 55) for s in SEEDS]
    pre = ops.zo_matmul_users(x, w, bases, 0, COEFFS, prehashed=True, **kw)
    assert torch.equal(raw, pre)
    want = np.asarray(jops.zo_matmul_users(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(np.array(bases, np.uint32)), 0, jnp.asarray(COEFFS),
        prehashed=True,
        scale=None if not scaled else jnp.asarray(kw["scale"].numpy())))
    np.testing.assert_allclose(pre.numpy(), want, rtol=0, atol=MM_ATOL)


def test_user_wrappers_reject_what_they_do_not_take():
    x = torch.zeros((3, 4, 8))
    with pytest.raises(ValueError, match="lanes"):
        ops.zo_matmul_users(x, torch.zeros((2, 8, 8)), SEEDS[:3], 0, 0.1)
    with pytest.raises(ValueError, match="coefficients"):
        ops.zo_add_users(torch.zeros((3, 4)), SEEDS[:3], 0, COEFFS[:2])
    with pytest.raises(ValueError, match="seeds"):
        ops.zo_add_users(torch.zeros((3, 4)), SEEDS[:2], 0, 0.1)
    # chunks of at most MAX_LANES lanes keep lane j on W lane j % P
    assert tzo._lane_chunks(8, 4) == [(0, 8, 4)]
    assert tzo._lane_chunks(130, 2) == [(0, 64, 2), (64, 128, 2),
                                        (128, 130, 2)]
    assert tzo._lane_chunks(200, 100) == [(0, 64, 64), (64, 100, 36),
                                          (100, 164, 64), (164, 200, 36)]

"""Port parity: the counter-hash RNG of ``repro_torch`` against ``repro``.

Hash bits and Rademacher z are held bit for bit (atol 0) for leaf ranks
0-5, with offsets, prime offsets and pre-hashed bases; Gaussian z within
1e-6 (torch's and XLA's f32 log/cos differ in the last ulps).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import rng as jrng  # noqa: E402
from repro_torch.core import rng as trng  # noqa: E402

torch.set_num_threads(1)

SHAPES = [(), (7,), (5, 9), (2, 3, 5), (2, 2, 3, 4), (1, 2, 2, 3, 3)]


def _jbits(*args, **kw):
    return np.asarray(jrng._coord_hash(*args, **kw)).astype(np.int64)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("prime_offset", [0, 1])
def test_hash_bits_bit_exact(shape, prime_offset):
    seed, salt = np.uint32(0xDEADBEEF), jrng.leaf_salt("blocks/attn/wq/w")
    want = _jbits(seed, salt, shape, prime_offset=prime_offset)
    got = trng._coord_hash(int(seed), salt, shape,
                           prime_offset=prime_offset).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_rademacher_field_bit_exact(shape):
    seed, salt = np.uint32(2**31 + 17), 12345
    want = np.asarray(jrng.z_field(seed, salt, shape))
    got = trng.z_field(int(seed), salt, shape).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gaussian_field_within_tolerance(shape):
    seed, salt = np.uint32(99), jrng.leaf_salt("lm_head/w")
    want = np.asarray(jrng.z_field(seed, salt, shape, dist="gaussian"))
    got = trng.z_field(int(seed), salt, shape, dist="gaussian").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_offsets_and_base_bit_exact():
    seed, salt = np.uint32(7), 4242
    base = int(jrng.leaf_base(seed, salt))
    assert trng.leaf_base(7, salt) == base
    want = _jbits(None, 0, (6, 10), offsets=(3, 2**32 - 4), prime_offset=1,
                  base=np.uint32(base))
    got = trng._coord_hash(None, 0, (6, 10), offsets=(3, 2**32 - 4),
                           prime_offset=1, base=base).numpy()
    np.testing.assert_array_equal(got, want)


def test_fold_seed_and_fold_leading():
    for seed in (0, 1, 2**32 - 1, 123456789):
        for k in (0, 1, 5, 2**31):
            assert trng.fold_seed(seed, k) == int(
                jrng.fold_seed(np.uint32(seed), np.uint32(k)))
            assert trng.fold_leading(seed, k, dim=2) == int(
                jrng.fold_leading(np.uint32(seed), np.uint32(k), dim=2))
    assert trng.leaf_salt("embed/pos") == jrng.leaf_salt("embed/pos")


@pytest.mark.parametrize("dist", ["rademacher", "gaussian"])
def test_stacked_slice_equals_folded_base(dist):
    """A layer of a stacked (L, m, n) leaf == the slice field with the
    layer folded into the base (the rank-0 slice case included)."""
    seed, salt = 31337, trng.leaf_salt("blocks/mlp/w_in/w")
    full = trng.z_field(seed, salt, (3, 4, 6), dist=dist)
    for layer in range(3):
        base = trng.fold_leading(trng.leaf_base(seed, salt), layer)
        part = trng.z_field(None, 0, (4, 6), dist=dist, base=base,
                            prime_offset=1)
        np.testing.assert_array_equal(part.numpy(), full[layer].numpy())
    vec = trng.z_field(seed, salt, (5,))
    for i in range(5):
        base = trng.fold_leading(trng.leaf_base(seed, salt), i)
        one = trng.z_field(None, 0, (), base=base, prime_offset=1)
        assert float(one) == float(vec[i])
        want = np.asarray(jrng.z_field(None, 0, (), base=np.uint32(base),
                                       prime_offset=1))
        assert float(one) == float(want)


def test_tensor_seeds_match_int_seeds():
    seeds = torch.tensor([0, 5, 2**32 - 1], dtype=torch.int64)
    got = trng.avalanche(seeds).tolist()
    assert got == [trng.avalanche(int(s)) for s in seeds]

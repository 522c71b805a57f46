"""Port parity: forward-only ``flash_attention`` (GQA, causal or
bidirectional).

The port's plain ``flash_attention_ref`` is held against the JAX Pallas
kernel in interpret mode, on the same numpy inputs: within 2e-5 in f32
(online vs one-pass softmax, summation order) and 2e-2 in bf16 (one
rounding of the output; inputs identical). Sequence lengths include
ones that are not a multiple of the block. The CUDA kernel is held
against the plain version on the card by ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(b, s, h, kvh, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,blocks", [
    ((1, 64, 4, 2, 16), (32, 32)),     # GQA, S a multiple of the block
    ((2, 20, 4, 4, 16), (8, 16)),      # MHA, S = 20 not a multiple of 8/16
    ((1, 24, 8, 2, 32), (16, 16)),     # GQA, 8 heads over 2, S = 24
], ids=str)
def test_plain_flash_matches_pallas_interpret(shape, blocks, causal, dtype):
    b, s, h, kvh, hd = shape
    q, k, v = _qkv(b, s, h, kvh, hd)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want = np.asarray(jfa.flash_attention(
        jq, jk, jv, causal=causal, blocks=blocks,
        interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(getattr(torch, dtype)) for a in (jq, jk, jv))
    got = tfa.flash_attention_ref(tq, tk, tv, causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL[dtype])
    assert torch.equal(ops.flash_attention(tq, tk, tv, causal), got)


def test_plain_flash_matches_layers_attention_f32():
    """In f32 the flash plain version and the chunked plain attention
    compute the same function (no bf16 probabilities to round)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 32, 4, 2, 16, seed=1))
    for causal in (True, False):
        torch.testing.assert_close(
            tfa.flash_attention_ref(q, k, v, causal),
            L.attention(q, k, v, causal=causal), rtol=0, atol=TOL["float32"])


def test_cuda_launcher_rejects_cpu_tensors():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, q, q)

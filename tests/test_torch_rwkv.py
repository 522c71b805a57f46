"""Port parity: RWKV-6 (rwkv6-7b, the ``ssm`` family) against the JAX
package, on the reduced f32 config from the JAX init.

  * forward logits within 1e-5 of max|logit|; the fused perturbed loss
    at +-eps within 1e-5, and over an int8 base with deltas;
  * token by token, ``decode_step`` from a zero cache gives the forward's
    logits (the WKV cell and the full-sequence scan are one recurrence),
    and a slot the write mask masks keeps its state;
  * the train CLI's losses within 1e-5, gs within 1e-3, its replay log
    replayed across packages at atol 0;
  * greedy tokens equal to the JAX engine's, dense and under
    ``paged=True`` (no pageable state: the dense layout); ``spec_k`` and
    ``prefill_chunk`` raise the JAX engine's errors;
  * the user-axis (multi-tenant) forward: each lane equals a lone fused
    loss at atol 0, and a batch without the lane axis raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_families import (ATOL, CPU, EPS, assert_cli_matches,  # noqa: E402
                             assert_forward_matches, assert_serving_matches,
                             assert_user_axis_lanes,
                             batch, case, cli_runs, fused_losses, to_torch)
from repro.serve import AdapterStore as JAdapterStore  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.serve import AdapterStore, ServeEngine  # noqa: E402

torch.set_num_threads(1)

ARCH = "rwkv6-7b"


def test_forward_logits_match_jax():
    assert_forward_matches(ARCH)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("coeff", [EPS, -EPS])
def test_fused_loss_matches_jax(coeff, quant):
    got, want = fused_losses(ARCH, coeff, quant)
    assert abs(got - want) <= ATOL, (got, want)


def test_decode_steps_give_the_forward_and_honour_the_mask():
    _, _, model, params = case(ARCH)
    b = to_torch(batch(model.cfg))
    tokens = b["tokens"].long()
    want, _ = model.forward(params, {"tokens": tokens})
    cache = model.init_cache(2, 16, device=CPU)
    for t in range(tokens.shape[1]):
        lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1], t)
        np.testing.assert_allclose(lg[:, 0].numpy(), want[:, t].numpy(),
                                   rtol=0, atol=ATOL)
    state = cache["blocks"]["tm"]["state"].clone()
    mask = torch.tensor([True, False])
    model.decode_step(params, cache, tokens[:, :1], 8, write_mask=mask)
    new = cache["blocks"]["tm"]["state"]
    assert torch.equal(new[:, 1], state[:, 1])
    assert not torch.equal(new[:, 0], state[:, 0])


def test_cli_losses_gs_and_replay_match_jax(tmp_path):
    assert_cli_matches(cli_runs(ARCH, tmp_path))


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_serving_tokens_match_jax(mode):
    eng = assert_serving_matches(ARCH, mode)
    assert not eng.paged            # nothing to page: the dense layout


@pytest.mark.parametrize("kw,match", [
    ({"spec_k": 3}, "speculative decoding needs a paged KV cache"),
    ({"prefill_chunk": 4}, "chunked prefill needs a paged KV cache")])
def test_paged_only_options_raise_as_jax(kw, match):
    jmodel, jparams, model, params = case(ARCH)
    with pytest.raises(ValueError, match=match):
        JServeEngine(jmodel.cfg, JAdapterStore(jparams), n_slots=2,
                     max_len=16, paged=True, **kw)
    with pytest.raises(ValueError, match=match):
        ServeEngine(model.cfg, AdapterStore(params, device=CPU), n_slots=2,
                    max_len=16, paged=True, device=CPU, **kw)


def test_user_axis_forward_raises():
    """The multi-tenant forward: each lane equal to a lone fused loss at
    atol 0; what it raises for is a batch without the lane axis."""
    assert_user_axis_lanes(ARCH)

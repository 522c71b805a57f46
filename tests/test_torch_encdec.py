"""Port parity: the encoder-decoder (whisper-base) against the JAX
package, on the reduced f32 config from the JAX init.

  * forward logits with ``enc_embeds`` (the audio frontend stub) within
    1e-5 of max|logit|, and different without the encoder's frames;
  * the fused perturbed loss at +-eps within 1e-5;
  * the train CLI feeds the JAX CLI's stub, array for array; its losses
    are within 1e-5, gs within 1e-3, its replay log replays across
    packages at atol 0;
  * a prefill reading cross K/V filled by ``cross_kv`` from the encoder
    output gives the forward's last logits (the read-only state path);
  * greedy tokens of token-only requests equal to the JAX engine's in the
    dense, paged, chunked and speculative modes, the cross state left at
    zeros;
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
from repro.launch import train as j_train_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.blocks.cross_attention import cross_kv  # noqa: E402
from repro_torch.models.runtime import _stack_apply, nest  # noqa: E402
from repro_torch.models.blocks import RunCtx  # noqa: E402

torch.set_num_threads(1)

ARCH = "whisper-base"


def test_forward_logits_match_jax_and_read_the_encoder():
    got = assert_forward_matches(ARCH)
    _, _, model, params = case(ARCH)
    b = to_torch(batch(model.cfg))
    b["enc_embeds"] = torch.zeros_like(b["enc_embeds"])
    other, _ = model.forward(params, b)
    assert float((got - other).abs().max()) > 1e-3


@pytest.mark.parametrize("coeff", [EPS, -EPS])
def test_fused_loss_matches_jax(coeff):
    got, want = fused_losses(ARCH, coeff)
    assert abs(got - want) <= ATOL, (got, want)


def test_cli_feeds_the_enc_stub():
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "8"]
    tr = train_cli.make_trainer(train_cli.build_argparser().parse_args(
        argv + ["--device", CPU]))
    jtr = j_train_cli.make_trainer(j_train_cli.build_argparser().parse_args(
        argv))
    for _, tb, jb in zip(range(2), tr.batches, jtr.batches):
        assert set(tb) == set(jb) and "enc_embeds" in tb
        for k in jb:
            np.testing.assert_array_equal(tb[k], np.asarray(jb[k]))


def test_cli_losses_gs_and_replay_match_jax(tmp_path):
    assert_cli_matches(cli_runs(ARCH, tmp_path))


def test_prefill_over_filled_cross_state_gives_the_forward():
    _, _, model, params = case(ARCH)
    cfg = model.cfg
    b = to_torch(batch(cfg))
    want, _ = model.forward(params, b)
    plan = model.plan
    erc = RunCtx(positions=torch.arange(cfg.enc_len)[None])
    e, _ = _stack_apply(cfg, plan.encoder, params, b["enc_embeds"], erc)
    enc_out = L.norm_apply(cfg, nest(params, "ln_enc"), e)
    cache = model.init_cache(2, 16, device=CPU)
    dec = nest(params, "dec_blocks")
    cross = cache["dec_blocks"]["cross"]
    for li in range(cfg.dec_layers):
        p = {k: {n: t[li] for n, t in v.items()}
             for k, v in dec["cross"].items()}
        cross["xk"][li], cross["xv"][li] = cross_kv(cfg, p, enc_out)
    got, _ = model.prefill(params, cache, b["tokens"].long())
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, -1].numpy(),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["dense", "paged", "chunked", "spec"])
def test_serving_tokens_match_jax(mode):
    eng = assert_serving_matches(ARCH, mode)
    cross = eng.cache["dec_blocks"]["cross"]
    assert not cross["xk"].any() and not cross["xv"].any()


def test_user_axis_forward_raises():
    """The multi-tenant forward: each lane equal to a lone fused loss at
    atol 0; what it raises for is a batch without the lane axis."""
    assert_user_axis_lanes(ARCH)

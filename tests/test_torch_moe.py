"""Port parity: the MoE family (granite-moe-1b-a400m, kimi-k2-1t-a32b with
its shared expert) against the JAX package, on reduced f32 configs from
the JAX init.

  * forward logits within 1e-5 of max|logit|, the Switch aux within 1e-5;
  * the fused perturbed loss at +-eps within 1e-5 (the expert sub-dict
    through ``ctx.materialize``), and over an int8 base with deltas;
  * ``moe_apply`` against the reference's with and without capacity
    drops: a token whose every assignment is dropped gets exactly the
    shared expert's output (zero without one), so the residual carries
    it; two calls are bit-equal;
  * the train CLI's losses within 1e-5, gs within 1e-3, its replay log
    replayed across packages at atol 0;
  * greedy tokens equal to the JAX engine's in the dense, paged and
    chunked modes;
  * the user-axis (multi-tenant) forward: each lane equals a lone fused
    loss at atol 0, and a batch without the lane axis raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_families import (ATOL, EPS, assert_cli_matches,  # noqa: E402
                             assert_forward_matches, assert_serving_matches,
                             assert_user_axis_lanes, case, cli_runs,
                             fused_losses)
from repro.models import moe as j_moe  # noqa: E402
from repro_torch.models import moe  # noqa: E402

torch.set_num_threads(1)

ARCHS = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_jax(arch):
    assert_forward_matches(arch)


@pytest.mark.parametrize("coeff", [EPS, -EPS])
@pytest.mark.parametrize("arch", ARCHS)
def test_fused_loss_matches_jax(arch, coeff):
    got, want = fused_losses(arch, coeff)
    assert abs(got - want) <= ATOL, (got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_fused_loss_matches_jax(arch):
    got, want = fused_losses(arch, EPS, quant=True)
    assert abs(got - want) <= ATOL, (got, want)


def _moe_inputs(arch, capacity_factor, tokens=(3, 16)):
    """The layer-0 expert sub-dict (plain tensors) of reduced ``arch`` at
    ``capacity_factor`` and an input x: (JAX cfg, port cfg, JAX p, port p,
    numpy x)."""
    jmodel, jparams, model, params = case(arch)
    jcfg = dataclasses.replace(jmodel.cfg, capacity_factor=capacity_factor)
    cfg = dataclasses.replace(model.cfg, capacity_factor=capacity_factor)
    head = "blocks/moe/"
    tp = {}
    for k, v in params.items():
        if k.startswith(head):
            d = tp
            parts = k[len(head):].split("/")
            for part in parts[:-1]:
                d = d.setdefault(part, {})
            d[parts[-1]] = v[0]
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"])
    x = np.random.default_rng(5).standard_normal(
        tokens + (cfg.d_model,), dtype=np.float32)
    return jcfg, cfg, jp, tp, x


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [8.0, 0.25])
def test_moe_apply_with_and_without_drops(arch, capacity_factor):
    jcfg, cfg, jp, tp, x = _moe_inputs(arch, capacity_factor)
    want, want_aux = j_moe.moe_apply(jcfg, jp, jnp.asarray(x))
    xt = torch.from_numpy(x)
    got, aux = moe.moe_apply(cfg, tp, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert abs(float(aux) - float(want_aux)) <= ATOL
    again, _ = moe.moe_apply(cfg, tp, xt)
    assert torch.equal(got, again)                  # deterministic
    # which assignments the capacity drops, recomputed from the router
    tt = x.shape[0] * x.shape[1]
    probs = torch.softmax(xt.reshape(tt, -1) @ tp["router"], dim=-1)
    idx = torch.topk(probs, cfg.topk, dim=-1).indices.reshape(-1)
    order = torch.argsort(idx, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(idx.numel())
    first = torch.searchsorted(idx[order], idx)
    kept = (rank - first < moe.capacity(tt, cfg)).reshape(tt, cfg.topk)
    dropped = ~kept.any(1)
    if capacity_factor > 1:
        assert bool(kept.all())
        return
    assert int(dropped.sum()) > 0
    rest = torch.zeros_like(xt) if not cfg.n_shared_experts else \
        moe.L.mlp_apply(cfg, tp["shared"], xt)
    flat_got, flat_rest = got.reshape(tt, -1), rest.reshape(tt, -1)
    assert torch.equal(flat_got[dropped], flat_rest[dropped])


def test_cli_losses_gs_and_replay_match_jax(tmp_path):
    assert_cli_matches(cli_runs("granite-moe-1b-a400m", tmp_path))


@pytest.mark.parametrize("mode", ["dense", "paged", "chunked"])
def test_serving_tokens_match_jax(mode):
    assert_serving_matches("granite-moe-1b-a400m", mode)


def test_user_axis_forward_raises():
    """The multi-tenant forward: each lane equal to a lone fused loss at
    atol 0; what it raises for is a batch without the lane axis."""
    assert_user_axis_lanes("granite-moe-1b-a400m")

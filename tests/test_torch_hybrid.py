"""Port parity: the mamba / attention hybrid (jamba-v0.1-52b: mamba
sublayers, one attention sublayer, MoE FFNs on odd sublayers) against the
JAX package, on the reduced f32 config from the JAX init.

  * forward logits within 1e-5 of max|logit|, the aux within 1e-5; the
    fused perturbed loss at +-eps within 1e-5;
  * the train CLI's losses within 1e-5, gs within 1e-3, its replay log
    replayed across packages at atol 0;
  * greedy tokens equal to the JAX engine's in the dense, paged, chunked
    and speculative modes;
  * a verify window leaves the recurrent state as it was and returns one
    snapshot a window offset, equal to JAX's and to sequential decode
    steps' states; ``commit_window`` installs each masked-in slot's
    accepted offset and leaves the others;
  * a speculative round's draft leaves the recurrent lanes as they were;
  * chunked admission starts a recycled slot's recurrent lane from zero,
    as whole-prompt admission's fresh lane does (the JAX engine's
    chunked admission continues the lane from whatever the slot's last
    request, or decode steps over the idle slot, left there);
  * the user-axis (multi-tenant) forward: each lane equals a lone fused
    loss at atol 0, and a batch without the lane axis raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_families import (ATOL, CPU, EPS, assert_cli_matches,  # noqa: E402
                             assert_forward_matches, assert_serving_matches,
                             assert_user_axis_lanes,
                             case, cli_runs, flat, fused_losses, serve)
from repro_torch.models import runtime as RT  # noqa: E402

torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"


def test_forward_logits_and_aux_match_jax():
    assert_forward_matches(ARCH)


@pytest.mark.parametrize("coeff", [EPS, -EPS])
def test_fused_loss_matches_jax(coeff):
    got, want = fused_losses(ARCH, coeff)
    assert abs(got - want) <= ATOL, (got, want)


def test_cli_losses_gs_and_replay_match_jax(tmp_path):
    assert_cli_matches(cli_runs(ARCH, tmp_path))


@pytest.mark.parametrize("mode", ["dense", "paged", "chunked", "spec"])
def test_serving_tokens_match_jax(mode):
    assert_serving_matches(ARCH, mode)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _prefilled():
    """Two slots' prompts (5 and 3 tokens) chunk-prefilled into paged
    caches of both packages: (JAX model, params, cache, port model,
    params, cache, pages, pos)."""
    jmodel, jparams, model, params = case(ARCH)
    rng = np.random.default_rng(0)
    pages = np.asarray([[3, 7, 1], [2, 5, 4]], np.int32)
    plens = (5, 3)
    jcache = jmodel.init_paged_cache(2, 8, 4)
    cache = model.init_paged_cache(2, 8, 4, device=CPU)
    for b, plen in enumerate(plens):
        prompt = rng.integers(0, model.cfg.vocab, (1, plen), dtype=np.int32)
        _, jsub = jmodel.prefill_chunk(
            jparams, _lane_j(jcache, b), jnp.asarray(prompt),
            jnp.zeros((1,), jnp.int32), pages=jnp.asarray(pages[b:b + 1]))
        jcache = _put_j(jcache, jsub, b)
        lane = {"blocks": _narrow(cache["blocks"], b)}
        model.prefill_chunk(params, lane, torch.from_numpy(prompt).long(),
                            0, pages=torch.from_numpy(pages[b:b + 1]))
    return (jmodel, jparams, jcache, model, params, cache, pages,
            np.asarray(plens, np.int32))


def _narrow(d, b):
    return {k: _narrow(v, b) if isinstance(v, dict) else
            v if k.endswith("_pages") else v[:, b:b + 1] for k, v in d.items()}


def _lane_j(cache, b):
    def take(path, c):
        if str(path[-1].key).endswith("_pages"):
            return c
        return c[:, b:b + 1]
    return jax.tree_util.tree_map_with_path(take, cache)


def _put_j(cache, sub, b):
    def put(path, c, n):
        if str(path[-1].key).endswith("_pages"):
            return n
        return c.at[:, b:b + 1].set(n)
    return jax.tree_util.tree_map_with_path(put, cache, sub)


def test_verify_window_snapshots_and_commit():
    (jmodel, jparams, jcache, model, params, cache, pages,
     pos) = _prefilled()
    rng = np.random.default_rng(1)
    w = 4
    win = rng.integers(0, model.cfg.vocab, (2, w), dtype=np.int32)
    wmask = np.ones((2, w), bool)
    before = _clone(cache)
    want, jv = jmodel.verify_window(
        jparams, jcache, jnp.asarray(win), jnp.asarray(pos),
        pages=jnp.asarray(pages), write_mask=jnp.asarray(wmask))
    lg, vcache = model.verify_window(
        params, cache, torch.from_numpy(win).long(), torch.from_numpy(pos),
        pages=torch.from_numpy(pages), write_mask=torch.from_numpy(wmask))
    np.testing.assert_allclose(lg.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    rec = RT.recurrent_leaves(model.plan, cache)
    assert rec and all(torch.equal(a, b) for a, b in zip(
        rec, RT.recurrent_leaves(model.plan, before)))
    jflat, tflat = flat(jv), flat(_to_np(vcache))
    snaps = [p for p in tflat if p.rsplit("/", 1)[-1] in ("conv", "ssm")]
    assert snaps
    for p in snaps:
        assert tflat[p].shape[1] == w
        np.testing.assert_allclose(tflat[p], jflat[p], rtol=0, atol=ATOL,
                                   err_msg=p)
    # sequential decode steps reach offset i's snapshot after token i
    seq = _clone(before)
    for i in range(w):
        step_lg, seq = model.decode_step(
            params, seq, torch.from_numpy(win[:, i:i + 1]).long(),
            torch.from_numpy(pos + i), pages=torch.from_numpy(pages))
        np.testing.assert_allclose(step_lg[:, 0].numpy(), lg[:, i].numpy(),
                                   rtol=0, atol=ATOL)
        for a, s in zip(RT.recurrent_leaves(model.plan, seq),
                        RT.recurrent_leaves(model.plan, vcache)):
            np.testing.assert_allclose(a.numpy(), s[:, i].numpy(), rtol=0,
                                       atol=ATOL)
    # commit: slot 0 takes offset 1, slot 1 is masked out
    acc, mask = torch.tensor([1, 3]), torch.tensor([True, False])
    RT.commit_window(model.plan, cache, vcache, acc, mask)
    for got, old, snap in zip(RT.recurrent_leaves(model.plan, cache),
                              RT.recurrent_leaves(model.plan, before),
                              RT.recurrent_leaves(model.plan, vcache)):
        assert torch.equal(got[:, 0], snap[:, 1, 0])
        assert torch.equal(got[:, 1], old[:, 1])


def _to_np(tree):
    return {k: _to_np(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def test_draft_leaves_the_recurrent_state():
    """Between a round's page-table growth (just before the draft) and
    its first verify, the recurrent lanes are bit-unchanged, though the
    draft's decode steps advanced them."""
    seen, checked = [], []

    def hook(eng):
        live_pages, verify = eng._live_pages, eng.model.verify_window

        def snap(cover):
            seen.append([t.clone() for t in RT.recurrent_leaves(
                eng.model.plan, eng.cache)])
            return live_pages(cover)

        def check(params, cache, *a, **kw):
            if len(checked) < len(seen):        # the round's first verify
                now = RT.recurrent_leaves(eng.model.plan, cache)
                checked.append(all(torch.equal(x, y)
                                   for x, y in zip(seen[-1], now)))
            return verify(params, cache, *a, **kw)
        eng._live_pages = snap
        eng.model = dataclasses.replace(eng.model, verify_window=check)
    _, eng = serve(ARCH, False, "spec", hook=hook)
    assert eng.stats.spec_drafted > 0
    assert len(checked) == len(seen) > 0 and all(checked)


def _admitted_lanes(jax_side, mode):
    """Greedy tokens, and each request's recurrent lanes as its admission
    hands the slot to decode, in submission order."""
    lanes = {}

    def hook(eng):
        activate = eng._activate

        def record(slot, req, *a):
            if jax_side:
                leaves = [np.asarray(v)[:, slot] for p, v in sorted(
                    flat(eng.cache).items()) if p.rsplit("/", 1)[-1]
                    in ("conv", "ssm")]
            else:
                leaves = [t[:, slot].numpy().copy() for t in
                          RT.recurrent_leaves(eng.model.plan, eng.cache)]
            lanes[req.rid] = leaves
            return activate(slot, req, *a)
        eng._activate = record
    toks, _ = serve(ARCH, jax_side, mode, hook=hook)
    return toks, [lanes[r] for r in sorted(lanes)]


def _lane_gap(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def test_chunked_admission_starts_a_recycled_lane_from_zero():
    """4 requests on 2 slots: after the first admission every slot's lane
    holds state that a finished request, or decode steps run over the
    idle slot, left there. The port's lanes at admission equal
    whole-prompt admission's for every request, and so do its tokens;
    the JAX engine's equal its own whole-prompt lanes only for the first
    admission, since its chunked prefill continues the lane."""
    toks, lanes = _admitted_lanes(False, "chunked")
    want_toks, want = _admitted_lanes(False, "paged")
    assert toks == want_toks
    assert len(lanes) == len(want) == 4 and lanes[0]
    for got, ref in zip(lanes, want):
        assert _lane_gap(got, ref) <= ATOL
    _, jlanes = _admitted_lanes(True, "chunked")
    _, jwant = _admitted_lanes(True, "paged")
    gaps = [_lane_gap(a, b) for a, b in zip(jlanes, jwant)]
    assert gaps[0] <= ATOL and min(gaps[1:]) > 10 * ATOL, gaps


def test_user_axis_forward_raises():
    """The multi-tenant forward: each lane equal to a lone fused loss at
    atol 0; what it raises for is a batch without the lane axis."""
    assert_user_axis_lanes(ARCH)

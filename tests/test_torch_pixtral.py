"""Port parity: pixtral-12b's patch prefix (the vlm frontend stub).

The JAX forward prepends ``batch["patch_embeds"]`` (cast to the
activation dtype) before the token embeddings, lets positions run over
the whole sequence, and cuts the prefix off before the LM head; its train
CLI feeds a numpy stub of standard normal patches for a ``num_patches``
config. On reduced pixtral-12b from the JAX package's initial parameters:

  * the port's forward logits with ``patch_embeds`` are within 1e-5 of
    JAX's, and differ from the logits without them;
  * the fused perturbed loss with ``patch_embeds`` is within 1e-5 of
    JAX's at +-eps, and every lane of the user-axis form (patches
    (n, B, P, d)) equals the scalar fused loss at atol 0;
  * ``repro_torch.launch.train --arch pixtral-12b --reduced`` first
    losses are within 1e-5 of ``repro.launch.train``'s.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.perturb import _path_str  # noqa: E402
from repro.core.perturb_ctx import PerturbCtx as JPerturbCtx  # noqa: E402
from repro.data.synthetic import lm_batches as j_lm_batches  # noqa: E402
from repro.launch import train as j_train_cli  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import PerturbCtx  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5            # the dense configs' logits and loss tolerance
SEED, EPS = 9, np.float32(1e-3)
CLI = ["--arch", "pixtral-12b", "--reduced", "--optimizer", "mezo-fused",
       "--steps", "3", "--batch", "2", "--seq", "8", "--lr", "1e-3",
       "--log-every", "1"]


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(v) for p, v in leaves}


@functools.lru_cache(maxsize=None)
def _case():
    """(JAX model, JAX params, port model, port params, numpy batch with
    patches) on reduced pixtral-12b, the JAX package's init."""
    jcfg = j_get_config("pixtral-12b").reduced()
    cfg = get_config("pixtral-12b").reduced()
    assert cfg.num_patches == jcfg.num_patches > 0
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = store.params_from_numpy(_flat(jparams), "cpu")
    batch = dict(next(j_lm_batches(2, 8, jcfg.vocab, seed=1)))
    batch["patch_embeds"] = np.random.default_rng(3).standard_normal(
        (2, cfg.num_patches, cfg.d_model), dtype=np.float32)
    return jmodel, jparams, build_model(cfg), tparams, batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_forward_logits_with_patches_match_jax():
    jmodel, jparams, tmodel, tparams, batch = _case()
    want, _ = jmodel.forward(jparams, _j(batch))
    got, _ = tmodel.forward(tparams, _t(batch))
    assert tuple(got.shape) == want.shape == (2, 8, tmodel.cfg.vocab)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                                np.float32),
                               rtol=0, atol=ATOL)


def test_patches_change_the_logits():
    """The prefix reaches the tokens through attention: dropping it (the
    fault this repairs) changes every position's logits."""
    _, _, tmodel, tparams, batch = _case()
    with_p, _ = tmodel.forward(tparams, _t(batch))
    plain = {k: v for k, v in batch.items() if k != "patch_embeds"}
    without, _ = tmodel.forward(tparams, _t(plain))
    assert with_p.shape == without.shape
    gap = (with_p - without).abs().amax(dim=-1)
    assert bool((gap > 1e-3).all()), gap


@pytest.mark.parametrize("coeff", [EPS, -EPS])
def test_fused_loss_with_patches_matches_jax(coeff):
    jmodel, jparams, tmodel, tparams, batch = _case()
    ctx = JPerturbCtx(seed=np.uint32(SEED), coeff=coeff)
    want = float(jax.jit(lambda p, b: jmodel.loss(p, b, perturb=ctx))(
        jparams, _j(batch)))
    got = float(tmodel.loss(tparams, _t(batch),
                            perturb=PerturbCtx(seed=SEED, coeff=coeff)))
    assert abs(got - want) <= ATOL, (got, want)


def test_user_axis_fused_loss_with_patches_equals_scalar():
    """Patches (n, B, P, d) ride the user axis as tokens do: each lane's
    loss equals the scalar fused loss with that lane's (seed, coeff)."""
    _, _, tmodel, tparams, batch = _case()
    seeds, coeffs = (11, 503, 9), np.array([1e-3, -1e-3, 2e-3], np.float32)
    tb = _t(batch)
    lanes = {k: v[None].expand(len(seeds), *v.shape) for k, v in tb.items()}
    shared = {k: v[None] for k, v in tparams.items()}
    got = tmodel.loss(shared, lanes, perturb=PerturbCtx(seed=seeds,
                                                        coeff=coeffs))
    assert got.shape == (len(seeds),)
    for i, (s, c) in enumerate(zip(seeds, coeffs)):
        want = tmodel.loss(tparams, tb, perturb=PerturbCtx(seed=s, coeff=c))
        assert got[i].item() == want.item(), i


def test_cli_losses_match_jax():
    jargs = j_train_cli.build_argparser().parse_args(CLI)
    jtr = j_train_cli.make_trainer(jargs)
    jinit = jtr.init_params()
    init = _flat(jinit)
    jtr.train(jinit)
    ttr = train_cli.run(CLI + ["--device", "cpu"],
                        params=store.params_from_numpy(init, "cpu"))
    assert len(ttr.losses) == 3
    np.testing.assert_allclose(ttr.losses, jtr.losses, rtol=0, atol=ATOL)


def test_cli_feeds_the_patch_stub():
    """The port's CLI batches carry the JAX CLI's stub, array for array."""
    args = train_cli.build_argparser().parse_args(CLI + ["--device", "cpu"])
    tr = train_cli.make_trainer(args)
    jtr = j_train_cli.make_trainer(j_train_cli.build_argparser().parse_args(
        CLI))
    for _, tb, jb in zip(range(2), tr.batches, jtr.batches):
        assert set(tb) == set(jb) and "patch_embeds" in tb
        for k in jb:
            np.testing.assert_array_equal(tb[k], np.asarray(jb[k]))

"""Port parity: ``PerturbCtx`` and the fused perturbed forward.

Against the JAX package, on the same numpy inputs and the same (JAX
initialised) parameters: ``perturb``, ``take`` and ``materialize`` bit
for bit with Rademacher z; ``matmul`` within 1e-6 (f32 summation order);
the fused loss of reduced OPT-1.3B and reduced RoBERTa-large within 1e-5,
with ``attn_impl`` chunked and flash. Inside the port: the fused loss
equals the materialized loss (``add_scaled_z`` then the plain forward)
to rtol 1e-6, as the JAX package's ``tests/test_fused.py`` holds it.
"""

import dataclasses
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
from repro.data.synthetic import sst2_batches as j_sst2_batches  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import PerturbCtx, add_scaled_z  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

torch.set_num_threads(1)

MATMUL_ATOL = 1e-6
LOSS_ATOL = 1e-5
INPORT_RTOL = 1e-6
SEED, EPS = 9, np.float32(1e-3)


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(v) for p, v in leaves}


@functools.lru_cache(maxsize=None)
def _case(arch, attn_impl="chunked"):
    """(JAX model, JAX params, port model, port params, JAX batch, port
    batch) on the reduced config, the JAX package's init."""
    jcfg = dataclasses.replace(j_get_config(arch).reduced(),
                               attn_impl=attn_impl)
    tcfg = dataclasses.replace(get_config(arch).reduced(),
                               attn_impl=attn_impl)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = store.params_from_numpy(_flat(jparams), "cpu")
    gen = j_sst2_batches if jcfg.n_classes else j_lm_batches
    batch = next(gen(2, 16, jcfg.vocab, seed=1))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return jmodel, jparams, build_model(tcfg), tparams, jbatch, tbatch


def _w(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_perturb_take_materialize_bit_exact():
    jctx = JPerturbCtx(seed=np.uint32(SEED), coeff=EPS)
    tctx = PerturbCtx(seed=SEED, coeff=EPS)
    # a stacked layer's bias under a scope, and a root leaf
    b = _w((24,), 1)
    want = jctx.scope("blocks").at_layer(3).scope("attn/wq").perturb(
        "b", jnp.asarray(b))
    got = tctx.scope("blocks").at_layer(3).scope("attn/wq").perturb(
        "b", torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    s = _w((16,), 2)
    np.testing.assert_array_equal(
        tctx.scope("ln_f").perturb("scale", torch.from_numpy(s)).numpy(),
        np.asarray(jctx.scope("ln_f").perturb("scale", jnp.asarray(s))))
    # take: gathered rows only
    table = _w((40, 12), 3)
    ids = np.array([[0, 39, 7], [5, 5, 11]], np.int32)
    np.testing.assert_array_equal(
        tctx.scope("embed").take("tok", torch.from_numpy(table),
                                 torch.from_numpy(ids)).numpy(),
        np.asarray(jctx.scope("embed").take("tok", jnp.asarray(table),
                                            jnp.asarray(ids))))
    # materialize of a whole (stacked) tree == add_scaled_z
    _, jparams, _, tparams, _, _ = _case("opt-1.3b")
    want = _flat(jax.jit(jctx.materialize)(jparams))
    got = tctx.materialize(tparams)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    plain = add_scaled_z(tparams, SEED, EPS)
    for k in want:
        np.testing.assert_array_equal(plain[k].numpy(), want[k], err_msg=k)


def test_matmul_stacked_layer_within_tolerance():
    x, w = _w((10, 32), 4), _w((32, 48), 5) * 0.1
    jctx = JPerturbCtx(seed=np.uint32(SEED), coeff=-EPS).scope(
        "blocks").at_layer(1).scope("mlp/w_in")
    tctx = PerturbCtx(seed=SEED, coeff=-EPS).scope("blocks").at_layer(
        1).scope("mlp/w_in")
    want = np.asarray(jctx.matmul(jnp.asarray(x)[None], jnp.asarray(w)))
    got = tctx.matmul(torch.from_numpy(x)[None], torch.from_numpy(w))
    assert got.shape == (1, 10, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MATMUL_ATOL)


@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
@pytest.mark.parametrize("arch", ["opt-1.3b", "roberta-large"])
def test_fused_loss_matches_jax(arch, attn_impl):
    jmodel, jparams, tmodel, tparams, jbatch, tbatch = _case(arch, attn_impl)
    for coeff in (EPS, -EPS):
        ctx = JPerturbCtx(seed=np.uint32(SEED), coeff=coeff)
        want = float(jax.jit(lambda p, b: jmodel.loss(p, b, perturb=ctx))(
            jparams, jbatch))
        got = float(tmodel.loss(tparams, tbatch,
                                perturb=PerturbCtx(seed=SEED, coeff=coeff)))
        assert abs(got - want) <= LOSS_ATOL, (coeff, got, want)
    np.testing.assert_allclose(float(tmodel.loss(tparams, tbatch)),
                               float(jax.jit(jmodel.loss)(jparams, jbatch)),
                               rtol=0, atol=LOSS_ATOL)


@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
@pytest.mark.parametrize("arch", ["opt-1.3b", "roberta-large"])
def test_fused_loss_equals_materialized_in_port(arch, attn_impl):
    _, _, tmodel, tparams, _, tbatch = _case(arch, attn_impl)
    fused = float(tmodel.loss(tparams, tbatch,
                              perturb=PerturbCtx(seed=SEED, coeff=EPS)))
    mat = float(tmodel.loss(add_scaled_z(tparams, SEED, EPS), tbatch))
    np.testing.assert_allclose(fused, mat, rtol=INPORT_RTOL, atol=0)

"""Port parity: ``PerturbCtx`` and the fused perturbed forward.

Against the JAX package, on the same numpy inputs and the same (JAX
initialised) parameters: ``perturb``, ``take`` and ``materialize`` bit
for bit with Rademacher z; ``matmul`` within 1e-6 (f32 summation order);
the fused loss of reduced OPT-1.3B and reduced RoBERTa-large within 1e-5,
with ``attn_impl`` chunked and flash. Inside the port: the fused loss
equals the materialized loss (``add_scaled_z`` then the plain forward)
to rtol 1e-6, as the JAX package's ``tests/test_fused.py`` holds it.

User-axis mode (a sequence of lane seeds): ``perturb`` and ``take`` bit
for bit JAX's user-axis ctx, ``matmul`` within 1e-6 (shared, per-lane
and frozen int8 W), and every lane -- of each primitive and of the
whole fused loss over a shared base -- bit for bit the port's scalar
ctx with that lane's (seed, coeff).
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
from repro.optim import quant as jq  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import PerturbCtx, add_scaled_z  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import quant as tquant  # noqa: E402

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


# ---------------------------------------------------------------------------
# user-axis mode: a sequence of lane seeds (the multi-tenant step)

U_SEEDS = (11, 503, 9, 77)
U_COEFFS = np.array([1e-3, -1e-3, 2e-3, -5e-4], np.float32)


def _jctx_users():
    return JPerturbCtx(seed=np.array(U_SEEDS, np.uint32),
                       coeff=jnp.asarray(U_COEFFS))


def _tctx_users():
    return PerturbCtx(seed=U_SEEDS, coeff=U_COEFFS)


def _one_lane(params):
    """A base every lane shares, as a user-stacked tree of one lane
    (views): plain leaves gain a lane axis of 1, a frozen int8 leaf has
    none."""
    return {k: v if tquant.is_quantized(v) else v[None]
            for k, v in params.items()}


def _lane_ctxs(scope):
    users = _tctx_users()
    return [scope(users._lane(s, c)) for s, c in zip(U_SEEDS, U_COEFFS)]


def _scope(c):
    return c.scope("blocks").at_layer(1).scope("attn/wq")


def test_user_axis_perturb_and_take_match_jax_and_scalar_lanes():
    """perturb of a stacked small leaf and take from a stacked table:
    bit for bit JAX's user-axis ctx and each lane's scalar ctx."""
    u = len(U_SEEDS)
    b = _w((u, 24), 1)
    want = np.asarray(_scope(_jctx_users()).perturb("b", jnp.asarray(b)))
    got = _scope(_tctx_users()).perturb("b", torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)
    for i, lane in enumerate(_lane_ctxs(_scope)):
        assert torch.equal(got[i], lane.perturb("b", torch.from_numpy(b[i])))
    table = _w((u, 40, 12), 3)
    ids = np.random.default_rng(0).integers(0, 40, (u, 2, 5)).astype(
        np.int32)
    want = np.asarray(_jctx_users().scope("embed").take(
        "tok", jnp.asarray(table), jnp.asarray(ids)))
    got = _tctx_users().scope("embed").take(
        "tok", torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(u):
        lane = PerturbCtx(seed=U_SEEDS[i], coeff=U_COEFFS[i]).scope("embed")
        assert torch.equal(got[i], lane.take(
            "tok", torch.from_numpy(table[i]), torch.from_numpy(ids[i])))


@pytest.mark.parametrize("weight", ["shared", "stacked", "int8"])
def test_user_axis_matmul_matches_jax_and_scalar_lanes(weight):
    """matmul over a shared base (the reference kernel), a stacked
    per-lane W and a frozen shared int8 base: within 1e-6 of JAX's
    user-axis ctx, each lane bit for bit the scalar ctx."""
    u, bsz, k, n = len(U_SEEDS), 6, 128, 128
    x = _w((u, bsz, k), 4)
    if weight == "stacked":
        w = _w((u, k, n), 5) * 0.1
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
        lane_w = [torch.from_numpy(w[i]) for i in range(u)]
    else:
        w = _w((k, n), 5) * 0.1
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
        if weight == "int8":
            jw = jq.quantize_leaf(jw)
            tw = tquant.quantize_leaf(tw)
        lane_w = [tw] * u
    want = np.asarray(_scope(_jctx_users()).matmul(jnp.asarray(x), jw))
    got = _scope(_tctx_users()).matmul(
        torch.from_numpy(x).reshape(u * bsz, k),
        tw[None] if weight == "shared" else tw)
    assert got.shape == (u * bsz, n)
    np.testing.assert_allclose(got.reshape(u, bsz, n).numpy(), want,
                               rtol=0, atol=MATMUL_ATOL)
    for i, lane in enumerate(_lane_ctxs(_scope)):
        assert torch.equal(got[i * bsz:(i + 1) * bsz],
                           lane.matmul(torch.from_numpy(x[i]), lane_w[i]))


@pytest.mark.parametrize("arch,base", [("opt-1.3b", "plain"),
                                       ("opt-1.3b", "int8"),
                                       ("roberta-large", "plain")])
def test_user_axis_fused_loss_over_shared_base_equals_scalar(arch, base):
    """The whole forward in user-axis mode over one shared base (the
    reduced OPT-1.3B as it is and as a frozen int8 base, the reduced
    RoBERTa-large classifier): each lane's loss equals the scalar fused
    loss at atol 0. The JAX package's user-axis forward cannot be the
    reference here: it fails at the learned positions (ROADMAP Queue
    3)."""
    _, _, tmodel, tparams, _, tbatch = _case(arch)
    params = tquant.quantize_tree(tparams) if base == "int8" else tparams
    u = len(U_SEEDS)
    both = {k: v[None].expand(u, *v.shape) for k, v in tbatch.items()}
    got = tmodel.loss(_one_lane(params), both, perturb=_tctx_users())
    assert got.shape == (u,)
    for i in range(u):
        want = tmodel.loss(params, tbatch, perturb=PerturbCtx(
            seed=U_SEEDS[i], coeff=U_COEFFS[i]))
        assert got[i].item() == want.item(), i

"""Port parity: the int8 quantized base (``repro_torch.optim.quant``), its
plain kernel versions and the frozen-base fused forward.

Against the JAX package, on the same numpy inputs (JAX's int8 kernels run
in interpret mode through ``repro.kernels.ops``, as ``tests/test_quant.py``
runs them):
  * ``quantize_tree`` q and scale at atol 0 (the reduced OPT-1.3B and
    RoBERTa-large inits, the trees of ``tests/test_quant.py``);
  * ``zo_add_q_ref`` vs ``ops.zo_add(scale=)``: Rademacher atol 0,
    Gaussian 1e-6;
  * ``zo_matmul_q_ref`` vs ``ops.zo_matmul(scale=)``: rtol 1e-5 and the
    scale-tied atol of ``tests/test_quant.py``;
  * ``PerturbCtx`` on quantized leaves (frozen and with a delta),
    ``int8_quantize``, ``take_rows``, ``quantized_bytes``;
  * the frozen-base fused loss within 1e-5, both signs; the plain forward
    over the int8 base within 1e-5.
Inside the port: the fused frozen-base loss equals the materialized one
(``ctx.materialize``, the ``zo_add_q`` path) at atol 0, both signs -- the
counterpart of ``test_quantized_fused_loss_bit_equals_materialize``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (repro.optim.quant needs it first)
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import rng as j_rng  # noqa: E402
from repro.core.perturb import _path_str  # noqa: E402
from repro.core.perturb_ctx import PerturbCtx as JPerturbCtx  # noqa: E402
from repro.data.synthetic import lm_batches as j_lm_batches  # noqa: E402
from repro.data.synthetic import sst2_batches as j_sst2_batches  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim import quant as jq  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import PerturbCtx  # noqa: E402
from repro_torch.kernels import ops, zo_perturb as zp  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402
from repro_torch.optim import quant  # noqa: E402

torch.set_num_threads(1)

GAUSS_ATOL = 1e-6
LOSS_ATOL = 1e-5
SEED, EPS = 9, np.float32(1e-3)
MM_SHAPES = [(8, 128, 128), (16, 96, 160), (7, 33, 130)]


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(v) for p, v in leaves}


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_leaf_equal(t_leaf, j_leaf, what=""):
    np.testing.assert_array_equal(t_leaf.q.numpy(), np.asarray(j_leaf.q),
                                  err_msg=what)
    np.testing.assert_array_equal(t_leaf.scale.numpy(),
                                  np.asarray(j_leaf.scale), err_msg=what)


def _tiny_tree(seed=1):
    """The tree of ``tests/test_quant.py`` (``/``-flat for the port)."""
    k = jax.random.PRNGKey(seed)
    ks = jax.random.split(k, 4)
    return {
        "a": {"w": jax.random.normal(ks[0], (16, 8), jnp.float32) * 0.1},
        "blocks": {"ln": jax.random.normal(ks[1], (2, 8), jnp.float32),
                   "w": jax.random.normal(ks[2], (2, 8, 16),
                                          jnp.float32) * 0.1},
        "b": jax.random.normal(ks[3], (8,), jnp.float32) * 0.1,
    }


@functools.lru_cache(maxsize=None)
def _case(arch):
    """(JAX model, JAX int8 params, port model, port int8 params, JAX
    batch, port batch): the JAX init quantized by the JAX package and
    carried across with ``store.params_from_numpy``."""
    jcfg = j_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    jmodel = j_build_model(jcfg)
    jparams = jq.quantize_tree(jmodel.init(jax.random.PRNGKey(0)))
    dtypes = {p: spec[1] for p, spec in param_shapes(tcfg).items()}
    tparams = store.params_from_numpy(_flat(jparams), "cpu", dtypes)
    gen = j_sst2_batches if jcfg.n_classes else j_lm_batches
    batch = next(gen(2, 16, jcfg.vocab, seed=1))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    return jmodel, jparams, build_model(tcfg), tparams, jbatch, tbatch


# ---------------------------------------------------------------------------
# quantization


@pytest.mark.parametrize("arch", ["opt-1.3b", "roberta-large"])
def test_quantize_tree_equals_jax_on_reduced_init(arch):
    jcfg = j_get_config(arch).reduced()
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    want = jq.quantize_tree(jparams)
    got = quant.quantize_tree(store.params_from_numpy(_flat(jparams), "cpu"))
    jleaves = {_path_str(p): leaf for p, leaf in
               jax.tree_util.tree_flatten_with_path(
                   want, is_leaf=jq.is_quantized)[0]}
    assert set(got) == set(jleaves)
    n = 0
    for path, leaf in got.items():
        assert quant.is_quantized(leaf) == jq.is_quantized(jleaves[path])
        if quant.is_quantized(leaf):
            _assert_leaf_equal(leaf, jleaves[path], path)
            assert leaf.delta is None and leaf.dtype == torch.float32
            n += 1
    assert n >= 9
    resident, f32_eq = quant.quantized_bytes(got)
    assert (resident, f32_eq) == jq.quantized_bytes(want)


def test_quantize_test_trees_equal_jax():
    tree = _tiny_tree()
    want = _flat(jq.quantize_tree(tree, with_delta=True))
    got = store.params_to_numpy(quant.quantize_tree(
        {k: _t(v) for k, v in _flat(tree).items()}, with_delta=True))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    key = jax.random.PRNGKey(0)
    zero_denormal = jax.random.normal(key, (32, 4), jnp.float32).at[
        :, 1].set(0.0).at[:, 2].set(1e-42)
    outlier = (jax.random.normal(key, (64, 4), jnp.float32) * 0.01).at[
        :, 3].mul(1e4)
    for w in (zero_denormal, outlier):
        _assert_leaf_equal(quant.quantize_leaf(_t(w)), jq.quantize_leaf(w))
    # default_quantizable: stacked vectors and routers stay full precision
    t = quant.quantize_tree({k: _t(v) for k, v in _flat(tree).items()})
    assert [k for k, v in t.items() if quant.is_quantized(v)] == \
        ["a/w", "blocks/w"]
    assert not quant.default_quantizable("blocks/moe/router",
                                         torch.zeros(8, 4))


def test_scales_are_exact_powers_of_two():
    """The port's scales are exact powers of two at every exponent. The
    reference's are too for 2^-12 .. 2^12 (every scale of the trees
    above); off that range XLA's CPU exp2 of an integer is off by up to
    ~10 ulps (ROADMAP Queue 3), so there the two agree to 4e-6 only."""
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(64, 48)) * np.exp2(rng.integers(
        -30, 16, size=48))).astype(np.float32)
    got = quant.quantize_leaf(_t(w)).scale
    m, _ = np.frexp(got.numpy())
    assert np.all(m == 0.5)
    want = np.asarray(jq.quantize_leaf(jnp.asarray(w)).scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=4e-6, atol=0)
    small = (np.abs(np.log2(want)) <= 12)
    np.testing.assert_array_equal(got.numpy()[small], want[small])


def test_quant_modes_and_errors_mirror_jax():
    assert quant.QUANT_MODES == jq.QUANT_MODES
    tree = {"a/w": torch.ones(4, 4)}
    assert quant.quantize_tree(tree, "none") is tree
    with pytest.raises(ValueError, match=r"int4.*none.*int8"):
        quant.quantize_tree(tree, "int4")


def test_leaf_helpers_equal_jax():
    table = np.random.default_rng(0).normal(size=(32, 8)).astype(
        np.float32) * 0.1
    ids = np.array([[0, 5], [31, 5]], np.int32)
    jl = jq.with_delta(jq.quantize_tree({"t": jnp.asarray(table)}))["t"]
    jl = dataclasses.replace(jl, delta=jnp.asarray(table * 1e-2))
    tl = quant.QuantizedLeaf(q=_t(jl.q), scale=_t(jl.scale),
                             delta=_t(jl.delta))
    np.testing.assert_array_equal(
        quant.take_rows(tl, _t(ids)).numpy(),
        np.asarray(jq.take_rows(jl, jnp.asarray(ids))))
    np.testing.assert_array_equal(tl.dequantize().numpy(),
                                  np.asarray(jl.dequantize()))
    full = quant.dequantize_tree({"t": tl, "b": torch.ones(3)})
    assert torch.equal(full["t"], tl.dequantize()) and full["b"].sum() == 3
    assert tl.nbytes == jl.nbytes
    # a stacked leaf's layer slices q, scale and delta together
    st = quant.with_delta(quant.quantize_tree(
        {"blocks/w": torch.randn(3, 8, 16)}))["blocks/w"]
    one = st.layer(1)
    assert (one.q.shape, one.scale.shape, one.delta.shape) == \
        ((8, 16), (16,), (8, 16))
    assert torch.equal(one.dequantize_f32(), st.dequantize_f32()[1])


def test_int8_quantize_equals_jax():
    g = np.random.default_rng(4).normal(size=(33, 70)).astype(np.float32)
    q, s = quant.int8_quantize(_t(g))
    jqv, js = jq.int8_quantize(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    assert float(s) == float(js)
    np.testing.assert_array_equal(
        quant.int8_dequantize(q, float(s)).numpy(),
        np.asarray(jq.int8_dequantize(jqv, float(js))))


# ---------------------------------------------------------------------------
# the plain versions of the int8 kernels


@pytest.mark.parametrize("dist", ["rademacher", "gaussian"])
@pytest.mark.parametrize("coeff", [0.01, -0.01])
def test_zo_add_q_ref_matches_jax_kernel(dist, coeff):
    w = jax.random.normal(jax.random.PRNGKey(0), (64, 256),
                          jnp.float32) * 0.1
    ql = jq.quantize_leaf(w)
    want = np.asarray(j_ops.zo_add(ql.q, 7, 123, coeff, dist=dist,
                                   scale=ql.scale))
    got = ops.zo_add(_t(ql.q), 7, 123, coeff, dist, scale=_t(ql.scale))
    assert got.dtype == torch.float32
    atol = 0.0 if dist == "rademacher" else GAUSS_ATOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_zo_add_q_ref_stacked_slice_matches_jax_kernel():
    """A layer slice of a stacked (L, K, N) leaf (prehashed base,
    prime_offset 1) equals that slice of the whole leaf's field."""
    w = jax.random.normal(jax.random.PRNGKey(1), (3, 16, 128),
                          jnp.float32) * 0.1
    ql = jq.quantize_leaf(w)
    salt = j_rng.leaf_salt("blocks/mlp/w_in/w")
    full = zp.zo_add_q_ref(_t(ql.q), _t(ql.scale), 5, salt, 0.5)
    for layer in range(3):
        base = j_rng.fold_leading(j_rng.leaf_base(jnp.uint32(5), salt),
                                  layer)
        want = np.asarray(j_ops.zo_add(ql.q[layer], base, 0, 0.5,
                                       prime_offset=1, prehashed=True,
                                       scale=ql.scale[layer]))
        np.testing.assert_array_equal(full[layer].numpy(), want)


@pytest.mark.parametrize("dist", ["rademacher", "gaussian"])
@pytest.mark.parametrize("coeff", [0.01, -0.01])
@pytest.mark.parametrize("mkn", MM_SHAPES, ids=str)
def test_zo_matmul_q_ref_matches_jax_kernel(mkn, dist, coeff):
    m, k, n = mkn
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (m, k), jnp.float32) * 0.1
    w = jax.random.normal(jax.random.fold_in(key, 1), (k, n),
                          jnp.float32) * 0.1
    ql = jq.quantize_leaf(w)
    want = np.asarray(j_ops.zo_matmul(x, ql.q, 7, 123, coeff, dist=dist,
                                      scale=ql.scale))
    got = ops.zo_matmul(_t(x), _t(ql.q), 7, 123, coeff, dist,
                        scale=_t(ql.scale))
    atol = float(np.max(ql.scale)) * k * 1e-6 + 1e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)


def test_int8_wrappers_take_the_plain_version_on_the_cpu():
    ql = quant.quantize_leaf(torch.randn(8, 16))
    before = dict(ops.LAUNCHES)
    ops.zo_add(ql.q, 1, 2, 0.5, scale=ql.scale)
    ops.zo_matmul(torch.randn(3, 8), ql.q, 1, 2, 0.5, scale=ql.scale)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="scale shape"):
        ops.zo_add(ql.q, 1, 2, 0.5, scale=ql.scale[:3])
    with pytest.raises(ValueError, match="out="):
        ops.zo_add(ql.q, 1, 2, 0.5, scale=ql.scale, out=ql.q)


# ---------------------------------------------------------------------------
# PerturbCtx and the fused forward over an int8 base


@pytest.mark.parametrize("with_delta", [False, True])
def test_ctx_primitives_on_quantized_leaves_equal_jax(with_delta):
    rng = np.random.default_rng(5)
    w = rng.normal(size=(3, 32, 48)).astype(np.float32) * 0.1
    table = rng.normal(size=(40, 12)).astype(np.float32) * 0.1
    jtree = jq.quantize_tree({"blocks": {"w": jnp.asarray(w)},
                              "tok": jnp.asarray(table)})
    if with_delta:
        jtree = jax.tree.map(
            lambda l: dataclasses.replace(l, delta=jnp.asarray(
                rng.normal(size=l.shape).astype(np.float32) * 1e-3)),
            jtree, is_leaf=jq.is_quantized)
    tw = quant.QuantizedLeaf(q=_t(jtree["blocks"]["w"].q),
                             scale=_t(jtree["blocks"]["w"].scale),
                             delta=None if not with_delta
                             else _t(jtree["blocks"]["w"].delta))
    tt = quant.QuantizedLeaf(q=_t(jtree["tok"].q),
                             scale=_t(jtree["tok"].scale),
                             delta=None if not with_delta
                             else _t(jtree["tok"].delta))
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    ids = np.array([[0, 39, 7], [5, 5, 11]], np.int32)
    jctx = JPerturbCtx(seed=np.uint32(SEED), coeff=EPS)
    tctx = PerturbCtx(seed=SEED, coeff=EPS)
    jl = jctx.scope("blocks").at_layer(2)
    tl = tctx.scope("blocks").at_layer(2)
    jw = jax.tree.map(lambda a: a[2], jtree["blocks"]["w"])
    np.testing.assert_array_equal(
        tl.perturb("w", tw.layer(2)).numpy(), np.asarray(jl.perturb("w", jw)))
    np.testing.assert_allclose(
        tl.matmul(_t(x), tw.layer(2)).numpy(),
        np.asarray(jl.matmul(jnp.asarray(x), jw)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tctx.take("tok", tt, _t(ids)).numpy(),
        np.asarray(jctx.take("tok", jtree["tok"], jnp.asarray(ids))))


@pytest.mark.parametrize("arch", ["opt-1.3b", "roberta-large"])
def test_frozen_base_fused_loss_matches_jax(arch):
    jmodel, jparams, tmodel, tparams, jbatch, tbatch = _case(arch)
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


@pytest.mark.parametrize("arch", ["opt-1.3b", "roberta-large"])
def test_frozen_base_fused_loss_equals_materialized_in_port(arch):
    """Fused (``zo_matmul_q`` path) == ``loss(ctx.materialize(qparams))``
    (``zo_add_q`` path) at atol 0, both signs."""
    _, _, tmodel, tparams, _, tbatch = _case(arch)
    for seed, coeff in ((3, 1e-3), (11, -1e-3)):
        ctx = PerturbCtx(seed=seed, coeff=np.float32(coeff))
        fused = tmodel.loss(tparams, tbatch, perturb=ctx)
        mat = tmodel.loss(ctx.materialize(tparams), tbatch)
        assert torch.equal(fused, mat), (arch, coeff, fused, mat)


def test_int8_forward_logits_match_jax():
    jmodel, jparams, tmodel, tparams, jbatch, tbatch = _case("opt-1.3b")
    want, _ = jax.jit(jmodel.forward)(jparams, jbatch)
    got, _ = tmodel.forward(tparams, tbatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)

"""The port's ``multipod_directions`` example on 8 gloo ranks (a (pod 2,
data 2, model 2) mesh), from the JAX package's initial parameters of
reduced qwen3-4b, against the JAX package's unsharded
``mezo_step_vmapdir`` on the same batch: gs per direction within 1e-3
and the K = 2 update within 1e-6; the straggler-masked update equals the
K = 1 update (1e-6, the JAX example's check, here on every leaf); the
collectives traced across pods (``roofline/trace.py``, by process group)
move the (K,) gs vector's bytes and nothing else."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import MezoConfig as JMezoConfig  # noqa: E402
from repro.core import mezo_step_vmapdir as j_step  # noqa: E402
from repro.core.perturb import _path_str  # noqa: E402
from repro.data.synthetic import lm_batch_at, synthetic_lm_corpus  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.examples import multipod_directions as mp_ex  # noqa: E402

GS_ATOL = 1e-3
PARAM_ATOL = 1e-6


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.array(v) for p, v in leaves}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg = j_get_config("qwen3-4b").reduced(d_model=64, n_layers=2)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    stream = synthetic_lm_corpus(mp_ex.BATCH * 40 * (mp_ex.SEQ + 1),
                                 jcfg.vocab, 0)
    batch = {k: jnp.asarray(v) for k, v in lm_batch_at(
        0, mp_ex.BATCH, mp_ex.SEQ, jcfg.vocab, stream).items()}
    mcfg = JMezoConfig(eps=1e-2, lr=1e-2, n_directions=2)
    p2, aux = j_step(jmodel.loss, jparams, batch, jnp.uint32(0), mcfg)
    got = mp_ex.run(_flat(jparams),
                    workdir=str(tmp_path_factory.mktemp("multipod")))
    return dict(jgs=np.asarray(aux.gs), jp2=_flat(p2), got=got)


def test_gs_per_direction_match_unsharded_jax(runs):
    gs = np.asarray(runs["got"]["gs"], np.float32)
    assert gs.shape == (2,) and np.isfinite(gs).all()
    np.testing.assert_allclose(gs, runs["jgs"], rtol=0, atol=GS_ATOL)


def test_direction_parallel_update_matches_unsharded_jax(runs):
    params = runs["got"]["params"]
    assert runs["got"]["k2_moved"] > 0
    for k, want in runs["jp2"].items():
        np.testing.assert_allclose(params[f"k2::{k}"], want, rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_straggler_masked_update_equals_k1(runs):
    got = runs["got"]
    assert got["masked_vs_k1_ln_f"] <= 1e-6
    assert got["masked_vs_k1"] <= 1e-6


def test_cross_pod_traffic_is_the_gs_vector(runs):
    got = runs["got"]
    assert got["cross_pod_bytes"] == 2 * 4       # (K,) f32 gs, K = 2
    assert got["collective_total"] > got["cross_pod_bytes"]

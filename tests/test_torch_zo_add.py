"""Port parity: the ``zo_add`` seed-replay sweep and ``add_scaled_z``.

On the CPU the port's plain version is held against the JAX Pallas
kernel in interpret mode and against ``zo_add_ref``: atol 0 with
Rademacher z, 1e-6 with Gaussian z (f32 log/cos last ulps). The CUDA
kernel is held against the plain version on the card by
``tests/test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.core import perturb as jperturb  # noqa: E402
from repro.core import rng as jrng  # noqa: E402
from repro.core.mezo import MezoConfig as JMezoConfig  # noqa: E402
from repro.core.mezo import replay_update as j_replay_update  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import zo_perturb as jzo  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.core import perturb as tperturb  # noqa: E402
from repro_torch.core import rng as trng  # noqa: E402
from repro_torch.core.engine import MezoConfig, update_rule  # noqa: E402
from repro_torch.core.mezo import replay_update  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import zo_perturb as tzo  # noqa: E402

torch.set_num_threads(1)

GAUSS_ATOL = 1e-6


def _w(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


@pytest.mark.parametrize("dist,atol", [("rademacher", 0.0),
                                       ("gaussian", GAUSS_ATOL)])
@pytest.mark.parametrize("shape,block", [((24, 40), (8, 16)),
                                         ((16, 128), (256, 256)),
                                         ((9, 7), (3, 7))])
def test_plain_zo_add_matches_pallas_interpret_and_ref(shape, block, dist,
                                                       atol):
    w = _w(shape)
    seed, salt, coeff = 0xC0FFEE, jrng.leaf_salt("blocks/attn/wq/w"), -0.0375
    kern = np.asarray(jzo.zo_add(jnp.asarray(w), np.uint32(seed), salt,
                                 coeff, dist=dist, block=block,
                                 interpret=True))
    ref = np.asarray(jref.zo_add_ref(jnp.asarray(w), np.uint32(seed), salt,
                                     coeff, dist))
    got = tzo.zo_add_ref(torch.from_numpy(w), seed, salt, coeff,
                         dist).numpy()
    np.testing.assert_allclose(got, kern, rtol=0, atol=atol)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    # ops dispatch: a CPU tensor takes the plain version
    np.testing.assert_array_equal(
        ops.zo_add(torch.from_numpy(w), seed, salt, coeff, dist).numpy(),
        got)


def test_stacked_leaf_matches_per_layer_prehashed_kernel():
    """z spans the whole stacked (L, m, n) leaf: layer l equals the
    Pallas kernel's prehashed slice with the layer folded into the base."""
    w = _w((3, 8, 32), seed=1)
    seed, salt, coeff = 77, jrng.leaf_salt("blocks/mlp/w_in/w"), 0.5
    got = tzo.zo_add_ref(torch.from_numpy(w), seed, salt, coeff).numpy()
    base = jrng.leaf_base(np.uint32(seed), salt)
    for layer in range(3):
        want = jzo.zo_add(jnp.asarray(w[layer]),
                          jrng.fold_leading(base, np.uint32(layer)), 0,
                          coeff, block=(8, 16), interpret=True,
                          prime_offset=1, prehashed=True)
        np.testing.assert_array_equal(got[layer], np.asarray(want))
    # and the port's own prehashed slice agrees
    tbase = trng.fold_leading(trng.leaf_base(seed, salt), 2)
    part = tzo.zo_add_ref(torch.from_numpy(w[2]), tbase, 0, coeff,
                          prime_offset=1, prehashed=True).numpy()
    np.testing.assert_array_equal(part, got[2])


def test_tile_z_matches_pallas_tile():
    seed, salt = 5, 17
    got = tzo.tile_z(seed, salt, (4, 8), 8, 16, "rademacher").numpy()
    want = np.asarray(jzo._tile_z(np.uint32(seed), salt, (4, 8), 8, 16,
                                  "rademacher"))
    np.testing.assert_array_equal(got, want)


def _jax_opt_params(seed=0):
    cfg = get_config("opt-1.3b").reduced()
    params = j_build_model(cfg).init(jax.random.PRNGKey(seed))
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return cfg, params, {jperturb._path_str(p): np.asarray(v)
                         for p, v in leaves}


def _torch_params(flat):
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def _flat(params):
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jperturb._path_str(p): np.asarray(v) for p, v in leaves}


def test_add_scaled_z_reduced_opt_tree_bit_exact():
    _, jparams, flat = _jax_opt_params()
    tparams = _torch_params(flat)
    jsalts = _flat(jperturb.leaf_salts(jparams))
    assert tperturb.leaf_salts(tparams) == {k: int(v)
                                            for k, v in jsalts.items()}
    want = _flat(jperturb.add_scaled_z(jparams, np.uint32(4242), 0.0123))
    got = tperturb.add_scaled_z(tparams, 4242, 0.0123)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_add_scaled_z_bf16_leaf_bit_exact():
    w = _w((16, 24), seed=2)
    jw = jnp.asarray(w, jnp.bfloat16)
    want = jperturb.add_scaled_z({"lm_head": {"w": jw}}, np.uint32(9), 0.01)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(
        torch.bfloat16)
    got = tperturb.add_scaled_z({"lm_head/w": tw}, 9, 0.01)["lm_head/w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(want["lm_head"]["w"].astype(jnp.float32)))


@pytest.mark.parametrize("wd,mask", [(0.0, None), (0.1, [1.0, 0.0, 1.0])])
def test_replay_update_bit_exact(wd, mask):
    """The sgd update rule: f32 coefficients (``-lr * f32(1/K)``, c*g,
    ``lr * wd``) must fork no ulp from the JAX engine."""
    _, jparams, flat = _jax_opt_params(seed=1)
    gs = np.asarray([0.7, -1.3, 2.1], np.float32)
    jcfg = JMezoConfig(lr=3e-2, weight_decay=wd)
    want = _flat(j_replay_update(
        jparams, np.uint32(31), gs, jcfg,
        direction_mask=None if mask is None else np.asarray(mask,
                                                           np.float32)))
    got = replay_update(_torch_params(flat), np.uint32(31), gs,
                        MezoConfig(lr=3e-2, weight_decay=wd),
                        direction_mask=mask)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_unported_update_rules_raise():
    """Every reference rule resolves (stale-sgd since the fleet slice);
    an unknown name raises."""
    assert update_rule("stale-sgd").name == "stale-sgd"
    with pytest.raises(ValueError, match="unknown update rule"):
        update_rule("adamw")
    assert update_rule("sgd").name == "sgd"
    assert update_rule("momentum").name == "momentum"


def test_cuda_launcher_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tzo.zo_add_cuda(torch.zeros(4, 4), 1, 2, 0.5)

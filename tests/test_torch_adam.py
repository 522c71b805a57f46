"""Port parity: the gradient baseline (``optim/adam.py``,
``optim/compression.py``, the trainer's Adam arm, ``--optimizer adam``).

Across packages, from the JAX package's parameters and inputs:
  * ``adam_update`` within 1e-6 of the reference's over three steps (f32
    leaves; plain, weight decay, gradient clipping), moments included,
    and ``sgd_train_step``'s parameters within 1e-7 at lr 1e-3;
  * autograd's loss and gradients on reduced OPT-1.3B and RoBERTa-large
    (f32) within ``GRAD_RTOL`` 1e-4 / ``GRAD_ATOL`` 1e-6 of
    ``jax.grad``'s (summation order only), stated before the first run;
  * ``int8_compress_tree`` bit-equal to the reference's (eager and under
    ``jit``) across four decades of gradient scale;
  * ``--optimizer adam`` CLI losses within 1e-4 of the JAX CLI's over 3
    steps;
  * a JAX Adam snapshot (params, mu, nu, count) restores in the port to
    the JAX manager's own restore at atol 0, and a port trainer resumed
    from it continues JAX's uninterrupted run within 1e-4;
  * the errors: adam with ``quant="int8"`` or with an estimator/update
    raises the reference's ``ValueError``; ``attn_impl="flash"`` under a
    gradient raises in both packages, since neither flash kernel has a
    backward (the reference's from ``pallas_call``'s differentiation
    rule).
Inside the port: the Adam arm descends, and a crashed-and-resumed Adam
run equals an uninterrupted one at atol 0 (the moments restored).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (import order: repro.optim needs it)
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.engine import TrainState as JTrainState  # noqa: E402
from repro.core.perturb import _path_str  # noqa: E402
from repro.data.synthetic import lm_batches as j_lm_batches  # noqa: E402
from repro.launch import train as j_train_cli  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.optim import compression as j_compression  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.engine import TrainState  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adam, compression  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402

torch.set_num_threads(1)

UPDATE_ATOL = 1e-6
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6
LOSS_ATOL = 1e-4
CFG = get_config("qwen3-4b").reduced()
JCFG = j_get_config("qwen3-4b").reduced()


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.array(v) for p, v in leaves}


def _tensors(flat):
    return store.params_from_numpy(flat, "cpu")


def _batches(start=0):
    return lm_batches(4, 16, CFG.vocab, seed=3, start_step=start)


# ---------------------------------------------------------------------------
# across packages


@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.1},
                                {"grad_clip": 0.5}], ids=str)
def test_adam_update_matches_jax(kw):
    rng = np.random.default_rng(1)
    shapes = {"a/w": (16, 8), "a/b": (8,), "c": (3, 4, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = adam.AdamConfig(lr=1e-2, **kw)
    jcfg = jadam.AdamConfig(lr=1e-2, **kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = adam.adam_init(tp)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jadam.adam_init(jp)
    for _ in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        tp, ts = adam.adam_update(
            tp, {k: torch.from_numpy(v) for k, v in grads.items()}, ts, cfg)
        jp, js = jadam.adam_update(
            jp, {k: jnp.asarray(v) for k, v in grads.items()}, js, jcfg)
    assert int(ts.count) == int(js.count) == 3
    for k in shapes:
        for got, want in ((tp[k], jp[k]), (ts.mu[k], js.mu[k]),
                          (ts.nu[k], js.nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=UPDATE_ATOL, err_msg=k)


@pytest.mark.parametrize("arch", ["opt-1.3b", "roberta-large"])
def test_autograd_matches_jax_grad(arch):
    jcfg = j_get_config(arch).reduced()
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    batch = next(train_cli.batch_stream(cfg, 2, 16, 0))
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = _tensors(_flat(jparams))
    loss, grads = adam.value_and_grad(
        build_model(cfg).loss, params,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert not any(p.requires_grad for p in params.values())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                               atol=1e-5)
    want = _flat(jgrads)
    assert set(grads) == set(want)
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)


def test_int8_compress_tree_bit_equal_jax():
    rng = np.random.default_rng(0)
    for scale in (1e-3, 1.0, 37.0, 1e3):
        g = {"a": (rng.standard_normal((64, 48)) * scale).astype(np.float32),
             "b": (rng.standard_normal((1000,)) * scale).astype(np.float32),
             "s": np.float32(scale)}
        got = compression.int8_compress_tree(
            {k: torch.from_numpy(np.asarray(v)) for k, v in g.items()})
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        for want in (j_compression.int8_compress_tree(jg),
                     jax.jit(j_compression.int8_compress_tree)(jg)):
            for k in g:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))


def test_cli_adam_losses_match_jax():
    argv = ["--arch", "opt-1.3b", "--reduced", "--optimizer", "adam",
            "--adam-lr", "1e-3", "--steps", "3", "--batch", "2", "--seq",
            "16", "--log-every", "1"]
    jtr = j_train_cli.make_trainer(j_train_cli.build_argparser()
                                   .parse_args(argv))
    jinit = jtr.init_params()
    init = _flat(jinit)
    jtr.train(jax.tree.map(jnp.copy, jinit))
    ttr = train_cli.run(argv + ["--device", "cpu"], params=_tensors(init))
    assert ttr.strategy is None and len(ttr.losses) == 3
    np.testing.assert_allclose(ttr.losses, jtr.losses, rtol=0,
                               atol=LOSS_ATOL)


def test_port_resumes_a_jax_adam_snapshot(tmp_path):
    """JAX trains 5 Adam steps and, elsewhere, crashes at step 3 with a
    snapshot a step; the port restores that snapshot (params, mu, nu,
    count) as JAX's manager does, at atol 0, and its resumed run
    continues JAX's uninterrupted losses."""
    acfg = dict(lr=3e-3)
    jtc = dict(optimizer="adam", adam=jadam.AdamConfig(**acfg), n_steps=5,
               snapshot_every=1, log_every=100)
    jfull = JTrainer(JCFG, JTrainerConfig(**jtc),
                     j_lm_batches(4, 16, JCFG.vocab, seed=3))
    jfull.train()
    ck = str(tmp_path / "jax")
    with pytest.raises(RuntimeError):
        JTrainer(JCFG, JTrainerConfig(ckpt_dir=ck, **jtc),
                 j_lm_batches(4, 16, JCFG.vocab, seed=3)).train(fail_at=3)

    jp = jfull.init_params()
    jstate, jnxt = JManager(ck, mezo_cfg=None).restore(
        JTrainState(params=jp, step=jnp.uint32(0), opt=jadam.adam_init(jp)))
    tp = {k: torch.zeros_like(v) for k, v in _tensors(_flat(jp)).items()}
    tstate, tnxt = CheckpointManager(ck).restore(
        TrainState(params=tp, step=0, opt=adam.adam_init(tp)))
    assert tnxt == jnxt == 3 and tstate.step == 3
    assert int(tstate.opt.count) == int(jstate.opt.count) == 3
    for mine, ref in ((tstate.params, jstate.params),
                      (tstate.opt.mu, jstate.opt.mu),
                      (tstate.opt.nu, jstate.opt.nu)):
        ref = _flat(ref)
        assert set(mine) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(mine[k].numpy(), ref[k])

    tr = Trainer(CFG, TrainerConfig(ckpt_dir=ck, device="cpu",
                                    **dict(jtc, adam=adam.AdamConfig(
                                        **acfg))),
                 _batches(start=3), log_fn=lambda s: None)
    tr.train()
    np.testing.assert_allclose(tr.losses, jfull.losses[3:], rtol=0,
                               atol=LOSS_ATOL)


def test_adam_errors_mirror_jax():
    for tc, match in ((dict(quant="int8"), "frozen"),
                      (dict(estimator="fused"), "adam"),
                      (dict(update="sgd"), "adam")):
        with pytest.raises(ValueError, match=match):
            Trainer(CFG, TrainerConfig(optimizer="adam", device="cpu", **tc),
                    iter(()))
        with pytest.raises(ValueError, match=match):
            JTrainer(JCFG, JTrainerConfig(optimizer="adam", **tc), iter(()))


def test_flash_attention_has_no_gradient_in_either_package():
    """attn_impl="flash" under the gradient baseline: the reference's
    Pallas kernel has no differentiation rule (its ``pallas_call`` JVP
    asserts), and the port's flash_attention refuses inputs that need a
    gradient, on the CPU as on the card."""
    jcfg = dataclasses.replace(j_get_config("opt-1.3b").reduced(),
                               attn_impl="flash")
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = next(lm_batches(2, 16, jcfg.vocab, seed=0))
    with pytest.raises(AssertionError):
        jadam.grad_train_step(jmodel.loss, jparams,
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jadam.adam_init(jparams), jadam.AdamConfig())
    cfg = dataclasses.replace(get_config("opt-1.3b").reduced(),
                              attn_impl="flash")
    params = _tensors(_flat(jparams))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.raises(RuntimeError, match="no backward"):
        adam.grad_train_step(build_model(cfg).loss, params, tb,
                             adam.adam_init(params), adam.AdamConfig())
    assert not any(p.requires_grad for p in params.values())
    # the forward alone (the ZO paths) is unchanged
    assert np.isfinite(float(build_model(cfg).loss(params, tb)))


# ---------------------------------------------------------------------------
# inside the port


def test_adam_arm_descends():
    tc = TrainerConfig(optimizer="adam", adam=adam.AdamConfig(lr=3e-3),
                       n_steps=15, log_every=100, device="cpu")
    tr = Trainer(CFG, tc, _batches(), log_fn=lambda s: None)
    tr.train()
    assert tr.losses[-1] < tr.losses[0]


def test_adam_crash_resume_restores_moments(tmp_path):
    n = 8
    kw = dict(optimizer="adam", adam=adam.AdamConfig(lr=3e-3), n_steps=n,
              snapshot_every=1, log_every=100, device="cpu")
    full = Trainer(CFG, TrainerConfig(ckpt_dir=str(tmp_path / "a"), **kw),
                   _batches(), log_fn=lambda s: None).train()
    tc_b = TrainerConfig(ckpt_dir=str(tmp_path / "b"), **kw)
    with pytest.raises(RuntimeError, match="injected"):
        Trainer(CFG, tc_b, _batches(), log_fn=lambda s: None).train(
            fail_at=5)
    logs = []
    resumed = Trainer(CFG, tc_b, _batches(start=5), log_fn=logs.append
                      ).train()
    assert "[trainer] resumed at step 5" in logs
    for k in full:
        assert torch.equal(resumed[k], full[k]), k


def test_compressed_gradients_step():
    tc = TrainerConfig(optimizer="adam",
                       adam=adam.AdamConfig(lr=3e-3, compress_grads=True),
                       n_steps=3, log_every=100, device="cpu")
    tr = Trainer(CFG, tc, _batches(), log_fn=lambda s: None)
    tr.train()
    assert len(tr.losses) == 3 and np.isfinite(tr.losses).all()


def test_sgd_train_step_matches_jax():
    """The plain gradient-descent step (f32 update, cast back) from the
    JAX package's parameters: loss within 1e-5, parameters within 1e-7
    of ``jax.grad``'s step at lr 1e-3 (the gradients' 1e-4 relative
    summation-order gap times lr)."""
    jcfg = j_get_config("opt-1.3b").reduced()
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(2))
    batch = next(lm_batches(2, 16, jcfg.vocab, seed=4))
    params = _tensors(_flat(jparams))
    jp, jloss = jadam.sgd_train_step(
        jmodel.loss, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        lr=1e-3)
    tp, loss = adam.sgd_train_step(
        build_model(get_config("opt-1.3b").reduced()).loss, params,
        {k: torch.from_numpy(v) for k, v in batch.items()}, lr=1e-3)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    want = _flat(jp)
    for k in want:
        np.testing.assert_allclose(tp[k].numpy(), want[k], rtol=0,
                                   atol=1e-7, err_msg=k)

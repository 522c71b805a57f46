"""Port parity: the MeZO training path (engine, trainer, CLI, checkpoints).

Across packages, from the JAX package's initial parameters:
  * the registry's estimator, update-rule and strategy names are JAX's;
  * ``repro_torch.launch.train --device cpu`` per-step losses are within
    1e-5 of ``repro.launch.train``'s for ``mezo`` and ``mezo-fused``,
    and the logged gs within 1e-3 (a loss gap of 2e-6 at eps 1e-3);
  * a replay log written by either package replays in the other onto the
    initial parameters to the other's final parameters at atol 0
    (``mezo-fused``: pristine base point, Rademacher z);
  * ``data/synthetic.py`` batches are equal;
  * the momentum step (``mezo_momentum_step``) is within 1e-3 in gs and
    1e-6 in parameters.
Inside the port (mirroring ``tests/test_fused.py``): fused == vmapdir,
fused replay == live at atol 0, ``run_chunk`` == stepwise at atol 0, a
crashed-and-resumed momentum run == an uninterrupted one at atol 0, and
``--ckpt-dir`` resume prints ``[trainer] resumed at step N``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import replay_log as j_replay_log  # noqa: E402
from repro.core import MezoConfig as JMezoConfig  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import mezo as jmezo  # noqa: E402
from repro.core.perturb import _path_str  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.launch import train as j_train_cli  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro_torch.checkpoint import ReplayLog, replay_into, store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import mezo  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402

torch.set_num_threads(1)

LOSS_ATOL = 1e-5
GS_ATOL = 1e-3
PARAM_ATOL = 1e-6
CLI = ["--arch", "opt-1.3b", "--reduced", "--steps", "4", "--batch", "2",
       "--seq", "16", "--lr", "1e-3", "--log-every", "1"]


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.array(v) for p, v in leaves}


def _tensors(flat):
    return store.params_from_numpy(flat, "cpu")


def _assert_equal(got, want, atol=0.0):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_allclose(g, want[k], rtol=0, atol=atol, err_msg=k)


def _tiny(seed=0):
    """Reduced OPT-1.3B (port) with random params and one LM batch."""
    cfg = get_config("opt-1.3b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in next(tsyn.lm_batches(2, 16, cfg.vocab, seed=1))
             .items()}
    return model, params, batch


def _copy(params):
    return {k: v.clone() for k, v in params.items()}


# ---------------------------------------------------------------------------
# across packages


def test_registry_names_equal_jax():
    assert engine.estimator_names() == jengine.estimator_names()
    assert engine.update_rule_names() == jengine.update_rule_names()
    assert engine.strategy_names() == jengine.strategy_names()
    for name in engine.strategy_names():
        t, j = engine.get_strategy(name), jengine.get_strategy(name)
        assert t.name == j.name
    assert (engine.build_strategy("fused", "stale-sgd").name
            == jengine.build_strategy("fused", "stale-sgd").name)


def test_synthetic_batches_equal_jax():
    for tb, jb in zip(tsyn.lm_batches(3, 12, 64, seed=4, n_steps=3),
                      jsyn.lm_batches(3, 12, 64, seed=4, n_steps=3)):
        _assert_equal(tb, jb)
    for _, (tb, jb) in zip(range(3), zip(tsyn.sst2_batches(4, 10, 64, 2),
                                         jsyn.sst2_batches(4, 10, 64, 2))):
        _assert_equal(tb, jb)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs, 4 steps of ``mezo`` and of ``mezo-fused`` from the JAX
    package's initial parameters, each with a replay log."""
    out = {}
    for opt in ("mezo", "mezo-fused"):
        root = tmp_path_factory.mktemp(opt)
        jargs = j_train_cli.build_argparser().parse_args(
            CLI + ["--optimizer", opt, "--ckpt-dir", str(root / "jax")])
        jtr = j_train_cli.make_trainer(jargs)
        jinit = jtr.init_params()
        init = _flat(jinit)
        jfinal = _flat(jtr.train(jax.tree.map(jnp.copy, jinit)))
        ttr = train_cli.run(
            CLI + ["--optimizer", opt, "--device", "cpu", "--ckpt-dir",
                   str(root / "torch"), "--metrics-out",
                   str(root / "m.json")], params=_tensors(init))
        out[opt] = dict(init=init, jax_init=jax.tree.map(np.array, jinit),
                        jax_losses=jtr.losses, jax_final=jfinal,
                        jax_log=root / "jax" / "replay.jsonl",
                        torch_losses=ttr.losses,
                        torch_final=ttr.params,
                        torch_log=root / "torch" / "replay.jsonl",
                        metrics=root / "m.json")
    return out


@pytest.mark.parametrize("opt", ["mezo", "mezo-fused"])
def test_cli_losses_and_gs_match_jax(cli_runs, opt):
    run = cli_runs[opt]
    assert len(run["torch_losses"]) == 4
    np.testing.assert_allclose(run["torch_losses"], run["jax_losses"],
                               rtol=0, atol=LOSS_ATOL)
    jrec = j_replay_log.ReplayLog.read(str(run["jax_log"]))
    trec = ReplayLog.read(str(run["torch_log"]))
    assert [r["step"] for r in trec] == [0, 1, 2, 3]
    assert [r["seed"] for r in trec] == [r["seed"] for r in jrec]
    np.testing.assert_allclose([r["gs"] for r in trec],
                               [r["gs"] for r in jrec], rtol=0, atol=GS_ATOL)
    _assert_equal(run["torch_final"], run["jax_final"], atol=PARAM_ATOL)
    with open(run["metrics"]) as f:
        metrics = json.load(f)
    assert metrics == {"arch": "opt-1.3b", "optimizer": opt,
                       "losses": run["torch_losses"]}


def test_replay_logs_cross_packages(cli_runs):
    run = cli_runs["mezo-fused"]
    cfg = dict(lr=1e-3, eps=1e-3)
    # the JAX package's log, replayed by the port
    got, last = replay_into(_tensors(run["init"]),
                            ReplayLog.read(str(run["jax_log"])),
                            engine.MezoConfig(**cfg))
    assert last == 3
    _assert_equal(got, run["jax_final"])
    # the port's log, replayed by the JAX package
    want, _ = j_replay_log.replay_into(
        jax.tree.map(jnp.asarray, run["jax_init"]),
        j_replay_log.ReplayLog.read(str(run["torch_log"])),
        JMezoConfig(**cfg))
    _assert_equal(run["torch_final"], _flat(want))


def test_momentum_step_matches_jax():
    jcfg = j_get_config("opt-1.3b").reduced()
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    init = _flat(jparams)
    batch = next(jsyn.lm_batches(2, 16, jcfg.vocab, seed=1))
    mcfg = dict(eps=1e-3, lr=1e-2, n_directions=2, momentum=0.9,
                momentum_window=3)
    hist = jengine.momentum_history_init(JMezoConfig(**mcfg))
    jp, jaux, jhist = jmezo.mezo_momentum_step(
        jmodel.loss, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        np.uint32(5), JMezoConfig(**mcfg), hist)
    tmodel = build_model(get_config("opt-1.3b").reduced())
    tp, taux, thist = mezo.mezo_momentum_step(
        tmodel.loss, _tensors(init),
        {k: torch.from_numpy(v) for k, v in batch.items()}, 5,
        engine.MezoConfig(**mcfg),
        engine.momentum_history_init(engine.MezoConfig(**mcfg)))
    np.testing.assert_allclose(taux.gs.numpy(), np.asarray(jaux.gs), rtol=0,
                               atol=GS_ATOL)
    assert thist["seeds"].tolist() == np.asarray(jhist["seeds"]).tolist()
    _assert_equal(tp, _flat(jp), atol=PARAM_ATOL)


# ---------------------------------------------------------------------------
# inside the port


def test_fused_matches_vmapdir_and_replays_bit_exact():
    model, params, batch = _tiny()
    mcfg = engine.MezoConfig(eps=1e-3, lr=1e-2, n_directions=3)
    pf, auxf = mezo.mezo_step_fused(model.loss, _copy(params), batch, 7,
                                    mcfg)
    pv, auxv = mezo.mezo_step_vmapdir(model.loss, _copy(params), batch, 7,
                                      mcfg)
    np.testing.assert_allclose(auxf.gs.numpy(), auxv.gs.numpy(), rtol=1e-6,
                               atol=1e-7)
    for k in pf:
        np.testing.assert_allclose(pf[k].numpy(), pv[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    pr = mezo.replay_update(_copy(params), auxf.seed, auxf.gs, mcfg)
    _assert_equal(pf, {k: v.numpy() for k, v in pr.items()})


def test_spsa_estimate_is_the_replayed_update():
    """mean_k g_k z_k from ``spsa_gradient_estimate`` equals the sgd
    update with lr = -1 from the same directions' gs (K = 2: scaling by
    1/2 is exact either way)."""
    model, params, batch = _tiny()
    mcfg = engine.MezoConfig(eps=1e-3, lr=1e-2, n_directions=2)
    _, aux = mezo.mezo_step_vmapdir(model.loss, _copy(params), batch, 3,
                                    mcfg)
    est = mezo.spsa_gradient_estimate(model.loss, params, batch, 3, mcfg)
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    want = mezo.replay_update(zero, 3, aux.gs,
                              engine.MezoConfig(lr=-1.0, n_directions=2))
    _assert_equal(est, {k: v.numpy() for k, v in want.items()})


def test_run_chunk_equals_stepwise():
    model, params, _ = _tiny()
    cfg = get_config("opt-1.3b").reduced()
    mcfg = engine.MezoConfig(eps=1e-3, lr=1e-2, n_directions=2)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in tsyn.lm_batches(2, 16, cfg.vocab, seed=3, n_steps=3)]
    strat = engine.get_strategy("mezo-fused")
    state = strat.init_state(_copy(params), mcfg)
    for b in batches:
        state, _ = strat.step(model.loss, state, b,
                              engine.zrng.fold_seed(11, state.step), mcfg)
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    chunk, aux = strat.run_chunk(model.loss, strat.init_state(
        _copy(params), mcfg), stacked, 11, mcfg)
    assert chunk.step == 3 and aux.gs.shape == (3, 2)
    _assert_equal(chunk.params, {k: v.numpy() for k, v in
                                 state.params.items()})


def _trainer(steps, start_step=0, **kw):
    cfg = get_config("opt-1.3b").reduced()
    tcfg = TrainerConfig(optimizer="mezo-fused-momentum",
                         mezo=engine.MezoConfig(eps=1e-3, lr=1e-2,
                                                momentum=0.9,
                                                momentum_window=3),
                         n_steps=steps, seed=2, snapshot_every=2,
                         log_every=1, device="cpu", **kw)
    # the batch stream is the caller's: a resumed run starts it at the
    # resume step (the trainer draws one batch a step, as JAX's does)
    return Trainer(cfg, tcfg, tsyn.lm_batches(2, 16, cfg.vocab, seed=2,
                                              start_step=start_step),
                   log_fn=lambda s: None)


def test_momentum_crash_resume_equals_uninterrupted(tmp_path):
    whole = _trainer(5, ckpt_dir=str(tmp_path / "a")).train()
    with pytest.raises(RuntimeError, match="injected"):
        _trainer(5, ckpt_dir=str(tmp_path / "b")).train(fail_at=3)
    logs = []
    tr = _trainer(5, start_step=3, ckpt_dir=str(tmp_path / "b"))
    tr.log = logs.append
    resumed = tr.train()
    assert "[trainer] resumed at step 3" in logs
    _assert_equal(resumed, {k: v.numpy() for k, v in whole.items()})


def test_cli_resume_prints_resumed_step(tmp_path, capsys):
    argv = ["--arch", "roberta-large", "--reduced", "--device", "cpu",
            "--optimizer", "mezo-fused", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--snapshot-every", "2"]
    train_cli.run(argv + ["--steps", "3"])
    tr = train_cli.run(argv + ["--steps", "5"])
    assert "[trainer] resumed at step 3" in capsys.readouterr().out
    assert len(tr.losses) == 2 and np.isfinite(tr.losses).all()


@pytest.mark.parametrize("flag", [["--optimizer", "adam"],
                                  ["--update", "stale-sgd"],
                                  ["--straggler-redundancy", "1"]])
def test_unported_trainer_options_raise(flag):
    """The options that raised before the fleet slice now train: one
    step from the JAX package's parameters gives the JAX CLI's loss
    (within 1e-4, the gradient baseline's CLI tolerance)."""
    argv = CLI[:2] + ["--reduced", "--steps", "1", "--batch", "2",
                      "--seq", "16"] + flag
    jtr = j_train_cli.make_trainer(j_train_cli.build_argparser()
                                   .parse_args(argv))
    jinit = jtr.init_params()
    jtr.train(jax.tree.map(jnp.copy, jinit))
    ttr = train_cli.run(argv + ["--device", "cpu"],
                        params=_tensors(_flat(jinit)))
    np.testing.assert_allclose(ttr.losses, jtr.losses, rtol=0, atol=1e-4)


def test_cuda_device_requires_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.run(["--reduced", "--steps", "1"])

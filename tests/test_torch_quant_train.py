"""Port parity: training and serving over an int8 base.

Across packages, from one int8 tree (the JAX init quantized by the JAX
package with zero deltas, carried across by ``store.params_from_numpy``):
  * ``launch.train --quant int8`` (``mezo-fused`` and ``mezo``) per-step
    losses within 1e-5 of ``repro.launch.train``'s, gs within 1e-3; q and
    scale bit-frozen, the deltas moved;
  * int8 checkpoints (TrainState snapshot + replay log) restore in the
    other package at atol 0, both directions; replay logs cross too;
  * the walk / vmapdir / fused estimators and the momentum rule update an
    int8 tree as the JAX package does (gs within 1e-3), and sgd and
    momentum fold weight decay into the deltas as it does (atol 0);
  * ``AdapterStore`` replay onto an int8 base at atol 0, ``export_delta``
    (q at atol 0) and ``_apply_delta``, delta files crossing both ways,
    ``cached_bytes`` and ``materialize_state``; the two ``ServeEngine``s
    over one int8 base emit identical greedy tokens;
  * the trainer's quant errors mirror ``tests/test_trainer.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (repro.optim.quant needs it first)
from repro.checkpoint import replay_log as j_replay_log  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JManager  # noqa
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import MezoConfig as JMezoConfig  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core.perturb import _path_str  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.launch import train as j_train_cli  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim import quant as jq  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.adapters import AdapterStore as JAdapterStore  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, ReplayLog,  # noqa
                                    replay_into, store)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402
from repro_torch.optim import quant  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.serve import AdapterStore, Request, ServeEngine  # noqa

torch.set_num_threads(1)

LOSS_ATOL = 1e-5
GS_ATOL = 1e-3
PARAM_ATOL = 1e-6
CLI = ["--arch", "opt-1.3b", "--reduced", "--steps", "4", "--batch", "2",
       "--seq", "16", "--lr", "1e-3", "--log-every", "1", "--quant", "int8"]


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.array(v) for p, v in leaves}


def _dtypes(arch="opt-1.3b"):
    return {p: spec[1] for p, spec in
            param_shapes(get_config(arch).reduced()).items()}


def _tensors(flat):
    return store.params_from_numpy(flat, "cpu", _dtypes())


def _assert_equal(got, want, atol=0.0):
    """``got``: port params; ``want``: the JAX tree's flat numpy arrays."""
    got = store.params_to_numpy(got)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


@functools.lru_cache(maxsize=None)
def _int8_init():
    """The reduced OPT-1.3B JAX init, quantized with zero deltas: flat
    numpy arrays (``.../w/q``, ``.../w/scale``, ``.../w/delta``)."""
    jparams = j_build_model(j_get_config("opt-1.3b").reduced()).init(
        jax.random.PRNGKey(0))
    return _flat(jq.quantize_tree(jparams, with_delta=True))


def _jax_tree(flat):
    """A flat numpy int8 tree back into the JAX package's pytree."""
    like = jq.quantize_tree(j_build_model(
        j_get_config("opt-1.3b").reduced()).init(jax.random.PRNGKey(0)),
        with_delta=True)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[_path_str(p)]) for p, _ in leaves])


# ---------------------------------------------------------------------------
# the train CLI over an int8 base


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs, 4 steps with ``--quant int8`` from the same int8 tree,
    each with a checkpoint directory."""
    out = {}
    init = _int8_init()
    for opt in ("mezo", "mezo-fused"):
        root = tmp_path_factory.mktemp(opt)
        jargs = j_train_cli.build_argparser().parse_args(
            CLI + ["--optimizer", opt, "--ckpt-dir", str(root / "jax")])
        jtr = j_train_cli.make_trainer(jargs)
        jfinal = _flat(jtr.train(_jax_tree(init)))
        ttr = train_cli.run(
            CLI + ["--optimizer", opt, "--device", "cpu", "--ckpt-dir",
                   str(root / "torch")], params=_tensors(init))
        out[opt] = dict(jax_losses=jtr.losses, jax_final=jfinal,
                        jax_dir=root / "jax", torch_losses=ttr.losses,
                        torch_final=ttr.params, torch_dir=root / "torch",
                        strategy=ttr.strategy)
    return out


@pytest.mark.parametrize("opt", ["mezo", "mezo-fused"])
def test_int8_cli_matches_jax_and_freezes_the_base(cli_runs, opt):
    run = cli_runs[opt]
    np.testing.assert_allclose(run["torch_losses"], run["jax_losses"],
                               rtol=0, atol=LOSS_ATOL)
    jrec = j_replay_log.ReplayLog.read(str(run["jax_dir"] / "replay.jsonl"))
    trec = ReplayLog.read(str(run["torch_dir"] / "replay.jsonl"))
    assert [r["seed"] for r in trec] == [r["seed"] for r in jrec]
    np.testing.assert_allclose([r["gs"] for r in trec],
                               [r["gs"] for r in jrec], rtol=0, atol=GS_ATOL)
    _assert_equal(run["torch_final"], run["jax_final"], atol=PARAM_ATOL)
    init = _int8_init()
    moved = 0.0
    for path, leaf in run["torch_final"].items():
        if quant.is_quantized(leaf):
            np.testing.assert_array_equal(leaf.q.numpy(), init[path + "/q"])
            np.testing.assert_array_equal(leaf.scale.numpy(),
                                          init[path + "/scale"])
            moved += float(leaf.delta.abs().sum())
    assert moved > 0.0


def test_int8_checkpoints_and_logs_cross_packages(cli_runs):
    run = cli_runs["mezo-fused"]
    cfg = dict(lr=1e-3, eps=1e-3)
    init = _int8_init()
    # the port's snapshot + log, restored by the JAX package
    jstrat = jengine.get_strategy("mezo-fused")
    jlike = jstrat.init_state(_jax_tree(init), JMezoConfig(**cfg))
    jrest, nxt = JManager(str(run["torch_dir"]), mezo_cfg=JMezoConfig(**cfg),
                          update_rule=jstrat.update).restore(jlike)
    assert nxt == 4
    _assert_equal(run["torch_final"], _flat(jrest.params))
    # the JAX package's snapshot + log, restored by the port
    strat = engine.get_strategy("mezo-fused")
    mgr = CheckpointManager(str(run["jax_dir"]),
                            mezo_cfg=engine.MezoConfig(**cfg),
                            update_rule=strat.update)
    rest, nxt = mgr.restore(strat.init_state(_tensors(init),
                                             engine.MezoConfig(**cfg)))
    mgr.log.close()
    assert nxt == 4
    _assert_equal(rest.params, run["jax_final"])
    # the JAX log replayed onto the int8 init by the port, and back
    got, last = replay_into(_tensors(init), ReplayLog.read(
        str(run["jax_dir"] / "replay.jsonl")), engine.MezoConfig(**cfg))
    assert last == 3
    _assert_equal(got, run["jax_final"])
    want, _ = j_replay_log.replay_into(
        _jax_tree(init), j_replay_log.ReplayLog.read(
            str(run["torch_dir"] / "replay.jsonl")), JMezoConfig(**cfg))
    _assert_equal(run["torch_final"], _flat(want))


@pytest.mark.parametrize("strategy", ["mezo", "mezo-parallel",
                                      "mezo-fused-momentum"])
def test_int8_strategies_match_jax(strategy):
    """One step of each estimator (walk in place, vmapdir copies, fused)
    and of momentum on an int8 tree, against the JAX engine: gs within
    1e-3, parameters within lr x 1e-3 (what that gs gap moves them)."""
    init = _int8_init()
    cfg = dict(eps=1e-3, lr=1e-2, n_directions=2, momentum=0.9,
               momentum_window=3)
    jcfg = j_get_config("opt-1.3b").reduced()
    jmodel = j_build_model(jcfg)
    batch = next(jsyn.lm_batches(2, 16, jcfg.vocab, seed=1))
    jstrat = jengine.get_strategy(strategy)
    jstate = jstrat.init_state(_jax_tree(init), JMezoConfig(**cfg))
    jstate, jaux = jstrat.step(jmodel.loss, jstate,
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               np.uint32(5), JMezoConfig(**cfg))
    tmodel = build_model(get_config("opt-1.3b").reduced())
    strat = engine.get_strategy(strategy)
    state = strat.init_state(_tensors(init), engine.MezoConfig(**cfg))
    state, aux = strat.step(tmodel.loss, state,
                            {k: torch.from_numpy(v) for k, v in
                             batch.items()}, 5, engine.MezoConfig(**cfg))
    np.testing.assert_allclose(aux.gs.numpy(), np.asarray(jaux.gs), rtol=0,
                               atol=GS_ATOL)
    _assert_equal(state.params, _flat(jstate.params),
                  atol=cfg["lr"] * GS_ATOL)
    for path, leaf in state.params.items():
        if quant.is_quantized(leaf):
            np.testing.assert_array_equal(leaf.q.numpy(), init[path + "/q"])


@pytest.mark.parametrize("rule", ["sgd", "momentum"])
def test_int8_update_rules_fold_weight_decay_like_jax(rule):
    """The same (seed, gs) through sgd / momentum with weight decay: the
    decay folds into the deltas (``delta (1 - c) - c q s``), q and the
    scales stay frozen, and the result is the JAX package's."""
    init = _int8_init()
    cfg = dict(eps=1e-3, lr=1e-2, n_directions=2, weight_decay=0.1,
               momentum=0.9, momentum_window=3)
    gs = np.array([0.75, -1.25], np.float32)
    jrule = jengine.build_strategy("walk", rule).update
    jp, jopt = _jax_tree(init), jrule.init_fn(JMezoConfig(**cfg))
    trule = engine.update_rule(rule)
    tp, topt = _tensors(init), trule.init_fn(engine.MezoConfig(**cfg))
    for step in range(2):
        jp, jopt = jrule.update_fn(jp, jopt, np.uint32(17 + step), gs, None,
                                   JMezoConfig(**cfg))
        tp, topt = trule.update_fn(tp, topt, 17 + step, gs, None,
                                   engine.MezoConfig(**cfg))
    _assert_equal(tp, _flat(jp))
    for path, leaf in tp.items():
        if quant.is_quantized(leaf):
            np.testing.assert_array_equal(leaf.scale.numpy(),
                                          init[path + "/scale"])


def test_trainer_quant_errors_mirror_jax():
    cfg = get_config("opt-1.3b").reduced()
    with pytest.raises(ValueError, match=r"int4.*none.*int8"):
        Trainer(cfg, TrainerConfig(quant="int4", device="cpu"), iter(()))
    with pytest.raises(ValueError, match="frozen"):
        Trainer(cfg, TrainerConfig(optimizer="adam", quant="int8",
                                   device="cpu"), iter(()))
    # the gradient baseline without int8 builds; with an estimator it
    # raises the JAX package's ValueError
    assert Trainer(cfg, TrainerConfig(optimizer="adam", device="cpu"),
                   iter(())).strategy is None
    with pytest.raises(ValueError, match="adam"):
        Trainer(cfg, TrainerConfig(optimizer="adam", estimator="fused",
                                   device="cpu"), iter(()))


def test_trainer_quantizes_its_own_init_with_deltas():
    cfg = get_config("opt-1.3b").reduced()
    tr = Trainer(cfg, TrainerConfig(optimizer="mezo-fused", quant="int8",
                                    n_steps=1, device="cpu"),
                 jsyn.lm_batches(2, 16, cfg.vocab, seed=1),
                 log_fn=lambda s: None)
    params = tr.train()
    leaves = [v for v in params.values() if quant.is_quantized(v)]
    assert len(leaves) == 9 and all(v.delta is not None for v in leaves)


# ---------------------------------------------------------------------------
# serving over an int8 base


def _records(n, seed, k=2, lr=5e-2):
    rng = np.random.default_rng(seed)
    return [{"step": i, "seed": int(rng.integers(2**31)),
             "gs": rng.normal(size=k).astype(np.float32).tolist(),
             "lr": lr, "eps": 1e-2} for i in range(n)]


def _frozen_base():
    """(JAX frozen int8 base, port frozen int8 base): the same tree."""
    jparams = j_build_model(j_get_config("opt-1.3b").reduced()).init(
        jax.random.PRNGKey(0))
    jbase = jq.quantize_tree(jparams)
    return jbase, store.params_from_numpy(_flat(jbase), "cpu", _dtypes())


def test_adapter_replay_onto_int8_base_matches_jax():
    jbase, tbase = _frozen_base()
    recs = _records(3, seed=4)
    jst = JAdapterStore(jbase)
    jst.put("u", recs)
    st = AdapterStore(tbase, device="cpu")
    st.put("u", recs)
    mat = st.materialize("u")
    _assert_equal(mat, _flat(jst.materialize("u")))
    # the int8 values and scales are shared with the base, not copied
    assert all(mat[k].q is tbase[k].q for k in tbase
               if quant.is_quantized(tbase[k]))
    assert st.cached_bytes() == sum(
        v.delta.numel() * 4 if quant.is_quantized(v) else
        v.numel() * v.element_size() for v in mat.values())
    params, opt, n = st.materialize_state("u")
    assert n == 3 and opt == {}
    _assert_equal(params, _flat(jst.materialize_state("u")[0]))


def test_int8_delta_form_matches_jax_and_files_cross(tmp_path):
    jbase, tbase = _frozen_base()
    recs = _records(3, seed=5)
    jst = JAdapterStore(jbase)
    jst.put("u", recs)
    st = AdapterStore(tbase, device="cpu")
    st.put("u", recs)
    jdelta = jst.export_delta("u")
    tdelta = st.export_delta("u")
    assert len(tdelta) == len(jdelta)
    for (tq, ts), (jqv, js) in zip(tdelta, jdelta):
        np.testing.assert_array_equal(tq.numpy(), jqv)
        assert ts == js
    # applied: the compact user's effective weights equal JAX's
    st.put_delta("c", tdelta)
    jst.put_delta("c", jdelta)
    _assert_equal(st.materialize("c"), _flat(jst.materialize("c")))
    with pytest.raises(ValueError, match="lossy"):
        st.materialize_state("c")
    # within one int8 step of the replayed user, leaf by leaf
    mat, approx = st.materialize("u"), st.materialize("c")
    for k, b in tbase.items():
        eff = (lambda x: x.dequantize_f32() if quant.is_quantized(x)
               else x.float())
        d = (eff(mat[k]) - eff(b)).abs().max().item()
        torch.testing.assert_close(eff(approx[k]), eff(mat[k]), rtol=0,
                                   atol=d / 127.0 + 1e-7)
    # the port's delta file loads in JAX, and JAX's in the port
    st.save_delta("u", str(tmp_path / "t"))
    jst.save_delta("u", str(tmp_path / "j"))
    jst.load_delta("from_t", str(tmp_path / "t"))
    st.load_delta("from_j", str(tmp_path / "j.npz"))
    _assert_equal(st.materialize("from_j"),
                  _flat(jst.materialize("from_t")))


def test_serve_engines_over_int8_base_emit_identical_greedy_tokens():
    """Paged, chunked serving of two replayed users and the base from one
    int8 base: the port's greedy tokens are the JAX engine's; inside the
    port, dense mode gives the same tokens."""
    jbase, tbase = _frozen_base()
    cfg = get_config("opt-1.3b").reduced()
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, cfg.vocab, n, dtype=np.int32), user)
            for n, user in zip((7, 5, 9, 6), ("alice", "bob", None,
                                              "alice"))]
    js = JAdapterStore(jbase)
    st = AdapterStore(tbase, device="cpu")
    for user, seed in (("alice", 1), ("bob", 2)):
        js.put(user, _records(3, seed=seed))
        st.put(user, _records(3, seed=seed))
    jeng = JServeEngine(j_get_config("opt-1.3b").reduced(), js, n_slots=2,
                        max_len=16, seed=0, paged=True, page_size=4,
                        prefill_chunk=4)

    def port(**kw):
        eng = ServeEngine(cfg, st, n_slots=2, max_len=16, seed=0,
                          device="cpu", **kw)
        for prompt, user in reqs:
            eng.submit(Request(prompt=prompt, max_new=5, user=user))
        return [c.tokens.tolist() for c in eng.run()]

    for prompt, user in reqs:
        jeng.submit(JRequest(prompt=prompt, max_new=5, user=user))
    want = [c.tokens.tolist() for c in jeng.run()]
    assert port(paged=True, page_size=4, prefill_chunk=4) == want
    assert port() == want

"""Port parity: the multi-tenant TrainEngine and the ``train_fleet`` CLI.

On reduced OPT-1.3B, full-precision and int8 arms:
  * the port's ``launch.train_fleet`` against ``repro.launch.train_fleet``
    with the same argv from the same (JAX) init: per-user losses within
    1e-5, gs within 1e-3, the same seeds, steps, lr and eps;
  * every lane of the port's engine bit for bit a lone port ``Trainer``
    with the derived seed: losses, parameters or deltas, and the bytes of
    the replay log;
  * replay logs crossing both ways: each package's log replayed by the
    other equals the writer's own replay at atol 0;
  * the port's counterparts of ``tests/test_train_engine.py``'s slot-table
    and guardrail tests (staggered admission, eviction and resume, crash
    recovery, duplicate users, seed collision, walk rejected, rule
    mismatch, a met target, a delta-only user, the one-call wrapper);
  * ``step_users`` with vmapdir and with momentum (and weight decay):
    lanes bit for bit lone steps, inactive lanes bit-frozen.
"""

import functools
import json
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (repro.optim.quant needs it first)
from repro.checkpoint.replay_log import ReplayLog as JReplayLog  # noqa
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import MezoConfig as JMezoConfig  # noqa: E402
from repro.core.perturb import _path_str  # noqa: E402
from repro.launch import train_fleet as j_fleet  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim import quant as jq  # noqa: E402
from repro.serve.adapters import AdapterStore as JAdapterStore  # noqa: E402
from repro_torch.checkpoint import ReplayLog, store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import rng as zrng  # noqa: E402
from repro_torch.core.batching import stack_users, take_user  # noqa: E402
from repro_torch.core.engine import MezoConfig, build_strategy  # noqa: E402
from repro_torch.launch import train_fleet  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import quant  # noqa: E402
from repro_torch.runtime import (Trainer, TrainerConfig,  # noqa: E402
                                 train_multi_tenant)
from repro_torch.serve import AdapterStore  # noqa: E402
from repro_torch.train import (TrainEngine, TrainJob,  # noqa: E402
                               derive_user_seed)

torch.set_num_threads(1)

LOSS_ATOL = 1e-5
GS_ATOL = 1e-3
SEED, USERS, STEPS, B, S = 7, 4, 2, 2, 8
ARGV = ["--arch", "opt-1.3b", "--reduced", "--users", str(USERS),
        "--slots", "3", "--steps", str(STEPS), "--batch", str(B), "--seq",
        str(S), "--directions", "2", "--lr", "1e-3", "--seed", str(SEED)]
MZ = MezoConfig(eps=1e-3, lr=1e-3, n_directions=2)
ENGINE_SEED = 7


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.array(v) for p, v in leaves}


def _cfgs():
    """The CLI's config (reduced, max_seq >= --seq) in both packages."""
    import dataclasses
    j, t = j_get_config("opt-1.3b").reduced(), get_config("opt-1.3b").reduced()
    return (dataclasses.replace(j, max_seq=max(j.max_seq, S)),
            dataclasses.replace(t, max_seq=max(t.max_seq, S)))


@functools.lru_cache(maxsize=None)
def _jax_init():
    """The JAX CLI's init (PRNGKey(--seed)) as flat numpy arrays."""
    return _flat(j_build_model(_cfgs()[0]).init(jax.random.PRNGKey(SEED)))


def _base(q="none"):
    params = store.params_from_numpy(_jax_init(), "cpu")
    return quant.quantize_tree(params, with_delta=True) if q == "int8" \
        else params


def _jax_base(q="none"):
    p = j_build_model(_cfgs()[0]).init(jax.random.PRNGKey(SEED))
    return jq.quantize_tree(p, with_delta=True) if q == "int8" else p


def _port_flat(params):
    return store.params_to_numpy(params)


@pytest.fixture(scope="module")
def fleet_runs(tmp_path_factory):
    """Both CLIs, full-precision and int8, each with a --log-dir."""
    out = {}
    for q in ("none", "int8"):
        root = tmp_path_factory.mktemp(f"fleet-{q}")
        argv = ARGV + ["--quant", q]
        with mock.patch.object(sys, "argv", ["train_fleet", *argv,
                                             "--log-dir", str(root / "jax"),
                                             "--out",
                                             str(root / "jax.json")]):
            j_fleet.main()
        engine, results = train_fleet.run(
            argv + ["--device", "cpu", "--log-dir", str(root / "torch"),
                    "--out", str(root / "torch.json")], params=_base())
        out[q] = dict(root=root, engine=engine,
                      results={r.user: r for r in results},
                      jax=json.load(open(root / "jax.json")),
                      torch=json.load(open(root / "torch.json")))
    return out


@pytest.mark.parametrize("q", ["none", "int8"])
def test_fleet_cli_matches_jax(fleet_runs, q):
    run = fleet_runs[q]
    jout, tout = run["jax"], run["torch"]
    assert {k: v for k, v in tout.items() if k not in ("losses",
                                                       "user_steps_per_s")} \
        == {k: v for k, v in jout.items() if k not in ("losses",
                                                       "user_steps_per_s")}
    assert tout["dispatches"] == 4    # 3 users, then the 4th admitted
    for user, want in jout["losses"].items():
        np.testing.assert_allclose(tout["losses"][user], want, rtol=0,
                                   atol=LOSS_ATOL, err_msg=user)
        jrec = JReplayLog.read(str(run["root"] / "jax" / f"{user}.jsonl"))
        trec = ReplayLog.read(str(run["root"] / "torch" / f"{user}.jsonl"))
        for key in ("step", "seed", "lr", "eps"):
            assert [r[key] for r in trec] == [r[key] for r in jrec], key
        np.testing.assert_allclose([r["gs"] for r in trec],
                                   [r["gs"] for r in jrec], rtol=0,
                                   atol=GS_ATOL, err_msg=user)


@pytest.mark.parametrize("q", ["none", "int8"])
def test_engine_lanes_bit_equal_lone_trainers(fleet_runs, q, tmp_path):
    """Each user of the CLI's engine against a lone port Trainer with the
    derived seed: losses, final parameters (deltas) and replay-log bytes
    at atol 0."""
    run = fleet_runs[q]
    tcfg = _cfgs()[1]
    mz = MezoConfig(eps=1e-3, lr=1e-3, n_directions=2)
    for i in range(USERS):
        user = f"user-{i}"
        fn = train_fleet.user_batches(tcfg, user, B, S, SEED)
        tr = Trainer(tcfg, TrainerConfig(
            estimator="fused", update="sgd", mezo=mz, quant=q,
            n_steps=STEPS, seed=derive_user_seed(SEED, user),
            ckpt_dir=str(tmp_path / user), snapshot_every=10 ** 6,
            log_every=10 ** 6, device="cpu"),
            iter([fn(t) for t in range(STEPS)]), log_fn=lambda s: None)
        final = tr.train(params=_base())
        assert run["results"][user].losses == tr.losses, user
        got = run["engine"].store.materialize(user)
        for path, leaf in final.items():
            a = leaf.delta if quant.is_quantized(leaf) else leaf
            b = got[path].delta if quant.is_quantized(leaf) else got[path]
            assert torch.equal(a, b), (user, path)
        assert (run["root"] / "torch" / f"{user}.jsonl").read_bytes() == \
            (tmp_path / user / "replay.jsonl").read_bytes(), user


@pytest.mark.parametrize("q", ["none", "int8"])
def test_replay_logs_cross_packages(fleet_runs, q):
    run = fleet_runs[q]
    user = "user-1"
    jlog = str(run["root"] / "jax" / f"{user}.jsonl")
    tlog = str(run["root"] / "torch" / f"{user}.jsonl")
    jcfg = JMezoConfig(eps=1e-3, lr=1e-3, n_directions=2)
    # the JAX log: the port's replay == the JAX package's own
    jstore = JAdapterStore(_jax_base(q), mezo_cfg=jcfg)
    jstore.load(user, jlog)
    tstore = AdapterStore(_base(q), mezo_cfg=MZ, device="cpu")
    tstore.load(user, jlog)
    want, got = _flat(jstore.materialize(user)), _port_flat(
        tstore.materialize(user))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's log: the JAX package's replay == the port engine's state
    jstore.load("t", tlog)
    want = _port_flat(run["engine"].store.materialize(user))
    got = _flat(jstore.materialize("t"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the slot table (port-only scenarios, a seeded port init)


@functools.lru_cache(maxsize=None)
def _cfg():
    return get_config("opt-1.3b").reduced()


@functools.lru_cache(maxsize=None)
def _init():
    return build_model(_cfg()).init(torch.Generator().manual_seed(0), "cpu")


def _fresh():
    return {k: v.clone() for k, v in _init().items()}


def _batches(user, n):
    salt = zrng.leaf_salt(user)
    out = []
    for step in range(n):
        rng = np.random.default_rng((salt, step))
        toks = rng.integers(0, _cfg().vocab, (B, S + 1), dtype=np.int32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:],
                    "loss_mask": np.ones((B, S), np.float32)})
    return out


def _lone(user, n, mz=MZ, estimator="fused", update="sgd"):
    """A lone sequential run of ``user``'s first n steps."""
    model = build_model(_cfg())
    strat = build_strategy(estimator, update)
    st = strat.init_state(_fresh(), mz)
    us = derive_user_seed(ENGINE_SEED, user)
    losses = []
    for t, b in enumerate(_batches(user, n)):
        st, aux = strat.step(model.loss, st,
                             {k: torch.from_numpy(v) for k, v in b.items()},
                             zrng.fold_seed(us, t), mz)
        losses.append(float(aux.loss))
    return st.params, losses


def _assert_params_equal(a, b, what=""):
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}{k}"


def _engine(n_slots, mz=MZ, **kw):
    st = AdapterStore(_fresh(), mezo_cfg=mz, device="cpu",
                      update_rule=build_strategy(
                          "fused", kw.get("update", "sgd")).update)
    return TrainEngine(_cfg(), st, n_slots=n_slots, seed=ENGINE_SEED,
                       mezo_cfg=mz, **kw), st


def test_staggered_admission_ragged_targets():
    targets = {"u0": 2, "u1": 3, "u2": 1, "u3": 2}
    eng, st = _engine(2)
    for u, n in targets.items():
        eng.submit(TrainJob(user=u, batches=_batches(u, n), n_steps=n))
    results = {r.user: r for r in eng.run()}
    assert eng.stats.finished == len(targets)
    assert eng.stats.user_steps == sum(targets.values())
    for u, n in targets.items():
        params, losses = _lone(u, n)
        assert results[u].losses == losses, u
        _assert_params_equal(st.materialize(u), params, f"{u}:")


def test_mid_flight_eviction_then_resume_bit_exact():
    T = 4
    eng, st = _engine(1)
    eng.submit(TrainJob(user="ua", batches=_batches("ua", T), n_steps=T))
    eng.step()
    eng.step()
    res = eng.evict("ua")
    assert res.evicted and res.n_steps == 2 and len(res.records) == 2
    eng.submit(TrainJob(user="ub", batches=_batches("ub", 2), n_steps=2))
    eng.submit(TrainJob(user="ua", batches=_batches("ua", T), n_steps=T))
    results = {(r.user, r.jid): r for r in eng.run()}
    resumed = results[("ua", 2)]
    assert resumed.start_step == 2 and resumed.n_steps == T
    assert len(resumed.records) == T
    params, losses = _lone("ua", T)
    assert res.losses + resumed.losses == losses
    _assert_params_equal(st.materialize("ua"), params, "ua:")


def test_crash_recovery_from_replay_log(tmp_path):
    T, log_dir = 4, str(tmp_path / "logs")
    eng1, _ = _engine(1, log_dir=log_dir)
    eng1.submit(TrainJob(user="u", batches=_batches("u", T), n_steps=T))
    eng1.step()
    eng1.step()
    eng1.evict("u")
    del eng1                               # "crash": only the log survives
    eng2, st2 = _engine(1, log_dir=log_dir)
    st2.load("u", str(tmp_path / "logs" / "u.jsonl"))
    assert len(st2.records("u")) == 2
    eng2.submit(TrainJob(user="u", batches=_batches("u", T), n_steps=T))
    (res,) = eng2.run()
    assert res.start_step == 2 and res.n_steps == T
    params, _ = _lone("u", T)
    _assert_params_equal(st2.materialize("u"), params, "u:")
    assert [r["step"] for r in ReplayLog.read(
        str(tmp_path / "logs" / "u.jsonl"))] == list(range(T))


def test_duplicate_user_stays_queued():
    eng, _ = _engine(4)
    eng.submit(TrainJob(user="u", batches=_batches("u", 2), n_steps=2))
    eng.submit(TrainJob(user="u", batches=_batches("u", 3), n_steps=3))
    results = eng.run()
    assert [(r.jid, r.start_step, r.n_steps) for r in results] == \
        [(0, 0, 2), (1, 2, 3)]


def test_seed_collision_raises():
    eng, _ = _engine(2)
    eng.submit(TrainJob(user="a", batches=_batches("a", 2), n_steps=2,
                        seed=123))
    eng.submit(TrainJob(user="b", batches=_batches("b", 2), n_steps=2,
                        seed=123))
    with pytest.raises(ValueError, match="seed collision"):
        eng.run()


def test_walk_estimator_and_rule_mismatch_rejected():
    st = AdapterStore(_fresh(), mezo_cfg=MZ, device="cpu")    # sgd store
    with pytest.raises(ValueError, match="pristine"):
        TrainEngine(_cfg(), st, estimator="walk")
    with pytest.raises(ValueError, match="update rule"):
        TrainEngine(_cfg(), st, update="momentum")
    with pytest.raises(ValueError, match="pristine"):
        build_strategy("walk", "sgd").step_users(None, None, None, [1], MZ)


def test_target_already_met_finishes_without_steps():
    eng, _ = _engine(1)
    eng.submit(TrainJob(user="u", batches=_batches("u", 2), n_steps=2))
    eng.run()
    eng.submit(TrainJob(user="u", batches=_batches("u", 2), n_steps=2))
    (res,) = eng.run()
    assert res.start_step == 2 and res.n_steps == 2 and res.losses == []


def test_delta_only_user_not_resumable():
    st = AdapterStore(_fresh(), mezo_cfg=MZ, device="cpu")
    st.put_delta("u", [])
    with pytest.raises(ValueError, match="lossy"):
        st.materialize_state("u")


def test_train_multi_tenant_wrapper():
    jobs = [TrainJob(user=f"u{i}", batches=_batches(f"u{i}", 2), n_steps=2)
            for i in range(3)]
    engine, results = train_multi_tenant(
        _cfg(), jobs, n_slots=2, seed=ENGINE_SEED, mezo_cfg=MZ,
        quant="int8", log_fn=lambda s: None, device="cpu", params=_fresh())
    assert engine.stats.finished == 3
    assert sorted(r.user for r in results) == ["u0", "u1", "u2"]
    assert all(len(r.losses) == 2 for r in results)
    assert all(quant.is_quantized(v) for k, v in engine.store.base.items()
               if k.endswith("/w"))


@pytest.mark.parametrize("estimator,update", [("vmapdir", "sgd"),
                                              ("fused", "momentum")])
def test_step_users_lanes_match_lone_steps_inactive_frozen(estimator,
                                                           update):
    """step_users with per-lane eps and lr, weight decay, and an inactive
    lane: active lanes bit for bit lone steps, the inactive one keeps its
    bits (parameters, step, rule state)."""
    mz = MezoConfig(eps=1e-3, lr=1e-3, n_directions=2, momentum=0.9,
                    momentum_window=3, weight_decay=0.01)
    model = build_model(_cfg())
    strat = build_strategy(estimator, update)
    users = ["a", "b", "c"]
    eps = torch.tensor([1e-3, 2e-3, 5e-4])
    lr = torch.tensor([1e-3, 3e-3, 2e-3])
    active = [True, False, True]
    states = [strat.init_state(_fresh(), mz) for _ in users]
    stacked = stack_users(states)
    frozen = {k: v.clone() for k, v in take_user(stacked.params, 1).items()}
    for t in range(2):
        batch = {k: torch.from_numpy(np.stack([_batches(u, 2)[t][k]
                                               for u in users]))
                 for k in ("tokens", "targets", "loss_mask")}
        seeds = [zrng.fold_seed(derive_user_seed(ENGINE_SEED, u), t)
                 for u in users]
        stacked, aux = strat.step_users(model.loss, stacked, batch, seeds,
                                        mz, active, eps=eps, lr=lr)
        for i, u in enumerate(users):
            if not active[i]:
                continue
            lone = MezoConfig(**{**mz.__dict__, "eps": float(eps[i]),
                                 "lr": float(lr[i])})
            states[i], laux = strat.step(
                model.loss, states[i],
                {k: v[i] for k, v in batch.items()}, seeds[i], lone)
            assert aux.loss[i].item() == laux.loss.item(), (u, t)
            assert torch.equal(aux.gs[i], laux.gs), (u, t)
    assert stacked.step.tolist() == [2, 0, 2]
    _assert_params_equal(take_user(stacked.params, 1), frozen, "b:")
    for i in (0, 2):
        _assert_params_equal(take_user(stacked.params, i), states[i].params,
                             f"{users[i]}:")
        for k, v in states[i].opt.items():
            assert torch.equal(stacked.opt[k][i], v), k
    for k, v in stacked.opt.items():
        assert not v[1].any(), k          # the inactive lane's window

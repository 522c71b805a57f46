"""Port parity: ``runtime/stragglers.py`` and the trainer's straggler arm.

Across packages:
  * ``StragglerPolicy`` equals the reference's on the same latency
    sequences: masks (with and without a slow set), deadlines, EMA
    latencies, and the shape error;
  * the train CLI with ``--straggler-redundancy 1 --directions 2`` gives
    JAX's losses (within 1e-5) and gs (within 1e-3) from JAX's initial
    parameters, and logs JAX's masks;
  * a checkpoint resume over a log whose records carry masks and
    staleness: the port restores the live parameters at atol 0, through
    a bare-params snapshot (as JAX's manager does, bit for bit) and
    through a TrainState snapshot (the stale-sgd coefficients; the
    reference's manager replays a TrainState's log tail through the
    rule without ``staleness`` and misses them -- open in the
    reference).
Inside the port: counterparts of the reference's straggler tests
(``tests/test_trainer.py``, ``tests/test_fleet.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (import order: repro.optim needs it)
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint import replay_log as j_replay_log  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core.perturb import _path_str  # noqa: E402
from repro.launch import train as j_train_cli  # noqa: E402
from repro.runtime.stragglers import \
    StragglerPolicy as JPolicy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, store  # noqa: E402
from repro_torch.checkpoint.replay_log import (ReplayLog,  # noqa: E402
                                               replay_into)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.engine import (MezoConfig, STALE_SGD,  # noqa: E402
                                     TrainState)
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.runtime import (StragglerPolicy, Trainer,  # noqa: E402
                                 TrainerConfig)

torch.set_num_threads(1)

LOSS_ATOL = 1e-5
GS_ATOL = 1e-3


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.array(v) for p, v in leaves}


def _same_policy(t, j):
    assert t.seen == j.seen
    np.testing.assert_array_equal(t.ema_latencies, j.ema_latencies)
    assert t.deadline() == j.deadline()
    for slow in (None, [0], [t.total - 1], list(range(t.total))):
        np.testing.assert_array_equal(t.mask(slow), j.mask(slow))


@pytest.mark.parametrize("k,r,factor,ema", [(4, 2, 3.0, 0.9),
                                            (2, 0, 1.5, 0.5),
                                            (1, 3, 2.0, 0.0)])
def test_policy_equals_jax_on_latency_sequences(k, r, factor, ema):
    t = StragglerPolicy(k, r, deadline_factor=factor, ema=ema)
    j = JPolicy(k, r, deadline_factor=factor, ema=ema)
    _same_policy(t, j)
    rng = np.random.default_rng(k * 10 + r)
    for _ in range(12):
        lat = rng.lognormal(0.0, 1.0, k + r)
        lat[rng.integers(0, k + r)] *= 20.0        # a straggler
        t.observe(lat)
        j.observe(lat)
        _same_policy(t, j)
    for bad in ([1.0], np.ones(k + r + 1)):
        with pytest.raises(ValueError) as te:
            t.observe(bad)
        with pytest.raises(ValueError) as je:
            j.observe(bad)
        assert str(te.value) == str(je.value)


def test_straggler_policy_masks():
    pol = StragglerPolicy(n_directions=4, redundancy=2)
    m = pol.mask()
    assert m.shape == (6,)
    assert m.sum() == 6  # no latency info yet -> keep all
    pol.observe([1, 1, 1, 1, 1, 50.0])
    m = pol.mask()
    assert m[5] == 0          # slow direction dropped
    assert m.sum() <= 4       # fastest-K selection
    m2 = pol.mask(slow=[0])
    assert m2[0] == 0


def test_straggler_observe_shape_error_names_expectation():
    pol = StragglerPolicy(n_directions=4, redundancy=2)
    with pytest.raises(ValueError, match=r"\(6,\)"):
        pol.observe([1.0, 2.0])


def test_straggler_deadline_inf_until_seen_then_median_scaled():
    pol = StragglerPolicy(n_directions=4, deadline_factor=3.0)
    assert pol.deadline() == float("inf")
    pol.observe([1.0, 1.0, 2.0, 4.0])
    assert pol.deadline() == pytest.approx(3.0 * 1.5)
    vec = pol.ema_latencies
    vec[0] = 10.0
    pol.observe(vec)
    np.testing.assert_allclose(pol.ema_latencies[1:], [1.0, 2.0, 4.0])


def test_straggler_trainer_arm():
    cfg = get_config("qwen3-4b").reduced()
    tc = TrainerConfig(optimizer="mezo-parallel",
                       mezo=MezoConfig(eps=1e-2, lr=1e-2, n_directions=2),
                       n_steps=3, straggler_redundancy=2, log_every=100,
                       device="cpu")
    tr = Trainer(cfg, tc, lm_batches(4, 16, cfg.vocab, seed=3),
                 log_fn=lambda s: None)
    tr.train()
    assert len(tr.losses) == 3


def test_cli_straggler_arm_matches_jax(tmp_path):
    argv = ["--arch", "opt-1.3b", "--reduced", "--optimizer", "mezo-fused",
            "--steps", "3", "--batch", "2", "--seq", "16", "--lr", "1e-3",
            "--directions", "2", "--straggler-redundancy", "1",
            "--log-every", "1"]
    jtr = j_train_cli.make_trainer(j_train_cli.build_argparser().parse_args(
        argv + ["--ckpt-dir", str(tmp_path / "jax")]))
    jinit = jtr.init_params()
    init = _flat(jinit)
    jtr.train(jax.tree.map(jnp.copy, jinit))
    ttr = train_cli.run(argv + ["--device", "cpu", "--ckpt-dir",
                                str(tmp_path / "torch")],
                        params=store.params_from_numpy(init, "cpu"))
    np.testing.assert_allclose(ttr.losses, jtr.losses, rtol=0,
                               atol=LOSS_ATOL)
    trec = ReplayLog.read(str(tmp_path / "torch" / "replay.jsonl"))
    jrec = j_replay_log.ReplayLog.read(str(tmp_path / "jax" /
                                           "replay.jsonl"))
    assert [r["mask"] for r in trec] == [r["mask"] for r in jrec]
    assert all(len(r["gs"]) == 3 and len(r["mask"]) == 3 for r in trec)
    np.testing.assert_allclose([r["gs"] for r in trec],
                               [r["gs"] for r in jrec], rtol=0,
                               atol=GS_ATOL)


# ---------------------------------------------------------------------------
# resume over a log with masks and staleness

MZ = MezoConfig(eps=1e-3, lr=2e-2, n_directions=3, staleness_decay=0.8)
JMZ = jengine.MezoConfig(eps=1e-3, lr=2e-2, n_directions=3,
                         staleness_decay=0.8)
MASK = [1.0, 0.0, 1.0]
RECORDS = [dict(step=0, seed=11, gs=[0.5, -1.0, 0.25], mask=MASK),
           dict(step=1, seed=12, gs=[-0.75, 0.5, 1.5], staleness=2,
                mask=MASK),
           dict(step=2, seed=13, gs=[0.125, 0.5, -0.5]),
           dict(step=3, seed=14, gs=[1.0, -0.25, 0.75], staleness=5)]


def _theta0():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "b": rng.standard_normal((8,)).astype(np.float32)}


def _write_log(path):
    log = ReplayLog(str(path), fsync=False)
    for r in RECORDS:
        log.append(r["step"], r["seed"], r["gs"], MZ.lr, MZ.eps,
                   mask=r.get("mask"), staleness=r.get("staleness"))
    log.close()


def test_manager_resume_over_masks_and_staleness_is_bit_exact(tmp_path):
    recs = [dict(r, lr=MZ.lr, eps=MZ.eps) for r in RECORDS]
    theta0 = {k: torch.from_numpy(v) for k, v in _theta0().items()}
    live, _ = replay_into(theta0, recs, MZ)     # the fleet's live apply
    after0, _ = replay_into(theta0, recs[:1], MZ)

    # a bare-params snapshot at step 0, the log tail 1..3 (JAX's manager
    # restores the same dir the same way, bit for bit)
    bare = tmp_path / "bare"
    CheckpointManager(str(bare), mezo_cfg=MZ).on_step(0, after0)
    _write_log(bare / "replay.jsonl")
    got, nxt = CheckpointManager(str(bare), mezo_cfg=MZ).restore(
        {k: torch.zeros_like(v) for k, v in theta0.items()})
    assert nxt == 4
    for k in live:
        assert torch.equal(got[k], live[k]), k
    jgot, jnxt = JManager(str(bare), mezo_cfg=JMZ).restore(
        {k: jnp.zeros(v.shape, v.dtype) for k, v in _theta0().items()})
    assert jnxt == 4
    for k in live:
        np.testing.assert_array_equal(np.asarray(jgot[k]), live[k].numpy())

    # a TrainState snapshot: the rule's in-place replay of the tail
    full = tmp_path / "state"
    CheckpointManager(str(full), mezo_cfg=MZ, update_rule=STALE_SGD).on_step(
        0, TrainState(params=after0, step=1, opt={}))
    _write_log(full / "replay.jsonl")
    like = TrainState(params={k: torch.zeros_like(v)
                              for k, v in theta0.items()}, step=0, opt={})
    state, nxt = CheckpointManager(str(full), mezo_cfg=MZ,
                                   update_rule=STALE_SGD).restore(like)
    assert nxt == 4 and state.step == 4
    for k in live:
        assert torch.equal(state.params[k], live[k]), k
    # the reference's TrainState path drops the staleness decay
    jlike = jengine.TrainState(
        params={k: jnp.zeros(v.shape, v.dtype)
                for k, v in _theta0().items()},
        step=jnp.uint32(0), opt={})
    jstate, _ = JManager(str(full), mezo_cfg=JMZ,
                         update_rule=jengine.STALE_SGD).restore(jlike)
    assert max(float(np.abs(np.asarray(jstate.params[k])
                            - live[k].numpy()).max()) for k in live) > 0.0


def test_staleness_record_refused_by_a_stateful_rule():
    from repro_torch.checkpoint.replay_log import apply_record
    from repro_torch.core.engine import MOMENTUM
    cfg = dataclasses.replace(MZ, momentum=0.9)
    params = {"w": torch.zeros(4)}
    rec = dict(RECORDS[1], lr=MZ.lr, eps=MZ.eps)
    with pytest.raises(ValueError, match="staleness"):
        apply_record(MOMENTUM, params, MOMENTUM.init_fn(cfg), rec, cfg)

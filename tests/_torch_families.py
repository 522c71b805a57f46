"""Shared set-up of the port's family parity tests (``test_torch_moe``,
``test_torch_rwkv``, ``test_torch_hybrid``, ``test_torch_encdec``,
``test_torch_dense_configs``, and the multi-tenant ``test_torch_user_axis``
and ``test_torch_user_axis_scans``).

Every case is a ``reduced()`` f32 config, built by both packages, with
the JAX package's initial parameters (``PRNGKey(0)``) carried across
through ``store.params_from_numpy``; inputs come from numpy seeds. The
reference is the JAX package run live, never the golden pins.
"""

import dataclasses
import functools
import json
import sys
import zlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint import replay_log as j_replay_log
from repro.configs import get_config as j_get_config
from repro.core import MezoConfig as JMezoConfig
from repro.core.perturb import _path_str
from repro.core.perturb_ctx import PerturbCtx as JPerturbCtx
from repro.data.synthetic import lm_batches as j_lm_batches
from repro.launch import train as j_train_cli
from repro.launch import train_fleet as j_fleet_cli
from repro.models import build_model as j_build_model
from repro.optim import quant as jq
from repro.serve import AdapterStore as JAdapterStore
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.checkpoint import ReplayLog, replay_into, store
from repro_torch.configs import get_config
from repro_torch.core import MezoConfig, PerturbCtx
from repro_torch.launch import train as train_cli
from repro_torch.launch import train_fleet as fleet_cli
from repro_torch.models import build_model
from repro_torch.models.transformer import param_shapes
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.serve import AdapterStore, Request, ServeEngine
from repro_torch.train import derive_user_seed

CPU = "cpu"
ATOL = 1e-5          # logits (scaled by max|logit|), aux and losses
GS_ATOL = 1e-3       # the CLI's logged gs (a loss gap of 1e-6 at eps 1e-3)
SEED, EPS = 9, np.float32(1e-3)
# serving: staggered prompts, more requests than slots (mid-flight
# admission into recycled slots and pages), a user beside the base
PLENS, GEN = (5, 9, 7, 12), 6
USERS = (None, "u", None, "u")
MODES = {"dense": {}, "paged": {"paged": True, "page_size": 4},
         "chunked": {"paged": True, "page_size": 4, "prefill_chunk": 3},
         "spec": {"paged": True, "page_size": 4, "spec_k": 3}}


def flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.array(v) for p, v in leaves}


def configs(arch, **over):
    """(JAX cfg, port cfg): ``reduced(**over)`` of both packages'."""
    return (j_get_config(arch).reduced(**over),
            get_config(arch).reduced(**over))


@functools.lru_cache(maxsize=None)
def case(arch, quant=False, **over):
    """(JAX model, JAX params, port model, port params) of reduced
    ``arch`` from the JAX init; ``quant``: the JAX package's int8 base
    of it, with zero deltas (a tree that trains)."""
    jcfg, cfg = configs(arch, **over)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    dtypes = None
    if quant:
        jparams = jq.quantize_tree(jparams, with_delta=True)
        dtypes = {p: spec[1] for p, spec in param_shapes(cfg).items()}
    return (jmodel, jparams, build_model(cfg),
            store.params_from_numpy(flat(jparams), CPU, dtypes))


def batch(cfg, bsz=2, seq=8, seed=1):
    """One numpy LM batch, with the frontend stubs the config takes."""
    b = dict(next(j_lm_batches(bsz, seq, cfg.vocab, seed=seed)))
    rng = np.random.default_rng(seed + 2)
    if cfg.family == "encdec":
        b["enc_embeds"] = rng.standard_normal(
            (bsz, cfg.enc_len, cfg.d_model), dtype=np.float32)
    if cfg.num_patches:
        b["patch_embeds"] = rng.standard_normal(
            (bsz, cfg.num_patches, cfg.d_model), dtype=np.float32)
    return b


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def assert_forward_matches(arch, **over):
    """Forward logits within ATOL of max|logit| and aux within ATOL."""
    jmodel, jparams, model, params = case(arch, **over)
    b = batch(model.cfg)
    want, want_aux = jmodel.forward(jparams, to_jax(b))
    got, got_aux = model.forward(params, to_torch(b))
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL * scale)
    assert abs(float(got_aux) - float(want_aux)) <= ATOL
    return got


def fused_losses(arch, coeff, quant=False, **over):
    """(port, JAX) fused perturbed loss at ``coeff``."""
    jmodel, jparams, model, params = case(arch, quant, **over)
    b = batch(model.cfg)
    ctx = JPerturbCtx(seed=np.uint32(SEED), coeff=coeff)
    want = float(jax.jit(lambda p, x: jmodel.loss(p, x, perturb=ctx))(
        jparams, to_jax(b)))
    got = float(model.loss(params, to_torch(b),
                           perturb=PerturbCtx(seed=SEED, coeff=coeff)))
    return got, want


def cli_runs(arch, root, steps=3, extra=()):
    """Both train CLIs from the JAX init, ``mezo-fused``, each with a
    replay log: a dict of losses, logs, initial and final params."""
    argv = ["--arch", arch, "--reduced", "--optimizer", "mezo-fused",
            "--steps", str(steps), "--batch", "2", "--seq", "8", "--lr",
            "1e-3", "--log-every", "1", *extra]
    jtr = j_train_cli.make_trainer(j_train_cli.build_argparser().parse_args(
        argv + ["--ckpt-dir", str(root / "jax")]))
    jinit = jtr.init_params()
    init = flat(jinit)
    jfinal = flat(jtr.train(jax.tree.map(jnp.copy, jinit)))
    ttr = train_cli.run(argv + ["--device", CPU, "--ckpt-dir",
                                str(root / "torch")],
                        params=store.params_from_numpy(init, CPU))
    return dict(init=init, jax_init=jinit, jax_losses=jtr.losses,
                jax_final=jfinal, torch_losses=ttr.losses,
                torch_final={k: v.numpy() for k, v in ttr.params.items()},
                jax_log=str(root / "jax" / "replay.jsonl"),
                torch_log=str(root / "torch" / "replay.jsonl"))


def assert_cli_matches(run, steps=3):
    """Losses within ATOL and gs within GS_ATOL of the JAX CLI's, the same
    seeds; each package's replay log replays in the other onto the
    initial parameters to the other's final ones at atol 0."""
    assert len(run["torch_losses"]) == steps
    np.testing.assert_allclose(run["torch_losses"], run["jax_losses"],
                               rtol=0, atol=ATOL)
    jrec = j_replay_log.ReplayLog.read(run["jax_log"])
    trec = ReplayLog.read(run["torch_log"])
    assert [(r["step"], r["seed"]) for r in trec] == \
        [(r["step"], r["seed"]) for r in jrec]
    np.testing.assert_allclose([r["gs"] for r in trec],
                               [r["gs"] for r in jrec], rtol=0, atol=GS_ATOL)
    cfg = dict(lr=1e-3, eps=1e-3)
    got, _ = replay_into(store.params_from_numpy(run["init"], CPU), jrec,
                         MezoConfig(**cfg))
    for k, v in run["jax_final"].items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    want, _ = j_replay_log.replay_into(
        jax.tree.map(jnp.asarray, run["jax_init"]), trec, JMezoConfig(**cfg))
    for k, v in flat(want).items():
        np.testing.assert_array_equal(run["torch_final"][k], v, err_msg=k)


def _records(n, seed, k=2, lr=5e-2):
    rng = np.random.default_rng(seed)
    return [{"step": i, "seed": int(rng.integers(2**31)),
             "gs": rng.normal(size=k).astype(np.float32).tolist(),
             "lr": lr, "eps": 1e-2} for i in range(n)]


def serve(arch, jax_side, mode, over=None, hook=None):
    """Greedy tokens of one request per prompt through the JAX engine
    (``jax_side``) or the port's in ``mode`` (``MODES``), with a replayed
    user beside the base; ``hook(engine)`` runs before serving. MoE
    configs take ample capacity, so routing does not depend on what
    shares a dispatch (as the JAX package's engine tests do)."""
    over = dict(over or {})
    jcfg, cfg = configs(arch)
    if cfg.n_experts:
        over.setdefault("capacity_factor", 8.0)
    jcfg, cfg = (dataclasses.replace(jcfg, **over),
                 dataclasses.replace(cfg, **over))
    _, jparams, _, params = case(arch)
    if jax_side:
        st, eng_cls, req_cls, extra = (JAdapterStore(jparams), JServeEngine,
                                       JRequest, {})
    else:
        st, eng_cls, req_cls, extra = (AdapterStore(params, device=CPU),
                                       ServeEngine, Request, {"device": CPU})
    st.put("u", _records(4, seed=1))
    eng = eng_cls(jcfg if jax_side else cfg, st, n_slots=2,
                  max_len=max(PLENS) + GEN, seed=0, **MODES[mode], **extra)
    if hook is not None:
        hook(eng)
    rng = np.random.default_rng(10)
    rids = [eng.submit(req_cls(prompt=rng.integers(0, cfg.vocab, p,
                                                   dtype=np.int32),
                               max_new=GEN, user=USERS[i]))
            for i, p in enumerate(PLENS)]
    comps = {c.rid: c.tokens.tolist() for c in eng.run()}
    return [comps[r] for r in rids], eng


def assert_serving_matches(arch, mode):
    want, _ = serve(arch, True, mode)
    got, eng = serve(arch, False, mode)
    assert got == want
    assert all(len(t) == GEN for t in got)
    return eng


USER_AXIS_SEEDS, USER_AXIS_COEFFS = (11, 12), (1e-3, -1e-3)


def user_axis_loss(arch, batch_over=None):
    """The port's fused loss under a 2-lane user-axis ctx over one shared
    base (``v[None]``): both lanes see the same batch, lane i perturbed by
    ``USER_AXIS_SEEDS[i]`` at ``USER_AXIS_COEFFS[i]``; ``batch_over``
    replaces entries of the lane batch."""
    _, _, model, params = case(arch)
    b = to_torch(batch(model.cfg))
    lanes = {k: v[None].expand(2, *v.shape) for k, v in b.items()}
    lanes.update(batch_over or {})
    shared = {k: v[None] for k, v in params.items()}
    return model.loss(shared, lanes, perturb=PerturbCtx(
        seed=USER_AXIS_SEEDS,
        coeff=np.array(USER_AXIS_COEFFS, np.float32)))


def assert_user_axis_lanes(arch):
    """Each lane of :func:`user_axis_loss` equals the scalar fused loss
    with that lane's (seed, coeff) at atol 0 (per-lane MoE capacity and
    aux, the scans and the encoder per lane); a batch whose tokens lack
    the lane axis raises ``ValueError`` naming them, and so does an
    encoder-decoder batch without ``enc_embeds``."""
    import pytest
    _, _, model, params = case(arch)
    b = to_torch(batch(model.cfg))
    got = user_axis_loss(arch)
    assert got.shape == (2,)
    for i, (seed, coeff) in enumerate(zip(USER_AXIS_SEEDS,
                                          USER_AXIS_COEFFS)):
        want = model.loss(params, b, perturb=PerturbCtx(
            seed=seed, coeff=np.float32(coeff)))
        assert got[i].item() == want.item(), (arch, i)
    with pytest.raises(ValueError, match="tokens must carry 2 lanes"):
        user_axis_loss(arch, {"tokens": b["tokens"]})
    if model.cfg.family == "encdec":
        _, _, model, params = case(arch)
        lanes = {k: v[None].expand(2, *v.shape) for k, v in b.items()
                 if k != "enc_embeds"}
        with pytest.raises(ValueError, match="needs enc_embeds"):
            model.loss({k: v[None] for k, v in params.items()}, lanes,
                       perturb=PerturbCtx(seed=USER_AXIS_SEEDS,
                                          coeff=USER_AXIS_COEFFS))


# ---------------------------------------------------------------------------
# the multi-tenant step: the train_fleet CLIs and lone Trainers

FLEET_SEED, FLEET_STEPS, FLEET_B, FLEET_S = 7, 2, 2, 8
FLEET_MZ = dict(eps=1e-3, lr=1e-3)
# 3 users on 2 slots: the third admitted when the first two finish
FLEET_ARGV = ["--reduced", "--users", "3", "--slots", "2", "--steps",
              str(FLEET_STEPS), "--batch", str(FLEET_B), "--seq",
              str(FLEET_S), "--lr", str(FLEET_MZ["lr"]), "--seed",
              str(FLEET_SEED)]


def fleet_jax_init(arch):
    """The JAX train_fleet CLI's base: the reduced config's init at
    ``PRNGKey(--seed)`` (a param tree)."""
    return j_build_model(configs(arch)[0]).init(
        jax.random.PRNGKey(FLEET_SEED))


@functools.lru_cache(maxsize=None)
def _fleet_init_flat(arch):
    return flat(fleet_jax_init(arch))


def fleet_params(arch):
    """:func:`fleet_jax_init` as a fresh port parameter dict."""
    return store.params_from_numpy(_fleet_init_flat(arch), CPU)


def fleet_runs(arch, root):
    """Both ``train_fleet`` CLIs, each with ``--log-dir`` and ``--out``,
    the port's from the JAX CLI's base: a dict of the engine, results by
    user and both summaries."""
    argv = ["--arch", arch, *FLEET_ARGV]
    with mock.patch.object(sys, "argv", [
            "train_fleet", *argv, "--log-dir", str(root / "jax"),
            "--out", str(root / "jax.json")]):
        j_fleet_cli.main()
    engine, results = fleet_cli.run(
        argv + ["--device", CPU, "--log-dir", str(root / "torch"), "--out",
                str(root / "torch.json")], params=fleet_params(arch))
    return dict(root=root, engine=engine,
                results={r.user: r for r in results},
                jax=json.load(open(root / "jax.json")),
                torch=json.load(open(root / "torch.json")))


def assert_fleet_matches_jax(run):
    """The same summary (save the losses and the rate), per-user losses
    within ATOL and gs within GS_ATOL of the JAX CLI's, the same steps,
    seeds, lr and eps in both replay logs."""
    skip = ("losses", "user_steps_per_s")
    assert {k: v for k, v in run["torch"].items() if k not in skip} == \
        {k: v for k, v in run["jax"].items() if k not in skip}
    for user, want in run["jax"]["losses"].items():
        np.testing.assert_allclose(run["torch"]["losses"][user], want,
                                   rtol=0, atol=ATOL, err_msg=user)
        jrec = j_replay_log.ReplayLog.read(
            str(run["root"] / "jax" / f"{user}.jsonl"))
        trec = ReplayLog.read(str(run["root"] / "torch" / f"{user}.jsonl"))
        for key in ("step", "seed", "lr", "eps"):
            assert [r[key] for r in trec] == [r[key] for r in jrec], key
        np.testing.assert_allclose([r["gs"] for r in trec],
                                   [r["gs"] for r in jrec], rtol=0,
                                   atol=GS_ATOL, err_msg=user)


def assert_lanes_equal_lone_trainers(cfg, engine, results, batch_fns,
                                     params_fn, log_dir, tmp):
    """Each user of ``results`` (JobResults) against a lone port Trainer
    with the derived seed, the user's batches (``batch_fns[user]``, a
    step -> batch function) and as many steps: losses, final parameters
    and the bytes of the replay log at atol 0."""
    mz = MezoConfig(**FLEET_MZ)
    for r in results:
        fn = batch_fns[r.user]
        tr = Trainer(cfg, TrainerConfig(
            estimator="fused", update="sgd", mezo=mz, n_steps=r.n_steps,
            seed=derive_user_seed(FLEET_SEED, r.user),
            ckpt_dir=str(tmp / r.user), snapshot_every=10 ** 6,
            log_every=10 ** 6, device=CPU),
            iter([fn(t) for t in range(r.n_steps)]), log_fn=lambda s: None)
        final = tr.train(params=params_fn())
        assert r.losses == tr.losses, r.user
        got = engine.store.materialize(r.user)
        for path, leaf in final.items():
            assert torch.equal(leaf, got[path]), (r.user, path)
        assert (log_dir / f"{r.user}.jsonl").read_bytes() == \
            (tmp / r.user / "replay.jsonl").read_bytes(), r.user


def assert_logs_cross(run, arch, user="user-1"):
    """Each package's replay log of ``user`` replayed by the other onto
    the CLIs' base: the JAX log equals in the port what the JAX store
    makes of it, and the port's log equals in the JAX store the port
    engine's own state, at atol 0."""
    jlog = str(run["root"] / "jax" / f"{user}.jsonl")
    tlog = str(run["root"] / "torch" / f"{user}.jsonl")
    jstore = JAdapterStore(fleet_jax_init(arch),
                           mezo_cfg=JMezoConfig(**FLEET_MZ))
    jstore.load(user, jlog)
    tstore = AdapterStore(fleet_params(arch), mezo_cfg=MezoConfig(
        **FLEET_MZ), device=CPU)
    tstore.load(user, jlog)
    want = flat(jstore.materialize(user))
    got = store.params_to_numpy(tstore.materialize(user))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jstore.load("t", tlog)
    want = store.params_to_numpy(run["engine"].store.materialize(user))
    got = flat(jstore.materialize("t"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def enc_batches(cfg, user, seed=FLEET_SEED):
    """The train_fleet CLI's per-(user, step) stream at FLEET_B x FLEET_S
    with the audio frontend stub beside it: ``enc_embeds`` (B, T_enc, d)
    normals from a (user, step) seed. (The CLIs make no enc_embeds.)"""
    base = fleet_cli.user_batches(cfg, user, FLEET_B, FLEET_S, seed)
    salt = zlib.crc32(f"{seed}/{user}/enc".encode()) & 0x7FFFFFFF

    def fn(step):
        b = base(step)
        b["enc_embeds"] = np.random.default_rng((salt, step)).standard_normal(
            (FLEET_B, cfg.enc_len, cfg.d_model), dtype=np.float32)
        return b
    return fn

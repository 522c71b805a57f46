"""Port parity: the four examples' functions (``repro_torch.examples``)
against the JAX package's API called with the same arguments, from the
JAX package's initial parameters (carried through
``checkpoint/store.params_from_numpy``), with step counts cut:

  * quickstart (10 steps an arm): MeZO losses within 1e-5, Adam's within
    1e-4 (``tests/test_torch_adam.py``'s limit); the parameter and Adam
    state bytes equal;
  * finetune_sst2 (12 steps): losses within 1e-5, logged gs within 1e-3,
    accuracy before and after equal; each package replays the other's
    log onto the initial parameters to the other's final ones within the
    walk's drift (``_walk_drift``); ``load_manifest`` gives the JAX
    package's dicts on a directory each package wrote;
  * serve_personalized (4 steps a user): the greedy tokens of every
    request equal; adapter ``n_steps`` equal and the records up to gs;
    ``nbytes`` equal on the JAX package's records; inside the
    port, every user's materialized parameters equal its trained ones at
    atol 0;
  * ``dot_with_z``: within 1e-5 relative of JAX's, Rademacher and
    Gaussian z, with an int8 ``QuantizedLeaf`` tangent and a skipped
    integer leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import replay_log as j_replay_log  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import MezoConfig as JMezoConfig  # noqa: E402
from repro.core.perturb import _path_str  # noqa: E402
from repro.core.perturb import dot_with_z as j_dot_with_z  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim import quant as jquant  # noqa: E402
from repro.optim.adam import AdamConfig as JAdamConfig  # noqa: E402
from repro.optim.adam import adam_init as j_adam_init  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JTrainerConfig  # noqa: E402
from repro.serve import AdapterStore as JAdapterStore  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.checkpoint import ReplayLog, replay_into, store  # noqa: E402
from repro_torch.core import MezoConfig, dot_with_z  # noqa: E402
from repro_torch.examples import finetune_sst2 as sst2  # noqa: E402
from repro_torch.examples import quickstart as qs  # noqa: E402
from repro_torch.examples import serve_personalized as sp  # noqa: E402
from repro_torch.optim.quant import QuantizedLeaf  # noqa: E402

torch.set_num_threads(1)

LOSS_ATOL = 1e-5
ADAM_LOSS_ATOL = 1e-4
GS_ATOL = 1e-3
DOT_RTOL = 1e-5
QS_STEPS, SST2_STEPS, SERVE_STEPS = 10, 12, 4
CPU = "cpu"


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.array(v) for p, v in leaves}


def _tensors(flat):
    return store.params_from_numpy(flat, CPU)


def _copy(tree):
    return jax.tree.map(jnp.copy, tree)


def _jax_state_bytes(tree):
    """The JAX example's ``state_bytes``."""
    return sum(l.size * l.dtype.itemsize for l in jax.tree.leaves(tree))


# ---------------------------------------------------------------------------
# quickstart


@pytest.fixture(scope="module")
def quickstart():
    cfg = qs.reduced_config()
    jcfg = j_get_config("opt-1.3b").reduced(n_layers=2, d_model=64,
                                            d_ff=128, vocab=128)
    jinit = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    init = _tensors(_flat(jinit))
    out = {"init": init, "jinit": jinit, "cfg": cfg}
    for opt in qs.OPTIMIZERS:
        tc = JTrainerConfig(optimizer=opt,
                            mezo=JMezoConfig(eps=1e-2, lr=1e-2,
                                             n_directions=8),
                            adam=JAdamConfig(lr=1e-3), n_steps=QS_STEPS,
                            log_every=20)
        jtr = JTrainer(jcfg, tc, jsyn.lm_batches(qs.BATCH, qs.SEQ,
                                                 jcfg.vocab, seed=1))
        jtr.train(_copy(jinit))
        ttr = qs.train_arm(cfg, opt, steps=QS_STEPS, device=CPU,
                           params=init, log_fn=lambda m: None)
        out[opt] = (jtr.losses, ttr.losses)
    return out


@pytest.mark.parametrize("opt,atol", [("mezo", LOSS_ATOL),
                                      ("adam", ADAM_LOSS_ATOL)])
def test_quickstart_losses_match_jax(quickstart, opt, atol):
    want, got = quickstart[opt]
    assert len(got) == len(want) == QS_STEPS
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_quickstart_state_bytes_equal_jax(quickstart):
    jinit = quickstart["jinit"]
    p_bytes, a_bytes = qs.state_memory(quickstart["cfg"], CPU,
                                       quickstart["init"])
    assert p_bytes == _jax_state_bytes(jinit)
    assert a_bytes == _jax_state_bytes(j_adam_init(jinit))
    assert a_bytes == 2 * p_bytes + 4      # two f32 moments + the count


def test_quickstart_starts_from_the_given_params(quickstart):
    """``train_arm`` trains a copy: the carried parameters stay as given."""
    jinit = _flat(quickstart["jinit"])
    for k, v in quickstart["init"].items():
        np.testing.assert_array_equal(v.numpy(), jinit[k], err_msg=k)


# ---------------------------------------------------------------------------
# finetune_sst2


def _walk_drift(final, steps, kk, eps):
    """The most a walk run's live leaf may sit from its replay: each of
    the steps * K in-place +eps, -2 eps, +eps round trips rounds three
    times and the update once, each at most half an ulp of the leaf's
    largest value (+ 2 eps), so 2 ulps a direction."""
    return {k: 2 * steps * kk * 2.0 ** -23 * (float(np.abs(v).max())
                                              + 2 * eps)
            for k, v in final.items()}


def _assert_within(got, want, limits):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_allclose(g, want[k], rtol=0, atol=limits[k],
                                   err_msg=k)


def _nested(flat):
    """A ``/``-keyed flat dict as the nested tree the JAX package uses."""
    tree = {}
    for path, v in flat.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _j_accuracy(model, params, toks, labels):
    """The JAX example's ``accuracy``."""
    logits, _ = model.forward(params, {"tokens": jnp.asarray(toks)})
    pred = np.asarray(jnp.argmax(logits, -1))
    return float((pred == labels).mean())


@pytest.fixture(scope="module")
def finetune(tmp_path_factory):
    root = tmp_path_factory.mktemp("sst2")
    cfg = sst2.reduced_config()
    jcfg = j_get_config("roberta-large").reduced(n_layers=2, d_model=128,
                                                 d_ff=256, vocab=256)
    jmodel = j_build_model(jcfg)
    toks, labels = jsyn.synthetic_sst2(256, sst2.SEQ, jcfg.vocab, seed=99)
    tc = JTrainerConfig(optimizer="mezo",
                        mezo=JMezoConfig(eps=1e-2, lr=2e-2, n_directions=8),
                        n_steps=SST2_STEPS, ckpt_dir=str(root / "jax"),
                        snapshot_every=100, log_every=50)
    jtr = JTrainer(jcfg, tc, jsyn.sst2_batches(16, sst2.SEQ, jcfg.vocab,
                                               seed=5))
    jp0 = jtr.init_params()
    jacc0 = _j_accuracy(jmodel, jp0, toks, labels)
    jfinal = jtr.train(_copy(jp0))
    jacc1 = _j_accuracy(jmodel, jfinal, toks, labels)

    ttr = sst2.make_trainer(cfg, str(root / "torch"), steps=SST2_STEPS,
                            device=CPU, log_fn=lambda m: None)
    init = _flat(jp0)
    ttoks, tlabels = sst2.eval_set(cfg)
    acc0, acc1, final = sst2.finetune(ttr, _tensors(init), ttoks, tlabels)
    return dict(root=root, init=init, jax_final=_flat(jfinal),
                jax_losses=jtr.losses, jax_acc=(jacc0, jacc1),
                torch_final=final, torch_losses=ttr.losses,
                torch_acc=(acc0, acc1), eval=(toks, labels, ttoks, tlabels))


def test_finetune_losses_gs_and_accuracy_match_jax(finetune):
    run = finetune
    assert len(run["torch_losses"]) == SST2_STEPS
    np.testing.assert_allclose(run["torch_losses"], run["jax_losses"],
                               rtol=0, atol=LOSS_ATOL)
    jrec = j_replay_log.ReplayLog.read(str(run["root"] / "jax" /
                                           "replay.jsonl"))
    trec = ReplayLog.read(str(run["root"] / "torch" / "replay.jsonl"))
    assert [r["step"] for r in trec] == list(range(SST2_STEPS))
    assert [r["seed"] for r in trec] == [r["seed"] for r in jrec]
    np.testing.assert_allclose([r["gs"] for r in trec],
                               [r["gs"] for r in jrec], rtol=0, atol=GS_ATOL)
    toks, labels, ttoks, tlabels = run["eval"]
    np.testing.assert_array_equal(ttoks, toks)
    np.testing.assert_array_equal(tlabels, labels)
    assert run["torch_acc"] == run["jax_acc"]


def test_finetune_logs_replay_across_packages(finetune):
    run = finetune
    cfg = dict(eps=1e-2, lr=2e-2, n_directions=8)
    # the JAX package's log, replayed by the port
    got, last = replay_into(_tensors(run["init"]), ReplayLog.read(
        str(run["root"] / "jax" / "replay.jsonl")), MezoConfig(**cfg))
    assert last == SST2_STEPS - 1
    _assert_within(got, run["jax_final"],
                   _walk_drift(run["jax_final"], SST2_STEPS, 8, 1e-2))
    # the port's log, replayed by the JAX package
    want, _ = j_replay_log.replay_into(
        jax.tree.map(jnp.asarray, _nested(run["init"])),
        j_replay_log.ReplayLog.read(str(run["root"] / "torch" /
                                        "replay.jsonl")),
        JMezoConfig(**cfg))
    torch_final = {k: v.numpy() for k, v in run["torch_final"].items()}
    _assert_within(_flat(want), torch_final,
                   _walk_drift(torch_final, SST2_STEPS, 8, 1e-2))


def test_load_manifest_equals_jax(finetune):
    for pkg in ("torch", "jax"):
        d = str(finetune["root"] / pkg)
        step = store.latest_step(d)
        assert step == 0
        assert store.load_manifest(d, step) == jstore.load_manifest(d, step)
    mt = store.load_manifest(str(finetune["root"] / "torch"), 0)
    mj = jstore.load_manifest(str(finetune["root"] / "jax"), 0)
    for key in ("step", "keys", "dtypes", "shapes"):
        assert mt[key] == mj[key], key


# ---------------------------------------------------------------------------
# serve_personalized


@pytest.fixture(scope="module")
def personalized(tmp_path_factory):
    root = tmp_path_factory.mktemp("personalized")
    cfg = sp.reduced_config()
    jcfg = j_get_config("gemma-2b").reduced()
    jmz = JMezoConfig(eps=1e-2, lr=5e-3, n_directions=4)
    jbase = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    base = _tensors(_flat(jbase))
    jckpts = {u: str(root / f"jax_{u}") for u in sp.USERS}
    tckpts = sp.ckpt_dirs(str(root))
    trained = {}
    for user, seed in sp.USERS.items():
        tc = JTrainerConfig(optimizer="mezo-parallel", mezo=jmz,
                            n_steps=SERVE_STEPS, ckpt_dir=jckpts[user],
                            snapshot_every=15, log_every=10, seed=0)
        JTrainer(jcfg, tc, jsyn.lm_batches(8, 32, jcfg.vocab, seed=seed)
                 ).train()
        trained[user] = sp.finetune(cfg, user, seed, tckpts[user],
                                    steps=SERVE_STEPS, device=CPU,
                                    params=base)[1]
    jstore_ = JAdapterStore(jbase, jmz)
    jads = {u: jstore_.import_checkpoint(u, jckpts[u]) for u in sp.USERS}
    jengine = JServeEngine(jcfg, jstore_, n_slots=2, max_len=32, seed=0)
    jrids = {jengine.submit(JRequest(prompt=r.prompt, max_new=r.max_new,
                                     user=r.user)): r.user
             for r in sp.requests(cfg)}
    jtoks = {c.rid: c.tokens for c in jengine.run()}
    tstore = sp.adapter_store(base, tckpts, CPU)
    engine, comps, rids = sp.serve(cfg, tstore, CPU)
    return dict(jads=jads, jstore=jstore_, jtoks=jtoks, jrids=jrids,
                tstore=tstore,
                trained=trained, comps=comps, rids=rids, engine=engine)


def test_personalized_tokens_match_jax(personalized):
    run = personalized
    assert run["rids"] == run["jrids"]
    got = {c.rid: c.tokens for c in run["comps"]}
    assert set(got) == set(run["jtoks"]) and len(got) == sp.N_REQUESTS
    for rid, toks in run["jtoks"].items():
        np.testing.assert_array_equal(got[rid], np.asarray(toks),
                                      err_msg=f"rid {rid}")
    sp.report(run["engine"], run["tstore"], run["comps"], run["rids"])


def test_personalized_adapters_match_jax(personalized, tmp_path):
    """n_steps equal, and the records up to gs (within 1e-3); nbytes, the
    JSON size of the records, equal on the same records: the port's store
    reading the JAX package's logs (each package's own log holds its own
    gs, whose shortest float repr may differ by a digit)."""
    run = personalized
    other = sp.AdapterStore(run["tstore"].base, sp.MZ, device=CPU)
    for user, jad in run["jads"].items():
        ad = run["tstore"]._adapters[user]
        assert ad.n_steps == jad.n_steps == SERVE_STEPS
        for r, jr in zip(ad.records, jad.records):
            assert {k: v for k, v in r.items() if k != "gs"} == \
                {k: v for k, v in jr.items() if k != "gs"}
            np.testing.assert_allclose(r["gs"], jr["gs"], rtol=0,
                                       atol=GS_ATOL)
        jpath = tmp_path / f"{user}.jsonl"
        run["jstore"].save(user, str(jpath))
        read = other.load(user, str(jpath))
        assert (read.n_steps, read.nbytes) == (jad.n_steps, jad.nbytes)


def test_personalized_materialized_equals_trained(personalized):
    sp.check_materialized(personalized["tstore"], personalized["trained"])
    # the check sees a difference: one replayed record fewer fails it
    store_ = personalized["tstore"]
    user = next(iter(sp.USERS))
    short = sp.AdapterStore(store_.base, sp.MZ, device=CPU)
    short.put(user, list(store_.records(user))[:-1])
    with pytest.raises(AssertionError):
        sp.check_materialized(short, {user: personalized["trained"][user]})


# ---------------------------------------------------------------------------
# dot_with_z


def _dot_tree():
    rng = np.random.default_rng(7)
    w = rng.normal(0, 0.5, (16, 24)).astype(np.float32)
    like = {"blocks": {"mlp": {"w_in": {"w": rng.normal(
        size=(2, 8, 12)).astype(np.float32)}},
        "ln": {"scale": np.ones(12, np.float32)}},
        "head": {"w": w},
        "step_ids": np.arange(5, dtype=np.int32)}
    q = jquant.quantize_leaf(jnp.asarray(w), with_delta=True)
    q = jquant.QuantizedLeaf(q=q.q, scale=q.scale, delta=jnp.asarray(
        rng.normal(0, 1e-3, w.shape).astype(np.float32)),
        orig_dtype=q.orig_dtype)
    tangent = {"blocks": {"mlp": {"w_in": {"w": rng.normal(
        size=(2, 8, 12)).astype(np.float32)}},
        "ln": {"scale": rng.normal(size=12).astype(np.float32)}},
        "head": {"w": q},
        "step_ids": np.arange(5, dtype=np.int32)}
    return like, tangent


@pytest.mark.parametrize("dist", ["rademacher", "gaussian"])
def test_dot_with_z_matches_jax(dist):
    like, tangent = _dot_tree()
    jlike = jax.tree.map(jnp.asarray, like)
    jtan = jax.tree.map(lambda x: x if jquant.is_quantized(x)
                        else jnp.asarray(x), tangent,
                        is_leaf=jquant.is_quantized)
    tlike = _tensors(_flat(like))
    ttan = _tensors(_flat({k: v for k, v in tangent.items()
                           if k != "head"}))
    hq = tangent["head"]["w"]
    ttan["head/w"] = QuantizedLeaf(
        q=torch.from_numpy(np.array(hq.q)),
        scale=torch.from_numpy(np.array(hq.scale)),
        delta=torch.from_numpy(np.array(hq.delta)))
    for seed in (0, 12345, 2 ** 32 - 5):
        want = float(j_dot_with_z(jlike, jnp.uint32(seed), jtan, dist))
        got = dot_with_z(tlike, seed, ttan, dist)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= DOT_RTOL * abs(want), (seed, dist)
    # the integer leaf is skipped, the quantized tangent dequantized
    only = {"head/w": tlike["head/w"]}
    np.testing.assert_allclose(
        float(dot_with_z(only, 3, {"head/w": ttan["head/w"]}, dist)),
        float(dot_with_z(only, 3, {"head/w":
                                   ttan["head/w"].dequantize_f32()}, dist)),
        rtol=0, atol=0)

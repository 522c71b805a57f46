"""Port parity: personalized paged serving on reduced OPT-1.3B.

JAX parameters cross into the port through the checkpoint store. Logits
of ``decode_step`` (dense and paged) and ``prefill_chunk`` match the JAX
package at atol 1e-5 (f32); adapter materialization matches at atol 0
(Rademacher replay); the two ``ServeEngine``s emit identical greedy
tokens; inside the port, paged == dense and chunked == whole-prompt.
The port's reference loop ``serve()`` emits JAX's ``serve()`` greedy
tokens exactly at reduced gemma-2b and OPT-1.3B, for a batch and for
single prompts, and the port's engine emits the port's ``serve()``
tokens.
"""

import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import ReplayLog as JReplayLog  # noqa: E402
from repro.checkpoint import replay_log as j_replay_log  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import MezoConfig as JMezoConfig  # noqa: E402
from repro.core.perturb import _path_str  # noqa: E402
from repro.launch.serve import serve as j_serve  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serve import AdapterStore as JAdapterStore  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.checkpoint import ReplayLog, replay_into, store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import MezoConfig  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.runtime import check_user_axis  # noqa: E402
from repro_torch.serve import AdapterStore, Request, ServeEngine  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5
CPU = "cpu"


def _records(n, seed, k=2, lr=5e-2):
    rng = np.random.default_rng(seed)
    return [{"step": i, "seed": int(rng.integers(2**31)),
             "gs": rng.normal(size=k).astype(np.float32).tolist(),
             "lr": lr, "eps": 1e-2} for i in range(n)]


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def opt(tmp_path_factory):
    """Reduced OPT-1.3B: JAX params, saved by the JAX store and loaded by
    the port's (the checkpoint is how weights cross)."""
    jcfg = j_get_config("opt-1.3b").reduced()
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    jstore.save_params(ckpt, 3, jparams)
    cfg = get_config("opt-1.3b").reduced()
    model = build_model(cfg)
    like = model.init(torch.Generator().manual_seed(0), CPU)
    assert store.latest_step(ckpt) == 3
    params = store.load_params(ckpt, 3, like)
    return jcfg, jparams, cfg, params


# the port's fields the JAX package lacks (Jamba's inner norms and router),
# at the values under which the port computes as the JAX package does
PORT_ONLY = {"mamba_inner_norm": False, "moe_renorm": True}


def test_configs_mirror_jax():
    from repro.configs import ALL_ARCHS
    for arch in ALL_ARCHS:
        j, t = j_get_config(arch), get_config(arch)
        for jc, tc in ((j, t), (j.reduced(), t.reduced())):
            fields = dict(tc.__dict__)
            assert {k: fields.pop(k) for k in PORT_ONLY} == PORT_ONLY
            assert jc.__dict__ == fields


def test_checkpoint_crosses_and_init_matches_tree(opt):
    jcfg, jparams, cfg, params = opt
    flat = _flat(jparams)
    assert set(flat) == set(params)
    direct = store.params_from_numpy(flat, CPU)       # no checkpoint
    back = store.params_to_numpy(direct)
    for k, v in flat.items():
        assert torch.equal(direct[k], params[k]), k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    like = build_model(cfg).init(torch.Generator().manual_seed(1), CPU)
    for k, v in flat.items():
        np.testing.assert_array_equal(params[k].numpy(), v, err_msg=k)
        assert tuple(like[k].shape) == v.shape and str(v.dtype) == str(
            like[k].dtype).replace("torch.", ""), k
    # full-size init: same tree, shapes and dtypes as the JAX init
    full = jax.eval_shape(j_build_model(j_get_config("opt-1.3b")).init,
                          jax.random.PRNGKey(0))
    from repro_torch.models.transformer import param_shapes
    spec = param_shapes(get_config("opt-1.3b"))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat_shapes(
        full).items()} == {k: (s, str(d).replace("torch.", ""))
                           for k, (s, d, _) in spec.items()}


def _flat_shapes(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): v for p, v in leaves}


def test_store_round_trips_both_ways(tmp_path, opt):
    jcfg, jparams, cfg, params = opt
    store.save_params(str(tmp_path), 5, params)
    back = jstore.load_params(str(tmp_path), 5, jparams)
    for k, v in _flat(back).items():
        np.testing.assert_array_equal(v, params[k].numpy(), err_msg=k)
    # bf16 leaves: JAX's 2-byte records load bit for bit; ours go as f32
    bf = {"lm_head/w": params["lm_head/w"].to(torch.bfloat16)}
    jbf = {"lm_head": {"w": jax.numpy.asarray(
        params["lm_head/w"].numpy()).astype(jax.numpy.bfloat16)}}
    jstore.save_params(str(tmp_path / "j"), 0, jbf)
    got = store.load_params(str(tmp_path / "j"), 0, bf)["lm_head/w"]
    assert torch.equal(got, bf["lm_head/w"])
    store.save_params(str(tmp_path / "t"), 0, bf)
    jgot = jstore.load_params(str(tmp_path / "t"), 0, jbf)
    np.testing.assert_array_equal(
        np.asarray(jgot["lm_head"]["w"].astype(jax.numpy.float32)),
        got.float().numpy())


def _jax_logits_sequence(jcfg, jparams, toks, pages, ps, n_pages):
    jm = j_build_model(jcfg)
    out = {}
    b, p = toks.shape
    dcache = jm.init_cache(b, 16)
    lg, dcache = jm.prefill(jparams, dcache, jax.numpy.asarray(toks))
    out["prefill"] = np.asarray(lg)
    nxt = jax.numpy.asarray(toks[:, :1])
    lg, _ = jm.decode_step(jparams, dcache, nxt,
                           jax.numpy.full((b,), p, jax.numpy.int32))
    out["decode_dense"] = np.asarray(lg)
    pcache = jm.init_paged_cache(b, n_pages, ps)
    lg, pcache = jm.prefill_chunk(jparams, pcache, jax.numpy.asarray(toks),
                                  jax.numpy.zeros((b,), jax.numpy.int32),
                                  pages=jax.numpy.asarray(pages))
    out["chunk"] = np.asarray(lg)
    lg, _ = jm.decode_step(jparams, pcache, nxt,
                           jax.numpy.full((b,), p, jax.numpy.int32),
                           pages=jax.numpy.asarray(pages))
    out["decode_paged"] = np.asarray(lg)
    return out


def test_model_logits_match_jax(opt):
    jcfg, jparams, cfg, params = opt
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 7),
                                             dtype=np.int32)
    ps, n_pages = 4, 7
    pages = np.asarray([[3, 1], [2, 5]], np.int32)
    want = _jax_logits_sequence(jcfg, jparams, toks, pages, ps, n_pages)
    m = build_model(cfg)
    t = torch.from_numpy(toks).long()
    nxt = t[:, :1]
    dcache = m.init_cache(2, 16, device=CPU)
    lg, dcache = m.prefill(params, dcache, t)
    np.testing.assert_allclose(lg.numpy(), want["prefill"], atol=ATOL,
                               rtol=0)
    lg, _ = m.decode_step(params, dcache, nxt, 7)
    np.testing.assert_allclose(lg.numpy(), want["decode_dense"], atol=ATOL,
                               rtol=0)
    pcache = m.init_paged_cache(2, n_pages, ps, device=CPU)
    tp = torch.from_numpy(pages)
    lg, pcache = m.prefill_chunk(params, pcache, t, 0, pages=tp)
    np.testing.assert_allclose(lg.numpy(), want["chunk"], atol=ATOL, rtol=0)
    lg, _ = m.decode_step(params, pcache, nxt, 7, pages=tp)
    np.testing.assert_allclose(lg.numpy(), want["decode_paged"], atol=ATOL,
                               rtol=0)
    full, _ = m.forward(params, {"tokens": t})
    jfull, _ = j_build_model(jcfg).forward(jparams,
                                           {"tokens": jax.numpy.asarray(toks)})
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), atol=ATOL,
                               rtol=0)


def test_adapter_materialize_bit_exact(opt):
    jcfg, jparams, cfg, params = opt
    recs = _records(3, seed=11)
    recs[1]["mask"] = [1.0, 0.0]
    cfg_kw = dict(weight_decay=0.01)
    jstore_ = JAdapterStore(jparams, JMezoConfig(**cfg_kw))
    tstore = AdapterStore(params, MezoConfig(**cfg_kw), device=CPU)
    jstore_.put("u", recs)
    tstore.put("u", recs)
    want = _flat(jstore_.materialize("u"))
    got = tstore.materialize("u")
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert tstore.materialize("u") is got and tstore.stats["hits"] == 1


def test_replay_log_written_by_jax_reads_and_replays(tmp_path, opt):
    jcfg, jparams, cfg, params = opt
    path = str(tmp_path / "replay.jsonl")
    log = JReplayLog(path, fsync=False)
    for r in _records(3, seed=5):
        log.append(r["step"], np.uint32(r["seed"]), r["gs"], r["lr"],
                   r["eps"])
    log.close()
    with open(path, "a") as f:                  # a retried step + torn tail
        f.write(json.dumps(_records(3, seed=5)[2]) + "\n" + '{"step": 9, "se')
    with pytest.warns(RuntimeWarning):
        jrecs = JReplayLog.read(path)
    with pytest.warns(RuntimeWarning):
        trecs = ReplayLog.read(path)
    assert trecs == jrecs and len(trecs) == 3
    jp, jlast = j_replay_log.replay_into(jparams, jrecs, JMezoConfig())
    tp, tlast = replay_into(params, trecs, MezoConfig())
    assert tlast == jlast
    for k, v in _flat(jp).items():
        np.testing.assert_array_equal(tp[k].numpy(), v, err_msg=k)
    # a fleet record (staleness 2) replays through the stale-sgd
    # coefficients, bit for bit the JAX package's replay
    stale = [dict(trecs[0], staleness=2)]
    jp, _ = j_replay_log.replay_into(jparams, stale, JMezoConfig())
    tp, _ = replay_into(params, stale, MezoConfig())
    for k, v in _flat(jp).items():
        np.testing.assert_array_equal(tp[k].numpy(), v, err_msg=k)


def _requests(vocab, n, users, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, lens[i % len(lens)], dtype=np.int32),
             users[i % len(users)]) for i in range(n)]


def _port_tokens(cfg, params, reqs, gen, **kw):
    st = AdapterStore(params, device=CPU)
    st.put("alice", _records(3, seed=1))
    st.put("bob", _records(2, seed=2))
    eng = ServeEngine(cfg, st, n_slots=2, max_len=16, seed=0, device=CPU,
                      **kw)
    for prompt, user in reqs:
        eng.submit(Request(prompt=prompt, max_new=gen, user=user))
    return [c.tokens.tolist() for c in eng.run()], eng


def test_serve_engines_emit_identical_greedy_tokens(opt):
    jcfg, jparams, cfg, params = opt
    reqs = _requests(cfg.vocab, 6, ["alice", "bob", None], (7, 5, 9))
    js = JAdapterStore(jparams)
    js.put("alice", _records(3, seed=1))
    js.put("bob", _records(2, seed=2))
    jeng = JServeEngine(jcfg, js, n_slots=2, max_len=16, seed=0, paged=True,
                        page_size=4, prefill_chunk=4)
    for prompt, user in reqs:
        jeng.submit(JRequest(prompt=prompt, max_new=5, user=user))
    want = [c.tokens.tolist() for c in jeng.run()]
    got, eng = _port_tokens(cfg, params, reqs, 5, paged=True, page_size=4,
                            prefill_chunk=4)
    assert got == want
    assert eng.stats.finished == 6 and eng.stats.peak_pages_in_use > 0
    # inside the port: paged == dense, chunked == whole-prompt admission
    dense, _ = _port_tokens(cfg, params, reqs, 5)
    whole, _ = _port_tokens(cfg, params, reqs, 5, paged=True, page_size=4)
    assert dense == got and whole == got


def test_engine_rejects_unported_and_missing_device(opt):
    jcfg, jparams, cfg, params = opt
    st = AdapterStore(params, device=CPU)
    # speculative decoding is ported: its flags fail as the JAX engine's
    with pytest.raises(ValueError, match="spec_k must be >= 1"):
        ServeEngine(cfg, st, paged=True, spec_k=0, device=CPU)
    with pytest.raises(ValueError, match="spec_k requires paged=True"):
        ServeEngine(cfg, st, paged=False, spec_k=2, device=CPU)
    # every family builds and takes the multi-tenant forward: what the
    # user-axis check refuses is a batch without the ctx's lane axis
    rwkv = build_model(get_config("rwkv6-7b").reduced())
    lanes = torch.zeros((2, 1, 4), dtype=torch.int32)
    check_user_axis(rwkv.plan, {"tokens": lanes}, 2)
    with pytest.raises(ValueError, match="tokens must carry 2 lanes"):
        check_user_axis(rwkv.plan, {"tokens": lanes[0]}, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            AdapterStore(params)


def test_cli_on_cpu(tmp_path, capsys):
    ckpt = tmp_path / "alice"
    ckpt.mkdir()
    with open(ckpt / "replay.jsonl", "w") as f:
        for r in _records(2, seed=4):
            f.write(json.dumps(r) + "\n")
    serve_cli.main(["--arch", "opt-1.3b", "--reduced", "--device", "cpu",
                    "--paged",
                    "--page-size", "4", "--prefill-chunk", "4",
                    "--requests", "3", "--slots", "2", "--prompt-len", "6",
                    "--gen", "3", "--adapter", f"alice={ckpt}"])
    out = capsys.readouterr().out
    assert "[serve] adapter 'alice': 2 steps" in out
    assert "[serve] 3 reqs x (6 prompt + 3 gen)" in out
    assert "chunked prefill C=4" in out
    # the JAX CLI's mix: with an adapter every request goes to a user
    assert out.count("user=alice") == 3 and out.count("user=base") == 0


@pytest.mark.parametrize("n_adapters", [0, 2])
def test_cli_request_mix_matches_jax(tmp_path, monkeypatch, n_adapters):
    """The same argv in both serve CLIs assigns every request to the same
    user: round-robin over the adapters, the base only when none is
    given. The engines' ``run`` is stubbed: only the mix is compared."""
    import sys

    from repro.launch import serve as j_serve_cli
    from repro_torch.serve import engine as t_engine
    argv = ["--arch", "opt-1.3b", "--reduced", "--requests", "5",
            "--prompt-len", "6", "--gen", "2"]
    for i, user in enumerate(["alice", "bob"][:n_adapters]):
        ckpt = tmp_path / user
        ckpt.mkdir()
        with open(ckpt / "replay.jsonl", "w") as f:
            for r in _records(2, seed=i):
                f.write(json.dumps(r) + "\n")
        argv += ["--adapter", f"{user}={ckpt}"]
    mixes = {}
    for name, cls in (("jax", JServeEngine), ("torch", t_engine.ServeEngine)):
        seen = mixes.setdefault(name, [])
        orig = cls.submit

        def submit(self, req, _orig=orig, _seen=seen):
            _seen.append(req.user)
            return _orig(self, req)
        monkeypatch.setattr(cls, "submit", submit)
        monkeypatch.setattr(cls, "run", lambda self: [])
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    j_serve_cli.main()
    serve_cli.main(argv + ["--device", "cpu"])
    assert mixes["torch"] == mixes["jax"]
    want = (["alice", "bob", "alice", "bob", "alice"] if n_adapters
            else [None] * 5)
    assert mixes["torch"] == want


def test_sampling_seeded_and_in_support():
    from repro_torch.serve import greedy, sample_topk, step_keys
    logits = torch.tensor([[0.0, 3.0, 1.0, -2.0], [5.0, 0.0, 4.9, 0.0]])
    assert greedy(logits).tolist() == [1, 0]
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        toks = [sample_topk(step_keys(gen, 2), logits, 2).tolist()
                for _ in range(50)]
        draws.append(toks)
    assert draws[0] == draws[1]                         # seeded
    flat = np.asarray(draws[0])
    assert set(flat[:, 0]) <= {1, 2} and set(flat[:, 1]) <= {0, 2}
    assert len(set(flat[:, 1])) == 2                    # both top-2 drawn
    one = sample_topk(step_keys(torch.Generator().manual_seed(0), 2),
                      logits, 1)
    assert one.tolist() == greedy(logits).tolist()      # top-1 == greedy


def test_adapter_store_files_and_lru_eviction(tmp_path, opt):
    jcfg, jparams, cfg, params = opt
    st = AdapterStore(params, device=CPU,
                      cache_bytes=int(1.5 * sum(
                          t.numel() * t.element_size()
                          for t in params.values())))
    st.put("a", _records(2, seed=1))
    n = st.save("a", str(tmp_path / "a.jsonl"))
    assert n == (tmp_path / "a.jsonl").stat().st_size
    st.load("b", str(tmp_path / "a.jsonl"))
    assert st.records("b") == st.records("a") and st.records(None) == ()
    ck = tmp_path / "run"
    ck.mkdir()
    (tmp_path / "a.jsonl").rename(ck / "replay.jsonl")
    st.import_checkpoint("c", str(ck))
    assert st.users() == ["a", "b", "c"]
    pa = st.materialize("a")
    pb = st.materialize("b")                  # evicts "a": 1 tree fits
    assert st.stats["evictions"] == 1 and st.stats["misses"] == 2
    for k in pa:
        assert torch.equal(pa[k], pb[k])      # same log, same weights
    with pytest.raises(KeyError):
        st.materialize("nobody")
    with pytest.raises(ValueError):
        st.put("__base__", [])


# ---------------------------------------------------------------------------
# the reference per-token loop, serve()


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """Reduced gemma-2b (MQA) and OPT-1.3B: JAX params and the same params
    in the port, crossed through the checkpoint store."""
    out = {}
    for arch in ("gemma-2b", "opt-1.3b"):
        jcfg = j_get_config(arch).reduced()
        jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
        ckpt = str(tmp_path_factory.mktemp(arch))
        jstore.save_params(ckpt, 1, jparams)
        cfg = get_config(arch).reduced()
        like = build_model(cfg).init(torch.Generator().manual_seed(0), CPU)
        out[arch] = (jcfg, jparams, cfg, store.load_params(ckpt, 1, like))
    return out


@pytest.mark.parametrize("arch", ["gemma-2b", "opt-1.3b"])
def test_serve_loop_matches_jax_for_a_batch(crossed, arch):
    """The JAX package's contract (tests/test_serve.py): greedy tokens of
    the per-token loop, here the port's against JAX's, exactly."""
    jcfg, jparams, cfg, params = crossed[arch]
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 9),
                                                dtype=np.int32)
    want = j_serve(jcfg, jparams, prompts, gen=6)
    got = serve_cli.serve(cfg, params, prompts, gen=6, device=CPU)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ["gemma-2b", "opt-1.3b"])
def test_serve_loop_matches_jax_for_single_prompts(crossed, arch):
    jcfg, jparams, cfg, params = crossed[arch]
    for i, plen in enumerate((5, 9, 7)):
        prompt = np.random.default_rng(10 + i).integers(
            0, cfg.vocab, (1, plen), dtype=np.int32)
        np.testing.assert_array_equal(
            serve_cli.serve(cfg, params, prompt, gen=5, device=CPU),
            np.asarray(j_serve(jcfg, jparams, prompt, gen=5)))


@pytest.mark.parametrize("mode", ["dense", "paged", "paged-chunked"])
@pytest.mark.parametrize("arch", ["gemma-2b", "opt-1.3b"])
def test_engine_matches_serve_loop(crossed, arch, mode):
    """The port's engine (fused or chunked prefill, dense or paged
    decode, 2 slots for 4 requests) emits the port's serve() tokens."""
    _, _, cfg, params = crossed[arch]
    kw = {"dense": {}, "paged": dict(paged=True, page_size=4),
          "paged-chunked": dict(paged=True, page_size=4,
                                prefill_chunk=4)}[mode]
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (4, 9),
                                                dtype=np.int32)
    want = serve_cli.serve(cfg, params, prompts, gen=6, device=CPU)
    eng = ServeEngine(cfg, AdapterStore(params, device=CPU), n_slots=2,
                      max_len=15, seed=0, device=CPU, **kw)
    rids = [eng.submit(Request(prompt=p, max_new=6)) for p in prompts]
    outs = {c.rid: c.tokens for c in eng.run()}
    np.testing.assert_array_equal(np.stack([outs[r] for r in rids]), want)


def test_serve_loop_samples_seeded_in_support(crossed):
    _, _, cfg, params = crossed["gemma-2b"]
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (2, 5),
                                                dtype=np.int32)
    a = serve_cli.serve(cfg, params, prompts, gen=4, greedy=False, topk=3,
                        seed=7, device=CPU)
    b = serve_cli.serve(cfg, params, prompts, gen=4, greedy=False, topk=3,
                        seed=7, device=CPU)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 4) and 0 <= a.min() and a.max() < cfg.vocab

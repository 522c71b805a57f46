"""Port parity: self-speculative paged serving on reduced OPT-1.3B.

The JAX parameters cross into the port through
``store.params_from_numpy``. ``verify_window``'s logits and the K/V it
writes match the JAX package's at atol 1e-5 (f32, summation order only).
Greedy tokens of the port's spec engine equal the port's plain paged
engine's and the JAX spec engine's for spec_k 1, 3 and 99 (far past
max_new: masked draft and window positions run past the learned
position table and the live page table), across adapter interleaving,
an int8 base and chunked prefill; the spec CLI equals the JAX spec CLI.
Sampled tokens cannot match JAX's (the generators differ):
``spec_accept`` is held to its limits and, over 4000 draws, to the
target's top-k law within total variation 0.05.
"""

import dataclasses
import functools
import json
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.perturb import _path_str  # noqa: E402
from repro.launch import serve as j_serve_cli  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim import quant as jq  # noqa: E402
from repro.serve import AdapterStore as JAdapterStore  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402
from repro_torch.serve import AdapterStore, Request, ServeEngine  # noqa: E402
from repro_torch.serve import sampling  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5
CPU = "cpu"
TV_LIMIT = 0.05
# staggered prompts, more requests than slots (mid-flight admission into
# recycled pages), windows truncated by remaining
PLENS, G = (5, 9, 7, 12), 6


def _records(n, seed, k=2, lr=5e-2):
    rng = np.random.default_rng(seed)
    return [{"step": i, "seed": int(rng.integers(2**31)),
             "gs": rng.normal(size=k).astype(np.float32).tolist(),
             "lr": lr, "eps": 1e-2} for i in range(n)]


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.array(v) for p, v in leaves}


@functools.lru_cache(maxsize=None)
def _opt(quant=False):
    """(JAX cfg, JAX params, port cfg, port params) of reduced OPT-1.3B,
    the port's carried across from the JAX init (int8: the JAX package's
    quantization of it)."""
    jcfg = j_get_config("opt-1.3b").reduced()
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config("opt-1.3b").reduced()
    if quant:
        jparams = jq.quantize_tree(jparams)
    dtypes = {p: spec[1] for p, spec in param_shapes(cfg).items()}
    return jcfg, jparams, cfg, store.params_from_numpy(_flat(jparams), CPU,
                                                       dtypes)


def _prompts(vocab, plens, seed=10):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, p, dtype=np.int32) for p in plens]


def _serve(jax_side, users, spec_k=None, quant=False, plens=PLENS, gen=G,
           adapters=None, n_slots=2, seed=0, reqs=None, hook=None, **kw):
    """Serve one request per prompt (``reqs``: per-request Request
    fields) through the JAX engine (``jax_side``) or the port's, calling
    ``hook(engine)`` before the run; returns (token lists in submit
    order, engine, completions)."""
    jcfg, jparams, cfg, params = _opt(quant)
    if jax_side:
        st, eng_cls, req_cls, extra = JAdapterStore(jparams), JServeEngine, \
            JRequest, {}
    else:
        st, eng_cls, req_cls, extra = AdapterStore(params, device=CPU), \
            ServeEngine, Request, {"device": CPU}
    for name, recs in (adapters or {"u": _records(4, seed=1)}).items():
        st.put(name, recs)
    eng = eng_cls(jcfg if jax_side else cfg, st, n_slots=n_slots,
                  max_len=max(plens) + gen, seed=seed, paged=True,
                  page_size=4, spec_k=spec_k, **extra, **kw)
    if hook is not None:
        hook(eng)
    rids = [eng.submit(req_cls(**{"prompt": pr, "max_new": gen,
                                  "user": users[i],
                                  **(reqs[i] if reqs else {})}))
            for i, pr in enumerate(_prompts(cfg.vocab, plens))]
    comps = {c.rid: c for c in eng.run()}
    return [comps[r].tokens.tolist() for r in rids], eng, \
        [comps[r] for r in rids]


# ---------------------------------------------------------------------------
# verify_window against the JAX package


def test_verify_window_logits_and_kv_match_jax():
    """Prefill three slots' prompts into a paged cache, then score a
    4-token window at ragged positions with some offsets masked: the
    logits of every live offset and the K/V the window wrote match JAX."""
    jcfg, jparams, cfg, params = _opt()
    jm, m = j_build_model(jcfg), build_model(cfg)
    rng = np.random.default_rng(0)
    ps, n_pages, w = 4, 13, 4
    plens = (5, 9, 3)
    pages = np.asarray([[3, 7, 1, 0], [2, 5, 9, 11], [4, 8, 0, 0]],
                       np.int32)
    pos = np.asarray(plens, np.int32)
    wmask = np.asarray([[1, 1, 1, 0], [1, 1, 1, 1], [1, 1, 0, 0]], bool)
    win = rng.integers(0, cfg.vocab, (3, w), dtype=np.int32)
    jcache = jm.init_paged_cache(3, n_pages, ps)
    tcache = m.init_paged_cache(3, n_pages, ps, device=CPU)
    for b, plen in enumerate(plens):
        prompt = rng.integers(0, cfg.vocab, (1, plen), dtype=np.int32)
        _, jcache = jm.prefill_chunk(
            jparams, jcache, jax.numpy.asarray(prompt),
            jax.numpy.zeros((1,), jax.numpy.int32),
            pages=jax.numpy.asarray(pages[b:b + 1]))
        _, tcache = m.prefill_chunk(
            params, tcache, torch.from_numpy(prompt).long(), 0,
            pages=torch.from_numpy(pages[b:b + 1]))
    want, jcache = jm.verify_window(
        jparams, jcache, jax.numpy.asarray(win), jax.numpy.asarray(pos),
        pages=jax.numpy.asarray(pages), write_mask=jax.numpy.asarray(wmask))
    got, tcache = m.verify_window(
        params, tcache, torch.from_numpy(win).long(), torch.from_numpy(pos),
        pages=torch.from_numpy(pages), write_mask=torch.from_numpy(wmask))
    want = np.asarray(want)
    assert got.shape == want.shape == (3, w, cfg.vocab)
    np.testing.assert_allclose(got.numpy()[wmask], want[wmask], atol=ATOL,
                               rtol=0)
    for name in ("k_pages", "v_pages"):
        jpool = np.asarray(jcache["blocks"]["attn"][name])
        tpool = tcache["blocks"]["attn"][name].numpy()
        # page 0 is the trash page: masked offsets' writes land there
        np.testing.assert_allclose(tpool[:, 1:], jpool[:, 1:], atol=ATOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# greedy parity: port spec == port plain == JAX spec


def _three_ways(users, spec_k, jax_spec=True, **kw):
    """The port's spec tokens against its plain engine's and the JAX
    engine's (its spec engine, or with ``jax_spec=False`` its plain
    one); spec counters equal the JAX spec engine's."""
    plain, _, _ = _serve(False, users, **kw)
    spec, eng, comps = _serve(False, users, spec_k=spec_k, **kw)
    jtoks, jeng, _ = _serve(True, users, spec_k=spec_k if jax_spec else None,
                            **kw)
    assert spec == plain
    assert spec == jtoks
    assert eng.stats.spec_drafted > 0
    if jax_spec:
        assert eng.stats.spec_drafted == jeng.stats.spec_drafted
        assert eng.stats.spec_accepted == jeng.stats.spec_accepted
        assert eng.stats.decode_steps == jeng.stats.decode_steps
    return plain, eng, comps


@pytest.mark.parametrize("spec_k", [1, 3, 99])
def test_spec_matches_plain_and_jax_greedy(spec_k):
    """spec_k = 99 is far past max_new (6) and past the reduced config's
    64 learned positions: masked draft steps and window offsets index
    past both tables, which the port clamps. There the JAX spec engine
    is not the reference: its ``jnp.take`` fills the rows past the
    position table with NaN, which reach live slots through the trash
    page, so the port is held to the JAX plain engine's tokens."""
    users = ["u", None, "u", None]
    plain, eng, comps = _three_ways(users, spec_k, jax_spec=spec_k < 99)
    assert 0.0 <= eng.stats.spec_accept_rate <= 1.0
    assert eng.stats.decode_tokens == sum(len(t) for t in plain) - len(plain)
    assert eng.stats.decode_steps <= eng.stats.decode_tokens
    for c in comps:
        assert c.accept_rate is not None and 0.0 <= c.accept_rate <= 1.0
    assert len(eng._free_pages) == eng.pool_pages - 1    # all pages freed
    assert eng._reserved == 0


def test_spec_matches_plain_and_jax_multi_adapter():
    """One verify call per distinct user: base, alice and bob slots
    interleaved in one batch."""
    _three_ways([None, "alice", "bob", "alice"], 3,
                adapters={"alice": _records(4, seed=1),
                          "bob": _records(4, seed=2)})


def test_spec_matches_plain_and_jax_quantized_base():
    """The int8 base drafts for itself."""
    _three_ways(["u", None], 3, quant=True, plens=(5, 8), gen=5,
                adapters={"u": _records(4, seed=3)})


def test_spec_composes_with_chunked_prefill():
    """spec_k with prefill_chunk: the slot mid-prefill is masked out of
    draft writes and verify."""
    _three_ways(["u", None, "u", None], 3, prefill_chunk=3)


def test_spec_idle_slot_with_stale_pos_past_live_table():
    """A finished slot keeps its stale position while ``n_live`` covers
    the active slots only, so the idle slot's masked window offsets index
    past the live page table (clamped in ``_window_paged``). The spy
    shows the case happened; the tokens stay the plain engine's."""
    past = []

    def spy(engine):
        verify = engine.model.verify_window

        def window(params, cache, toks, pos, pages=None, write_mask=None):
            last = (pos.long() + toks.shape[1] - 1) // engine.page_size
            past.append(bool(((last >= pages.shape[1])
                              & ~write_mask.any(1)).any()))
            return verify(params, cache, toks, pos, pages=pages,
                          write_mask=write_mask)
        engine.model = dataclasses.replace(engine.model,
                                           verify_window=window)
    kw = dict(plens=(14, 3), gen=13, reqs=[{"max_new": 2}, {}])
    plain, _, _ = _serve(False, [None, "u"], **kw)
    spec, _, _ = _serve(False, [None, "u"], spec_k=3, hook=spy, **kw)
    assert spec == plain
    assert any(past)


def test_spec_small_delta_high_acceptance():
    """A near-zero delta (lr 1e-6) makes the draft nearly the target:
    acceptance above 0.9 and fewer than half as many rounds as tokens."""
    plens, gen = (5, 7), 8
    kw = dict(plens=plens, gen=gen, adapters={"tiny": _records(2, 4,
                                                               lr=1e-6)})
    plain, _, _ = _serve(False, ["tiny", "tiny"], **kw)
    spec, eng, _ = _serve(False, ["tiny", "tiny"], spec_k=3, **kw)
    assert spec == plain
    assert eng.stats.spec_accept_rate > 0.9
    assert eng.stats.decode_steps < eng.stats.decode_tokens / 2


# ---------------------------------------------------------------------------
# flags, CLI


def test_spec_flag_validation_in_jax_order():
    jcfg, jparams, cfg, params = _opt()
    st = AdapterStore(params, device=CPU)
    jst = JAdapterStore(jparams)
    for kw, match in ((dict(paged=False, spec_k=0), "spec_k must be >= 1"),
                      (dict(paged=False, spec_k=3), "requires paged"),
                      (dict(paged=False, spec_k=3, prefill_chunk=0),
                       "requires paged")):
        with pytest.raises(ValueError, match=match):
            JServeEngine(jcfg, jst, n_slots=2, max_len=16, **kw)
        with pytest.raises(ValueError, match=match):
            ServeEngine(cfg, st, n_slots=2, max_len=16, device=CPU, **kw)


def test_plain_engine_reports_no_accept_rate():
    _, eng, comps = _serve(False, [None, None], plens=(5, 7), gen=4)
    assert eng.spec_k == 0 and eng.stats.spec_drafted == 0
    assert eng.stats.spec_accept_rate == 0.0
    assert all(c.accept_rate is None for c in comps)


def _cli_tokens(out):
    return [json.loads(line.split(": ", 1)[1]) for line in out.splitlines()
            if line.startswith("[serve] rid=")]


def test_cli_spec_matches_jax_cli(tmp_path, capsys, monkeypatch):
    ckpt = tmp_path / "alice"
    ckpt.mkdir()
    with open(ckpt / "replay.jsonl", "w") as f:
        for r in _records(2, seed=4):
            f.write(json.dumps(r) + "\n")
    argv = ["--arch", "opt-1.3b", "--reduced", "--paged", "--page-size",
            "4", "--spec-k", "3", "--requests", "3", "--slots", "2",
            "--prompt-len", "6", "--gen", "5", "--adapter", f"alice={ckpt}"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    j_serve_cli.main()
    jout = capsys.readouterr().out
    _, jparams, _, params = _opt()              # the JAX CLI's own init
    args = serve_cli.build_parser().parse_args(argv + ["--device", "cpu"])
    engine, comps, dt = serve_cli.run(args, params=params)
    line = serve_cli.summary(args, engine, comps, dt)
    assert [c.tokens.tolist() for c in comps] == _cli_tokens(jout)
    assert len(comps) == 3
    spec_note = line.split(" | spec ")[1].strip()
    assert spec_note.startswith("k=3: accepted ")
    assert (f"{engine.stats.spec_accepted}/{engine.stats.spec_drafted} "
            f"drafts") in spec_note
    assert spec_note == jout.split(" | spec ")[1].split(" | ")[0].strip()


# ---------------------------------------------------------------------------
# spec_accept (speculative rejection sampling against a greedy draft)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _logits(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def test_spec_accept_deterministic():
    lg = _logits(0, (4, 32))
    draft = [3, 5, 9]
    assert (sampling.spec_accept(_gen(0), draft, lg, 8, 1.0)
            == sampling.spec_accept(_gen(0), draft, lg, 8, 1.0))


def test_spec_accept_greedy_limit_full_accept():
    """temperature -> 0 makes the target one-hot at its argmax: the
    argmax chain is fully accepted and the bonus token is the last
    position's argmax."""
    lg = _logits(1, (4, 32))
    draft = lg[:3].argmax(dim=1)
    for seed in range(5):
        n, nxt = sampling.spec_accept(_gen(seed), draft, lg, 8, 1e-9)
        assert n == 3 and nxt == int(lg[3].argmax())


def test_spec_accept_greedy_limit_rejects_wrong_draft():
    """In the same limit a draft token off the argmax is rejected at its
    position and the resample emits the target argmax."""
    lg = _logits(2, (3, 32))
    am = lg.argmax(dim=1).tolist()
    draft = [am[0], (am[1] + 1) % 32]
    for seed in range(5):
        n, nxt = sampling.spec_accept(_gen(seed), draft, lg, 8, 1e-9)
        assert n == 1 and nxt == am[1]


def test_spec_accept_token_in_topk():
    lg = _logits(3, (4, 64))
    topk = np.argsort(lg.numpy(), axis=1)[:, -8:]
    for seed in range(10):
        n, nxt = sampling.spec_accept(_gen(seed), [1, 2, 3], lg, 8, 1.0)
        assert 0 <= n <= 3
        assert nxt in topk[n]


def test_spec_accept_residual_excludes_rejected_token():
    lg = torch.full((2, 16), -10.0)
    lg[0, :4] = torch.tensor([2.0, 1.9, 1.8, 1.7])   # p(draft) ~ 0.3
    lg[1, 0] = 5.0
    rejected = 0
    for seed in range(40):
        n, nxt = sampling.spec_accept(_gen(seed), [1], lg, 4, 1.0)
        if n == 0:
            rejected += 1
            assert nxt != 1
    assert rejected


@pytest.mark.parametrize("draft_rank", [0, 2])
def test_spec_accept_first_token_follows_target_law(draft_rank):
    """The first emitted token (draft[0] if accepted, else the resample)
    is distributed as the target's top-k softmax at position 0, whether
    the draft proposes the mode (rank 0) or the third most likely token:
    total variation within 0.05 over 4000 draws."""
    k, temp, n_draws = 8, 1.3, 4000
    lg = _logits(5, (3, 32))
    vals, idx = torch.topk(lg[0], k)
    target = np.zeros(32)
    target[idx.numpy()] = torch.softmax(vals / temp, 0).numpy()
    draft = [int(idx[draft_rank]), int(lg[1].argmax())]
    counts = np.zeros(32)
    for seed in range(n_draws):
        n, nxt = sampling.spec_accept(_gen(seed), draft, lg, k, temp)
        counts[draft[0] if n >= 1 else nxt] += 1
    tv = 0.5 * np.abs(counts / n_draws - target).sum()
    assert tv < TV_LIMIT, tv


# ---------------------------------------------------------------------------
# sampled slots in the engine


def test_spec_sampled_slots_complete_and_reproduce():
    kw = dict(plens=(5, 7), gen=6,
              reqs=[dict(greedy=False, topk=8, temperature=1.3)] * 2)
    s1, eng, comps = _serve(False, [None, "u"], spec_k=3, **kw)
    s2, _, _ = _serve(False, [None, "u"], spec_k=3, **kw)
    s3, _, _ = _serve(False, [None, "u"], spec_k=3, seed=7, **kw)
    assert all(len(t) == 6 for t in s1)
    assert s1 == s2
    assert s1 != s3
    assert eng.stats.spec_drafted > 0
    assert all(c.accept_rate is not None for c in comps)


def test_spec_mixed_greedy_and_sampled():
    """Greedy and sampled slots share a round; the greedy slots' tokens
    equal the plain engine's."""
    plens = (5, 9, 7)
    plain, _, _ = _serve(False, [None] * 3, plens=plens, n_slots=3)
    mixed, _, _ = _serve(False, [None] * 3, spec_k=3, plens=plens,
                         n_slots=3, reqs=[{}, dict(greedy=False, topk=8),
                                          {}])
    assert mixed[0] == plain[0] and mixed[2] == plain[2]
    assert len(mixed[1]) == G

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is ``gpu``-marked and skips without a CUDA device (the
kernels have no CPU mode). The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch and the CUDA
toolkit:

  PYTHONPATH=src python -m pytest -q -m gpu --noconftest \
      tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports JAX at teardown.)

Tolerances: ``zo_add`` is bit-exact with Rademacher z; with Gaussian z
its f32 output is within 1e-6 (precise logf/cosf, last ulps). The
attention kernels are within 2e-5 in f32 (summation order) and 2e-2 in
bf16 (the paged plain versions round probabilities to bf16). ``zo_matmul``
is within 2e-5 of max|Y| with f32 output (summation order) and 1e-2 with
bf16 output (one rounding). The int8 kernels hold to the same limits:
``zo_add_q`` bit-exact with Rademacher z (1e-6 Gaussian), ``zo_matmul_q``
2e-5 / 1e-2 of max|Y|. Reduced OPT-1.3B and RoBERTa-large (f32) train on
the card to the CPU's losses within 1e-4 (over an int8 base too), and
replay equals the live run at atol 0 there. The user-batched kernels
hold to the scalar kernels' limits against their plain versions, and
every lane equals a lone scalar launch at atol 0; the TrainEngine on the
card equals lone Trainers on the card at atol 0. ``flash_verify`` holds
to the attention limits, and the speculative engine on the card serves
the CPU's greedy tokens. ``zo_matmul`` (all four entry points) and
``flash_attention`` have two bodies: bf16 activations with Rademacher z
run on the tensor cores, f32 or Gaussian z on the SIMT body, as
``build.BODIES`` counts; the tensor-core body holds to the same limits,
at every head dim for attention and at OPT-1.3B's LM head for the
matmuls, with every lane equal to a lone tensor-core launch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import rng  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import zo_perturb as zp  # noqa: E402

pytestmark = pytest.mark.gpu

GAUSS_ATOL = 1e-6
PS = 8
RAGGED_POS = (PS - 2, PS, 2 * PS + 3, 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(), (1,), (37,), (5, 9), (3, 17, 129),
                                   (2, 2, 3, 4, 5), (2048, 50272)], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zo_add_matches_plain(cuda, shape, dtype):
    dt = getattr(torch, dtype)
    w = (torch.randn(shape, device=cuda) * 0.02).to(dt)
    seed, salt, coeff = 99, rng.leaf_salt("lm_head/w"), -0.0071
    before = build.LAUNCHES["zo_add"]
    got = ops.zo_add(w, seed, salt, coeff)
    assert build.LAUNCHES["zo_add"] == before + 1
    assert torch.equal(got, zp.zo_add_ref(w, seed, salt, coeff))
    got = zp.zo_add_cuda(w.float(), seed, salt, 1.0, dist="gaussian")
    want = zp.zo_add_ref(w.float(), seed, salt, 1.0, dist="gaussian")
    torch.testing.assert_close(got, want, rtol=0, atol=GAUSS_ATOL)


def test_zo_add_prehashed_slice_in_place_and_unaligned(cuda):
    w = torch.randn((4, 8, 40), device=cuda)
    seed, salt = 5, rng.leaf_salt("blocks/attn/wo/w")
    full = zp.zo_add_cuda(w, seed, salt, 0.25)
    base = rng.fold_leading(rng.leaf_base(seed, salt), 3)
    part = zp.zo_add_cuda(w[3], base, 0, 0.25, prime_offset=1,
                          prehashed=True)
    assert torch.equal(part, full[3])
    flat = w.reshape(-1)[1:161]               # 4-byte offset: scalar path
    assert torch.equal(zp.zo_add_cuda(flat, seed, salt, 0.25),
                       zp.zo_add_ref(flat, seed, salt, 0.25))
    w2 = w.clone()
    zp.zo_add_cuda(w2, seed, salt, 0.25, out=w2)   # in place
    assert torch.equal(w2, full)


def _case(seed, b, c, h, kvh, hd, n_live, pos, garbage, ps=PS):
    """Queries + pools with a scrambled page table (page 0 = trash, filled
    with ``garbage``), covering positions pos .. pos + c - 1."""
    r = np.random.default_rng(seed)
    n_pages = 1 + b * n_live + 3
    q = r.normal(size=(b, c, h, hd)).astype(np.float32)
    k = r.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32)
    v = r.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32)
    k[0] = garbage
    v[0] = garbage
    pos = np.asarray(pos, np.int32)
    perm = r.permutation(np.arange(1, n_pages))
    pages = np.zeros((b, n_live), np.int32)
    for i in range(b):
        live = 1 + (pos[i] + c - 1) // ps
        pages[i, :live] = perm[i * n_live:i * n_live + live]
    return [torch.from_numpy(a) for a in (q, k, v, pages, pos)]


def _poison_unread(k, v, pages, last):
    """NaN into every position a slot's rows cannot read: the trash page
    and, in each slot's last live page, the positions past ``last[i]``."""
    ps = k.shape[1]
    k[0], v[0] = float("nan"), float("nan")
    for i, t in enumerate(last):
        page = int(pages[i, t // ps])
        k[page, t % ps + 1:] = float("nan")
        v[page, t % ps + 1:] = float("nan")


def _positions(case, ps, c):
    """(n_live, positions): ragged positions straddling page edges; the
    edges of a 64-key tile (63, 64, 127, 128); a long context."""
    if case == "ragged":
        return 6, RAGGED_POS
    if case == "tile_edges":
        return (128 + c - 1) // ps + 2, (63, 64, 127, 128)
    n_live = 64
    return n_live, (n_live * ps - c, 5 * ps + 3, 40 * ps - 1, 0)


@pytest.mark.parametrize("case", ["ragged", "tile_edges", "long"])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("kvh,g,hd", [(1, 4, 64), (2, 2, 128), (4, 1, 64),
                                      (2, 8, 32), (1, 2, 256), (2, 2, 16)])
@pytest.mark.parametrize("c", [1, 3, 2 * PS + 3])
def test_attention_kernels_match_plain(cuda, dtype, atol, kvh, g, hd, c, ps,
                                       case):
    """Paged prefill (and decode at C = 1) against the plain versions at
    page sizes 8 and 16, across 64-key tile edges and over a long context;
    NaN in the trash page and in the unread tail of each slot's last live
    page leaves the output bit-equal, two calls give the same bits, and
    prefill runs bf16 on its tensor-core body, f32 on its SIMT body."""
    dt = getattr(torch, dtype)
    n_live, pos = _positions(case, ps, c)
    q, k, v, pages, pos = [t.to(cuda) for t in _case(
        5, 4, c, kvh * g, kvh, hd, n_live, pos, garbage=1e3, ps=ps)]
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    body = "tc" if dtype == "bfloat16" else "simt"
    before = dict(build.BODIES)
    got = ops.paged_prefill_attn(q, k, v, pages, pos)
    assert build.BODIES[f"flash_prefill/{body}"] == \
        before[f"flash_prefill/{body}"] + 1
    assert sum(build.BODIES[f"flash_prefill/{b}"] for b in ("tc", "simt")) \
        == sum(before[f"flash_prefill/{b}"] for b in ("tc", "simt")) + 1
    want = fp.prefill_attn_ref(q, k, v, pages, pos)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    assert torch.equal(fp.flash_prefill(q, k, v, pages, pos), got)
    dq = q[:, 0].contiguous()
    if c == 1:
        got_d = ops.paged_decode_attn(dq, k, v, pages, pos)
        want_d = fd.paged_attn_ref(dq, k, v, pages, pos)
        torch.testing.assert_close(got_d.float(), want_d.float(), rtol=0,
                                   atol=atol)
        assert torch.equal(fd.flash_decode(dq, k, v, pages, pos), got_d)
    # NaN where no row reads is never read
    _poison_unread(k, v, pages, [int(p) + c - 1 for p in pos.tolist()])
    assert torch.equal(fp.flash_prefill(q, k, v, pages, pos), got)
    if c == 1:
        assert torch.equal(fd.flash_decode(dq, k, v, pages, pos), got_d)


def test_attention_launchers_reject_what_they_do_not_take(cuda):
    q, k, v, pages, pos = [t.to(cuda) for t in _case(
        1, 2, 1, 4, 2, 24, 2, (1, 3), garbage=0.0)]
    with pytest.raises(ValueError, match="head_dim 24"):
        fd.flash_decode(q[:, 0].contiguous(), k, v, pages, pos)
    with pytest.raises(TypeError, match="int32"):
        fp.flash_prefill(q, k, v, pages.long(), pos)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("kvh,g,hd", [(4, 1, 64), (2, 2, 128), (1, 4, 64),
                                      (2, 8, 32), (1, 16, 64), (1, 2, 256),
                                      (2, 2, 16)])
@pytest.mark.parametrize("w", [1, 4])
def test_flash_verify_matches_plain_and_ignores_nan(cuda, dtype, atol, kvh,
                                                   g, hd, w):
    """The verify window (W * G rows a (slot, KV head); 64 rows at G 16,
    W 4 split over blockIdx.z) against its plain version; NaN in the
    trash page never reaches the output."""
    from repro_torch.kernels import flash_verify as fv
    dt = getattr(torch, dtype)
    q, k, v, pages, pos = [t.to(cuda) for t in _case(
        6, 4, w, kvh * g, kvh, hd, 6, RAGGED_POS, garbage=1e3)]
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    before = build.LAUNCHES["flash_verify"]
    got = ops.paged_verify_attn(q, k, v, pages, pos)
    assert build.LAUNCHES["flash_verify"] == before + 1
    want = fv.verify_attn_ref(q, k, v, pages, pos)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    k[0], v[0] = float("nan"), float("nan")
    assert torch.equal(fv.flash_verify(q, k, v, pages, pos), got)


def test_reduced_spec_engine_on_card_matches_cpu(cuda):
    """Speculative serving end to end on reduced OPT-1.3B (f32): the card
    (flash_decode drafts, flash_verify windows) serves the CPU's greedy
    tokens, which equal the plain engine's."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import AdapterStore, Request, ServeEngine
    cfg = get_config("opt-1.3b").reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    r = np.random.default_rng(2)
    records = [{"step": i, "seed": int(r.integers(2**31)),
                "gs": r.normal(size=2).astype(np.float32).tolist(),
                "lr": 5e-2, "eps": 1e-2} for i in range(3)]
    prompts = [r.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (7, 5, 9, 6, 8)]

    def serve(device, spec_k):
        st = AdapterStore({k: v.to(device) for k, v in params.items()},
                          device=device)
        st.put("alice", records)
        eng = ServeEngine(cfg, st, n_slots=2, max_len=24, paged=True,
                          page_size=4, prefill_chunk=4, spec_k=spec_k,
                          device=device)
        for i, p in enumerate(prompts):
            eng.submit(Request(prompt=p, max_new=9,
                               user="alice" if i % 2 == 0 else None))
        return [c.tokens.tolist() for c in eng.run()]

    before = ops.LAUNCHES["flash_verify"]
    on_card = serve(cuda, 3)
    assert ops.LAUNCHES["flash_verify"] > before
    assert on_card == serve("cpu", 3) == serve("cpu", None)


def test_reduced_engine_on_card_matches_cpu(cuda):
    """The serving engine end to end on reduced OPT-1.3B (f32, head dim
    16): the same weights and adapter serve the same greedy tokens on the
    card (every kernel launched) as on the CPU (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import AdapterStore, Request, ServeEngine
    cfg = get_config("opt-1.3b").reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    r = np.random.default_rng(1)
    records = [{"step": i, "seed": int(r.integers(2**31)),
                "gs": r.normal(size=2).astype(np.float32).tolist(),
                "lr": 5e-2, "eps": 1e-2} for i in range(3)]
    prompts = [r.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (7, 5, 9, 6, 8)]

    def serve(device):
        st = AdapterStore({k: v.to(device) for k, v in params.items()},
                          device=device)
        st.put("alice", records)
        eng = ServeEngine(cfg, st, n_slots=2, max_len=16, paged=True,
                          page_size=4, prefill_chunk=4, device=device)
        for i, p in enumerate(prompts):
            eng.submit(Request(prompt=p, max_new=5,
                               user="alice" if i % 2 == 0 else None))
        return [c.tokens.tolist() for c in eng.run()]

    serving = ("zo_add", "flash_decode", "flash_prefill")
    before = {k: ops.LAUNCHES[k] for k in serving}
    on_card = serve(cuda)
    assert all(ops.LAUNCHES[k] > before[k] for k in serving)
    assert on_card == serve("cpu")


MM_RTOL = {"float32": 2e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("dist", ["rademacher", "gaussian"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", [(7, 33, 130), (32, 64, 128), (33, 64, 256),
                                 (1024, 1024, 4096), (1024, 2048, 8192),
                                 (1024, 2048, 50272)], ids=str)
def test_zo_matmul_matches_plain(cuda, mkn, dtype, dist):
    m, k, n = mkn
    dt = getattr(torch, dtype)
    x = torch.randn((m, k), device=cuda).to(dt)
    w = (torch.randn((k, n), device=cuda) * 0.02).to(dt)
    salt = rng.leaf_salt("lm_head/w")
    before = build.LAUNCHES["zo_matmul"]
    got = ops.zo_matmul(x, w, 99, salt, 1e-3, dist)
    assert build.LAUNCHES["zo_matmul"] == before + 1
    want = zp.zo_matmul_ref(x, w, 99, salt, 1e-3, dist)
    assert got.dtype == dt and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err <= MM_RTOL[dtype], err


def test_zo_matmul_prehashed_slice_matches_stacked_field(cuda):
    seed, salt = 5, rng.leaf_salt("blocks/mlp/w_in/w")
    x = torch.randn((40, 64), device=cuda)
    w = torch.randn((3, 64, 96), device=cuda) * 0.02
    z = rng.z_field(seed, salt, (3, 64, 96), device=cuda)
    for layer in range(3):
        base = rng.fold_leading(rng.leaf_base(seed, salt), layer)
        got = zp.zo_matmul_cuda(x, w[layer], base, 0, 0.5, prime_offset=1,
                                prehashed=True)
        want = x @ (w[layer] + 0.5 * z[layer])
        err = (got - want).abs().max() / want.abs().max()
        assert err <= MM_RTOL["float32"], err


def test_zo_matmul_launcher_rejects_mixed_dtypes(cuda):
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(TypeError, match="one dtype"):
        zp.zo_matmul_cuda(x, torch.zeros((8, 4), device=cuda,
                                         dtype=torch.bfloat16), 1, 2, 0.5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", [(2, 16, 4, 2, 16), (3, 100, 8, 2, 16),
                                   (8, 128, 32, 32, 64), (8, 128, 16, 16, 64),
                                   (1, 40, 2, 1, 128), (1, 33, 2, 2, 256),
                                   (2, 70, 4, 4, 32)], ids=str)
def test_flash_attention_matches_plain(cuda, shape, dtype, atol, causal):
    from repro_torch.kernels import flash_attention as fa
    b, s, h, kvh, hd = shape
    dt = getattr(torch, dtype)
    q = torch.randn((b, s, h, hd), device=cuda).to(dt)
    k = torch.randn((b, s, kvh, hd), device=cuda).to(dt)
    v = torch.randn((b, s, kvh, hd), device=cuda).to(dt)
    before = build.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal)
    assert build.LAUNCHES["flash_attention"] == before + 1
    want = fa.flash_attention_ref(q, k, v, causal)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("dist", ["rademacher", "gaussian"])
@pytest.mark.parametrize("shape", [(5, 9), (7, 33), (3, 17, 129),
                                   (2, 3, 4, 5), (2048, 50272)], ids=str)
def test_zo_add_q_matches_plain(cuda, shape, dist):
    from repro_torch.optim.quant import quantize_leaf
    ql = quantize_leaf(torch.randn(shape, device=cuda) * 0.02)
    seed, salt, coeff = 99, rng.leaf_salt("lm_head/w"), -0.0071
    before = build.LAUNCHES["zo_add_q"]
    got = ops.zo_add(ql.q, seed, salt, coeff, dist, scale=ql.scale)
    assert build.LAUNCHES["zo_add_q"] == before + 1
    want = zp.zo_add_q_ref(ql.q, ql.scale, seed, salt, coeff, dist)
    assert got.dtype == torch.float32
    if dist == "rademacher":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=GAUSS_ATOL)


def test_zo_add_q_prehashed_slice_and_unaligned(cuda):
    from repro_torch.optim.quant import quantize_leaf
    ql = quantize_leaf(torch.randn((4, 8, 40), device=cuda))
    seed, salt = 5, rng.leaf_salt("blocks/attn/wo/w")
    full = zp.zo_add_q_cuda(ql.q, ql.scale, seed, salt, 0.25)
    base = rng.fold_leading(rng.leaf_base(seed, salt), 3)
    part = zp.zo_add_q_cuda(ql.q[3], ql.scale[3], base, 0, 0.25,
                            prime_offset=1, prehashed=True)
    assert torch.equal(part, full[3])
    q = ql.q.reshape(-1)[1:161].reshape(4, 40)   # odd offset: scalar path
    assert torch.equal(zp.zo_add_q_cuda(q, ql.scale[0], seed, salt, 0.25),
                       zp.zo_add_q_ref(q, ql.scale[0], seed, salt, 0.25))


@pytest.mark.parametrize("dist", ["rademacher", "gaussian"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", [(7, 33, 130), (16, 96, 160), (33, 64, 256),
                                 (1024, 2048, 8192), (1024, 2048, 50272)],
                         ids=str)
def test_zo_matmul_q_matches_plain(cuda, mkn, dtype, dist):
    from repro_torch.optim.quant import quantize_leaf
    m, k, n = mkn
    dt = getattr(torch, dtype)
    x = torch.randn((m, k), device=cuda).to(dt)
    ql = quantize_leaf(torch.randn((k, n), device=cuda) * 0.02)
    salt = rng.leaf_salt("lm_head/w")
    before = build.LAUNCHES["zo_matmul_q"]
    got = ops.zo_matmul(x, ql.q, 99, salt, 1e-3, dist, scale=ql.scale)
    assert build.LAUNCHES["zo_matmul_q"] == before + 1
    want = zp.zo_matmul_q_ref(x, ql.q, ql.scale, 99, salt, 1e-3, dist)
    assert got.dtype == dt and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err <= MM_RTOL[dtype], err


def test_zo_matmul_q_prehashed_slice_and_rejects(cuda):
    from repro_torch.optim.quant import quantize_leaf
    seed, salt = 5, rng.leaf_salt("blocks/mlp/w_in/w")
    x = torch.randn((40, 64), device=cuda)
    ql = quantize_leaf(torch.randn((3, 64, 96), device=cuda) * 0.02)
    wp = zp.zo_add_q_ref(ql.q, ql.scale, seed, salt, 0.5)
    for layer in range(3):
        base = rng.fold_leading(rng.leaf_base(seed, salt), layer)
        got = zp.zo_matmul_q_cuda(x, ql.q[layer], ql.scale[layer], base, 0,
                                  0.5, prime_offset=1, prehashed=True)
        want = x @ wp[layer]
        err = (got - want).abs().max() / want.abs().max()
        assert err <= MM_RTOL["float32"], err
    with pytest.raises(TypeError, match="int8"):
        zp.zo_matmul_q_cuda(x, ql.q[0].float(), ql.scale[0], 1, 2, 0.5)
    with pytest.raises(ValueError, match="scale shape"):
        zp.zo_matmul_q_cuda(x, ql.q[0], ql.scale[:2], 1, 2, 0.5)


def test_reduced_frozen_int8_fused_loss_on_card(cuda):
    """The frozen-base fused forward (zo_matmul_q, zo_add) on the card
    equals the CPU's within 1e-4, and the materialized oracle (zo_add_q)
    equals the fused loss within 1e-5 (f32)."""
    from repro_torch.configs import get_config
    from repro_torch.core import PerturbCtx
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    from repro_torch.optim.quant import quantize_tree
    cfg = get_config("opt-1.3b").reduced()
    model = build_model(cfg)
    params = quantize_tree(model.init(torch.Generator().manual_seed(0),
                                      "cpu"))
    batch = {k: torch.from_numpy(v)
             for k, v in next(lm_batches(2, 16, cfg.vocab, seed=1)).items()}
    ctx = PerturbCtx(seed=7, coeff=1e-3)
    cpu = float(model.loss(params, batch, perturb=ctx))
    on_card = {k: v.to(cuda) for k, v in params.items()}
    cbatch = {k: v.to(cuda) for k, v in batch.items()}
    before = dict(ops.LAUNCHES)
    fused = float(model.loss(on_card, cbatch, perturb=ctx))
    assert ops.LAUNCHES["zo_matmul_q"] > before["zo_matmul_q"]
    mat = float(model.loss(ctx.materialize(on_card), cbatch))
    assert ops.LAUNCHES["zo_add_q"] > before["zo_add_q"]
    assert abs(fused - cpu) <= 1e-4 and abs(fused - mat) <= 1e-5


def _train(arch, device, params, tmp, optimizer="mezo-fused",
           quant="none"):
    """3 steps of the reduced config (flash attention) through the
    Trainer on ``device`` from the given initial parameters."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import MezoConfig
    from repro_torch.data.synthetic import lm_batches, sst2_batches
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_config(arch).reduced(), attn_impl="flash")
    gen = sst2_batches if cfg.n_classes else lm_batches
    tcfg = TrainerConfig(optimizer=optimizer,
                         mezo=MezoConfig(eps=1e-3, lr=1e-3), n_steps=3,
                         log_every=1, ckpt_dir=str(tmp), device=device,
                         quant=quant)
    tr = Trainer(cfg, tcfg, gen(2, 16, cfg.vocab, seed=1),
                 log_fn=lambda s: None)
    final = tr.train({k: v.to(device, copy=True)
                      for k, v in params.items()})
    return tr.losses, final


@pytest.mark.parametrize("arch", ["opt-1.3b", "roberta-large"])
def test_reduced_training_on_card_matches_cpu_and_replays(cuda, arch,
                                                          tmp_path):
    from repro_torch.checkpoint import ReplayLog, replay_into
    from repro_torch.configs import get_config
    from repro_torch.core import MezoConfig
    from repro_torch.models import build_model
    params = build_model(get_config(arch).reduced()).init(
        torch.Generator().manual_seed(0), "cpu")
    before = dict(ops.LAUNCHES)
    card_losses, card_final = _train(arch, "cuda", params, tmp_path / "g")
    for name in ("zo_matmul", "flash_attention", "zo_add"):
        assert ops.LAUNCHES[name] > before[name], name
    cpu_losses, _ = _train(arch, "cpu", params, tmp_path / "c")
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=0, atol=1e-4)
    replayed, _ = replay_into(
        {k: v.to(cuda) for k, v in params.items()},
        ReplayLog.read(str(tmp_path / "g" / "replay.jsonl")),
        MezoConfig(eps=1e-3, lr=1e-3))
    for k in card_final:
        assert torch.equal(replayed[k], card_final[k]), k


@pytest.mark.parametrize("optimizer", ["mezo", "mezo-parallel",
                                       "mezo-fused-momentum"])
def test_reduced_strategies_on_card_match_cpu(cuda, optimizer, tmp_path):
    """The in-place walk, the perturbed copies of vmapdir and the momentum
    window on the card give the CPU's losses within 1e-4 (f32)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    params = build_model(get_config("opt-1.3b").reduced()).init(
        torch.Generator().manual_seed(0), "cpu")
    card, _ = _train("opt-1.3b", "cuda", params, tmp_path / "g", optimizer)
    cpu, _ = _train("opt-1.3b", "cpu", params, tmp_path / "c", optimizer)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-4)


def test_reduced_int8_training_on_card_matches_cpu(cuda, tmp_path):
    """--quant int8 on the card: the CPU's losses within 1e-4, the int8
    values and scales bit-frozen, the deltas moved."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim.quant import is_quantized, quantize_tree
    params = build_model(get_config("opt-1.3b").reduced()).init(
        torch.Generator().manual_seed(0), "cpu")
    card, final = _train("opt-1.3b", "cuda", params, tmp_path / "g",
                         quant="int8")
    cpu, _ = _train("opt-1.3b", "cpu", params, tmp_path / "c", quant="int8")
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-4)
    q0 = quantize_tree({k: v.to(cuda) for k, v in params.items()})
    moved = 0.0
    for k, leaf in final.items():
        if is_quantized(leaf):
            assert torch.equal(leaf.q, q0[k].q)
            assert torch.equal(leaf.scale, q0[k].scale)
            moved += float(leaf.delta.abs().sum())
    assert moved > 0.0


def test_reduced_engine_over_int8_base_on_card_matches_cpu(cuda):
    """Serving from one int8 base (a replayed user and the base) gives
    the CPU's greedy tokens on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim.quant import quantize_tree
    from repro_torch.serve import AdapterStore, Request, ServeEngine
    cfg = get_config("opt-1.3b").reduced()
    params = quantize_tree(build_model(cfg).init(
        torch.Generator().manual_seed(0), "cpu"))
    r = np.random.default_rng(2)
    records = [{"step": i, "seed": int(r.integers(2**31)),
                "gs": r.normal(size=2).astype(np.float32).tolist(),
                "lr": 5e-2, "eps": 1e-2} for i in range(3)]
    prompts = [r.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (7, 5, 9, 6)]

    def serve(device):
        st = AdapterStore({k: v.to(device) for k, v in params.items()},
                          device=device)
        st.put("alice", records)
        eng = ServeEngine(cfg, st, n_slots=2, max_len=16, paged=True,
                          page_size=4, prefill_chunk=4, device=device)
        for i, p in enumerate(prompts):
            eng.submit(Request(prompt=p, max_new=5,
                               user="alice" if i % 2 == 0 else None))
        return [c.tokens.tolist() for c in eng.run()]

    assert serve(cuda) == serve("cpu")


# ---------------------------------------------------------------------------
# the user-batched kernels (the multi-tenant step)

U_SEEDS = [42, 7, 1000, 3]
U_COEFFS = [0.125, -0.5, 0.01, 0.0]


@pytest.mark.parametrize("shape", [(), (37,), (5, 9), (3, 17, 129),
                                   (2, 64, 256)], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dist", ["rademacher", "gaussian"])
def test_zo_add_users_matches_plain_and_lone_launches(cuda, shape, dtype,
                                                      dist):
    # Gaussian z in f32 only: a last-ulp difference of logf/cosf could
    # flip a bf16 rounding (the scalar test's convention)
    dt = getattr(torch, dtype) if dist == "rademacher" else torch.float32
    w = (torch.randn((4,) + shape, device=cuda) * 0.02).to(dt)
    salt = rng.leaf_salt("blocks/attn/wq/b")
    before = build.LAUNCHES["zo_add_users"]
    got = ops.zo_add_users(w, U_SEEDS, salt, U_COEFFS, dist)
    assert build.LAUNCHES["zo_add_users"] == before + 1
    want = zp.zo_add_users_ref(w, U_SEEDS, salt, U_COEFFS, dist)
    atol = 0.0 if dist == "rademacher" else GAUSS_ATOL
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    for i in range(4):
        assert torch.equal(got[i], ops.zo_add(w[i], U_SEEDS[i], salt,
                                              U_COEFFS[i], dist))


def test_zo_add_users_strided_shared_and_lanes_in_place(cuda):
    """A layer slice of a stacked (U, L, N) leaf (lane stride L * N), one
    leaf expanded over the lanes (stride 0), unaligned lanes, and an
    in-place update of a lane subset that leaves the others' bits."""
    seed = 17
    stacked = torch.randn((4, 3, 37), device=cuda)
    sl = stacked[:, 1]
    bases = [rng.fold_leading(rng.leaf_base(s, seed), 1) for s in U_SEEDS]
    got = ops.zo_add_users(sl, bases, 0, U_COEFFS, prime_offset=1,
                           prehashed=True)
    for i in range(4):
        assert torch.equal(got[i], ops.zo_add(
            sl[i].contiguous(), bases[i], 0, U_COEFFS[i], prime_offset=1,
            prehashed=True))
    one = torch.randn((37,), device=cuda)
    got = ops.zo_add_users(one.expand(4, 37), U_SEEDS, seed, U_COEFFS)
    for i in range(4):
        assert torch.equal(got[i], ops.zo_add(one, U_SEEDS[i], seed,
                                              U_COEFFS[i]))
    w = torch.randn((4, 8, 33), device=cuda).to(torch.bfloat16)
    keep = w.clone()
    ops.zo_add_users(w, U_SEEDS[:2], seed, U_COEFFS[:2], out=w,
                     lanes=[3, 1])
    assert torch.equal(w[0], keep[0]) and torch.equal(w[2], keep[2])
    assert torch.equal(w[3], ops.zo_add(keep[3], U_SEEDS[0], seed,
                                        U_COEFFS[0]))
    assert torch.equal(w[1], ops.zo_add(keep[1], U_SEEDS[1], seed,
                                        U_COEFFS[1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight", ["shared", "per-lane", "int8"])
@pytest.mark.parametrize("mkn", [(7, 33, 130), (64, 128, 256),
                                 (256, 2048, 8192), (1024, 2048, 50272)],
                         ids=str)
def test_zo_matmul_users_match_plain_and_lone_launches(cuda, mkn, dtype,
                                                       weight):
    m, k, n = mkn
    dt = getattr(torch, dtype)
    x = torch.randn((4, m, k), device=cuda).to(dt)
    kw, kernel = {}, "zo_matmul_users"
    if weight == "per-lane":
        # 4 lanes over 2 W lanes, each a layer slice of (2, 3, K, N)
        w = (torch.randn((2, 3, k, n), device=cuda) * 0.02).to(dt)[:, 1]
        lane_w = [w[i % 2] for i in range(4)]
    else:
        w = (torch.randn((k, n), device=cuda) * 0.02).to(dt)
        if weight == "int8":
            w = torch.randint(-127, 128, (k, n), device=cuda,
                              dtype=torch.int8)
            kw["scale"] = 2.0 ** torch.randint(-12, -6, (n,), device=cuda
                                               ).float()
            kernel = "zo_matmul_users_q"
        lane_w = [w] * 4
    salt = rng.leaf_salt("lm_head/w")
    before = build.LAUNCHES[kernel]
    got = ops.zo_matmul_users(x, w, U_SEEDS, salt, U_COEFFS, **kw)
    assert build.LAUNCHES[kernel] == before + 1
    want = zp.zo_matmul_users_ref(x, w, U_SEEDS, salt, U_COEFFS, **kw)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err <= MM_RTOL[dtype], err
    for i in range(4):
        lone = ops.zo_matmul(x[i].contiguous(), lane_w[i].contiguous(),
                             U_SEEDS[i], salt, U_COEFFS[i], **kw)
        assert torch.equal(got[i], lone), i


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_reduced_train_engine_on_card_bit_equals_lone_trainers(cuda, quant,
                                                               tmp_path):
    """The TrainEngine on the card (3 users on 2 slots, K = 2): each
    user's losses, parameters and replay log equal a lone Trainer's on
    the card at atol 0, through the user kernels only; within 1e-4 of
    the CPU engine's losses."""
    from repro_torch.configs import get_config
    from repro_torch.core import MezoConfig
    from repro_torch.launch.train_fleet import user_batches
    from repro_torch.models import build_model
    from repro_torch.optim.quant import is_quantized
    from repro_torch.runtime import (Trainer, TrainerConfig,
                                     train_multi_tenant)
    from repro_torch.train import TrainJob, derive_user_seed
    cfg = get_config("opt-1.3b").reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    mz = MezoConfig(eps=1e-3, lr=1e-3, n_directions=2)
    users = ["u0", "u1", "u2"]

    def fleet(device):
        jobs = [TrainJob(user=u, batches=user_batches(cfg, u, 2, 8, 0),
                         n_steps=2) for u in users]
        return train_multi_tenant(
            cfg, jobs, n_slots=2, seed=3, mezo_cfg=mz, quant=quant,
            log_dir=str(tmp_path / device), log_fn=lambda s: None,
            device=device, params={k: v.to(device, copy=True)
                                   for k, v in params.items()})

    ops.reset_launches()
    engine, results = fleet("cuda")
    assert ops.LAUNCHES["zo_add_users"] > 0
    assert ops.LAUNCHES["zo_matmul"] == 0
    if quant == "none":
        assert ops.LAUNCHES["zo_matmul_users"] > 0
    for r in results:
        fn = user_batches(cfg, r.user, 2, 8, 0)
        tr = Trainer(cfg, TrainerConfig(
            estimator="fused", update="sgd", mezo=mz, quant=quant,
            n_steps=2, seed=derive_user_seed(3, r.user),
            ckpt_dir=str(tmp_path / f"lone-{r.user}"),
            snapshot_every=10 ** 6, log_every=10 ** 6, device="cuda"),
            iter([fn(t) for t in range(2)]), log_fn=lambda s: None)
        final = tr.train({k: v.to(cuda, copy=True)
                          for k, v in params.items()})
        assert r.losses == tr.losses, r.user
        got = engine.store.materialize(r.user)
        for k, leaf in final.items():
            a = leaf.delta if is_quantized(leaf) else leaf
            b = got[k].delta if is_quantized(leaf) else got[k]
            assert torch.equal(a, b), (r.user, k)
        assert (tmp_path / "cuda" / f"{r.user}.jsonl").read_bytes() == \
            (tmp_path / f"lone-{r.user}" / "replay.jsonl").read_bytes()
    _, cpu_results = fleet("cpu")
    for a, b in zip(results, cpu_results):
        np.testing.assert_allclose(a.losses, b.losses, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the two bodies: bf16 tensor cores (bf16 x, Rademacher z) and SIMT


def _mm_launch(kernel, x, dist, cuda):
    """One launch of ``kernel`` (a zo_matmul entry point) on x's dtype."""
    k, n = x.shape[-1], 136
    salt = rng.leaf_salt("lm_head/w")
    if kernel.endswith("_q"):
        w = torch.randint(-127, 128, (k, n), device=cuda, dtype=torch.int8)
        scale = 2.0 ** torch.randint(-12, -6, (n,), device=cuda).float()
    else:
        w, scale = (torch.randn((k, n), device=cuda) * 0.02).to(x.dtype), None
    if kernel.startswith("zo_matmul_users"):
        return ops.zo_matmul_users(x[None].expand(2, *x.shape).contiguous(),
                                   w, U_SEEDS[:2], salt, U_COEFFS[:2], dist,
                                   scale=scale)
    return ops.zo_matmul(x, w, 3, salt, 1e-3, dist, scale=scale)


@pytest.mark.parametrize("dist", ["rademacher", "gaussian"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["zo_matmul", "zo_matmul_q",
                                    "zo_matmul_users", "zo_matmul_users_q"])
def test_zo_matmul_body_follows_dtype_and_dist(cuda, kernel, dtype, dist):
    """bf16 x with Rademacher z takes the tensor-core body, f32 x or
    Gaussian z the SIMT body, at every entry point; each launch counts
    once, in its body."""
    want = "tc" if (dtype, dist) == ("bfloat16", "rademacher") else "simt"
    other = "simt" if want == "tc" else "tc"
    x = torch.randn((40, 72), device=cuda).to(getattr(torch, dtype))
    before = dict(build.BODIES)
    _mm_launch(kernel, x, dist, cuda)
    assert build.BODIES[f"{kernel}/{want}"] == before[f"{kernel}/{want}"] + 1
    assert build.BODIES[f"{kernel}/{other}"] == before[f"{kernel}/{other}"]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_flash_attention_tensor_core_body_head_dims(cuda, hd, causal):
    """bf16 at every head dim the kernel takes, S = 100 (a ragged last
    query and key tile), GQA 8 over 2: the tensor-core body, within the
    bf16 limit; f32 on the same inputs takes the SIMT body, within
    2e-5."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn((2, 100, 8, hd), device=cuda)
    k = torch.randn((2, 100, 2, hd), device=cuda)
    v = torch.randn((2, 100, 2, hd), device=cuda)
    for dt, atol, body in ((torch.bfloat16, 2e-2, "tc"),
                           (torch.float32, 2e-5, "simt")):
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        before = build.BODIES[f"flash_attention/{body}"]
        got = ops.flash_attention(qd, kd, vd, causal)
        assert build.BODIES[f"flash_attention/{body}"] == before + 1
        want = fa.flash_attention_ref(qd, kd, vd, causal)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=atol)

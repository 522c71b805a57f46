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
matmuls, with every lane equal to a lone tensor-core launch. The other
families: two MoE dispatches at granite-moe's layer shapes are
bit-equal (with and without drops), reduced kimi-k2 (MoE with its shared
expert) runs on the card within 1e-4 of the CPU, and the four attention
kernels hold to their limits at the real configs' heads, KV heads and
head dims (256 MQA, 128 in groups of 4 and 16, 64). ``flash_decode``
takes the slot route at G = 1 (whose entry point refuses G >= 2) and
the split route at G >= 2, where it holds to the same limits at every
real layout, short and long, at pages 16 and 64, each slot's output
bit-equal at B 1 and B 8, its tensor-core body also close to the split
model that rounds P as it does. Shards: ``zo_add``
at a shard's global offsets equals the whole leaf's launch sliced at
atol 0, and ``zo_matmul``'s column- and row-parallel shards hold to its
limits against the whole product.
"""

import ctypes
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import rng  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import zo_perturb as zp  # noqa: E402
from test_torch_zo_matmul_route import route  # noqa: E402

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
                                      (2, 8, 32), (1, 2, 256), (2, 2, 16),
                                      (2, 4, 112), (4, 1, 112)])
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


# (heads, KV heads, head dim) of every config the card serves or trains
# (chip_smoke.py's REAL_HEADS): gemma-2b, qwen3-4b / pixtral / jamba,
# chatglm3 / glm4, granite-moe, whisper-base (G = 1), kimi-k2
REAL_HEADS = [(8, 1, 256), (32, 8, 128), (32, 2, 128), (16, 8, 64),
              (8, 8, 64), (64, 8, 112)]
# B 8 positions: the serving path's short ragged slots and a long context
# (up to 2047), with a slot at 0 and at chunk edges beside them
DECODE_POS = {"short": (8, (95, 110, 127, 40, 0, 63, 64, 17)),
              "long": (128, (2047, 1640, 1480, 1030, 0, 511, 1024, 2000))}


def _decode_case(cuda, h, kvh, hd, dt, case, ps, seed=11):
    """q (8, H, hd) and pools with a scrambled page table at page size
    ``ps``; table width DECODE_POS[case]'s n_live at page 16; trash page
    1e3. Returns q, k, v, pages, pos on the card."""
    n_live16, pos = DECODE_POS[case]
    n_live = n_live16 * 16 // ps
    g = torch.Generator().manual_seed(seed)
    b = len(pos)
    n_pages = 1 + b * n_live + 3
    q = torch.randn((b, h, hd), generator=g)
    k = torch.randn((n_pages, ps, kvh, hd), generator=g)
    v = torch.randn((n_pages, ps, kvh, hd), generator=g)
    k[0], v[0] = 1e3, 1e3
    perm = torch.randperm(n_pages - 1, generator=g) + 1
    pages = torch.zeros((b, n_live), dtype=torch.int32)
    for i, p in enumerate(pos):
        live = 1 + p // ps
        pages[i, :live] = perm[i * n_live:i * n_live + live].to(torch.int32)
    pos = torch.tensor(pos, dtype=torch.int32)
    return [t.to(cuda) for t in (q.to(dt), k.to(dt), v.to(dt), pages, pos)]


@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("case", ["short", "long"])
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("h,kvh,hd", REAL_HEADS, ids=str)
def test_flash_decode_real_heads_batch_invariant(cuda, h, kvh, hd, dtype,
                                                 atol, case, ps):
    """flash_decode at every real layout against its plain version: G >= 2
    on the split route (bf16 at G 8-16 on its tensor-core body), G = 1 on
    the slot route (as ``build.BODIES`` counts); two calls bit-equal; NaN in the trash page and past each
    slot's position leaves the output bit-equal; each slot's output at
    B 1 bit-equal to its row at B 8."""
    q, k, v, pages, pos = _decode_case(cuda, h, kvh, hd, getattr(torch,
                                                              dtype),
                                       case, ps)
    route = "slot" if h == kvh else "split"
    tc = dtype == "bfloat16" and 8 <= h // kvh <= 16
    before = dict(build.BODIES)
    got = ops.paged_decode_attn(q, k, v, pages, pos)
    assert build.BODIES[f"flash_decode/{route}"] == \
        before[f"flash_decode/{route}"] + 1
    assert build.BODIES["flash_decode/split_tc"] == \
        before["flash_decode/split_tc"] + tc
    want = fd.paged_attn_ref(q, k, v, pages, pos)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    assert torch.isfinite(got).all()
    assert torch.equal(fd.flash_decode(q, k, v, pages, pos), got)
    _poison_unread(k, v, pages, pos.tolist())
    assert torch.equal(fd.flash_decode(q, k, v, pages, pos), got)
    for i in range(q.shape[0]):
        one = fd.flash_decode(q[i:i + 1].contiguous(), k, v,
                              pages[i:i + 1].contiguous(),
                              pos[i:i + 1].contiguous())
        assert torch.equal(one[0], got[i]), f"slot {i}"


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("h,kvh,hd", [(32, 32, 64), (8, 8, 64),
                                      (4, 4, 112), (2, 2, 256)], ids=str)
def test_flash_decode_g1_is_the_slot_body(cuda, h, kvh, hd, dtype, atol):
    """G = 1 decodes through the slot route's body, within its limit, and
    only G = 1 does: the slot entry point refuses the same q over half the
    KV heads (G = 2). Its bits against the parent's body are held by
    ``scripts/paged_attn_times.py --g1-bits``."""
    q, k, v, pages, pos = _decode_case(cuda, h, kvh, hd,
                                       getattr(torch, dtype), "short", 16)
    before = dict(build.BODIES)
    got = fd.flash_decode(q, k, v, pages, pos)
    assert build.BODIES["flash_decode/slot"] == \
        before["flash_decode/slot"] + 1
    assert build.BODIES["flash_decode/split"] == before["flash_decode/split"]
    torch.testing.assert_close(got.float(),
                               fd.paged_attn_ref(q, k, v, pages, pos).float(),
                               rtol=0, atol=atol)
    k2, v2 = k[:, :, :kvh // 2].contiguous(), v[:, :, :kvh // 2].contiguous()
    out = torch.empty_like(q)
    launches = build.LAUNCHES["flash_decode"]
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        build.launch("flash_decode", "repro_flash_decode", q.data_ptr(),
                     k2.data_ptr(), v2.data_ptr(), pages.data_ptr(),
                     pos.data_ptr(), out.data_ptr(), fd._DTYPES[q.dtype],
                     q.shape[0], h, kvh // 2, hd, 16, pages.shape[1],
                     hd ** -0.5, torch.cuda.current_stream().cuda_stream)
    assert build.LAUNCHES["flash_decode"] == launches


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("h,kvh,hd", [(8, 1, 256), (64, 8, 112),
                                      (32, 2, 128), (2, 1, 16), (4, 1, 16),
                                      (96, 3, 32)], ids=str)
def test_flash_decode_split_empty_chunks_weigh_nothing(cuda, h, kvh, hd,
                                                       dtype, atol):
    """The split route holds to the plain version at G 2-32 (hd 16 and 32
    too), and its empty chunks weigh nothing: a table 4x wider, its extra
    chunks all past every slot's position, holds to the same limits."""
    q, k, v, pages, pos = _decode_case(cuda, h, kvh, hd,
                                       getattr(torch, dtype), "short", 16)
    want = fd.paged_attn_ref(q, k, v, pages, pos).float()
    torch.testing.assert_close(fd.flash_decode(q, k, v, pages, pos).float(),
                               want, rtol=0, atol=atol)
    wide = torch.zeros((pages.shape[0], 4 * pages.shape[1]),
                       dtype=torch.int32, device=cuda)
    wide[:, :pages.shape[1]] = pages
    torch.testing.assert_close(fd.flash_decode(q, k, v, wide, pos).float(),
                               want, rtol=0, atol=atol)


# chip_smoke.py's limits for the tensor-core split body against its model
# (the output's rounding; P rounded at each 16-key slice's running max
# where the model rounds at the chunk's, noise that averages down over
# more keys)
SPLIT_TC_RTOL, SPLIT_TC_ATOL = 2 ** -8, {"short": 4e-3, "long": 1e-3}


@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("case", ["short", "long"])
@pytest.mark.parametrize("h,kvh,hd", [(8, 1, 256), (64, 8, 112),
                                      (32, 2, 128)], ids=str)
def test_flash_decode_split_tc_holds_to_its_rounded_model(cuda, h, kvh, hd,
                                                          case, ps):
    """bf16 at G 8-16 (the tensor-core split body) against the split model
    with P rounded to bf16 for P V: within the output's rounding plus
    SPLIT_TC_ATOL, far under the 2e-2 limit it also holds to the plain
    version at (outputs of N(0, 1) data over ~1000 keys are ~0.03)."""
    q, k, v, pages, pos = _decode_case(cuda, h, kvh, hd, torch.bfloat16,
                                       case, ps)
    before = build.BODIES["flash_decode/split_tc"]
    got = fd.flash_decode(q, k, v, pages, pos).float()
    assert build.BODIES["flash_decode/split_tc"] == before + 1
    model = fd.paged_attn_split_ref(q, k, v, pages, pos, round_p=True)
    over = (got - model).abs() - SPLIT_TC_RTOL * model.abs()
    assert over.max().item() <= SPLIT_TC_ATOL[case]


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
                                      (2, 2, 16), (2, 4, 112), (1, 1, 112)])
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


@pytest.mark.parametrize("dist", ["rademacher", "gaussian"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zo_add_shard_offsets_equal_the_whole_leafs_slice(cuda, dtype, dist):
    """A stacked leaf split (2, 4) on its last two dims, as a mesh would
    split it: each shard's launch at its offsets equals the whole launch's
    slice at atol 0, and the plain version at offsets holds to the
    kernel's limits."""
    dt = getattr(torch, dtype)
    w = (torch.randn((3, 64, 200), device=cuda) * 0.02).to(dt)
    seed, salt, coeff = 17, rng.leaf_salt("blocks/attn/wq/w"), 0.3
    full = ops.zo_add(w, seed, salt, coeff, dist=dist)
    for i, rows in enumerate(w.chunk(2, dim=1)):
        for j, blk in enumerate(rows.chunk(4, dim=2)):
            offs = (0, 32 * i, 50 * j)
            got = ops.zo_add(blk.contiguous(), seed, salt, coeff, dist=dist,
                             offsets=offs)
            assert torch.equal(got, full[:, 32 * i:32 * (i + 1),
                                         50 * j:50 * (j + 1)])
            want = zp.zo_add_ref(blk.contiguous(), seed, salt, coeff, dist,
                                 offsets=offs)
            if dist == "rademacher":
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=0, atol=GAUSS_ATOL if
                                           dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dist", ["rademacher", "gaussian"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zo_matmul_shard_offsets_column_and_row_parallel(cuda, dtype, dist):
    """Column shards of W (4 ways) give the column slice of the whole
    product, row shards (4 ways, X sliced on K) partial sums that add up
    to it, both within the kernel's limits; the plain version at the same
    offsets holds to them too."""
    m, k, n = 96, 256, 320
    dt = getattr(torch, dtype)
    x = torch.randn((m, k), device=cuda).to(dt)
    w = (torch.randn((k, n), device=cuda) * 0.02).to(dt)
    base = rng.fold_leading(rng.leaf_base(5, rng.leaf_salt("lm_head/w")), 2)
    kw = dict(dist=dist, prime_offset=1, prehashed=True)
    full = ops.zo_matmul(x, w, base, 0, 1e-3, **kw).float()
    scale = full.abs().max()
    for j in range(4):
        c0 = j * n // 4
        wj = w[:, c0:c0 + n // 4].contiguous()
        got = ops.zo_matmul(x, wj, base, 0, 1e-3, offsets=(0, c0), **kw)
        err = (got.float() - full[:, c0:c0 + n // 4]).abs().max() / scale
        assert err <= MM_RTOL[dtype], (j, err)
        want = zp.zo_matmul_ref(x, wj, base, 0, 1e-3, offsets=(0, c0), **kw)
        err = (got.float() - want.float()).abs().max() / scale
        assert err <= MM_RTOL[dtype], (j, err)
    acc = torch.zeros_like(full)
    for i in range(4):
        r0 = i * k // 4
        acc += ops.zo_matmul(x[:, r0:r0 + k // 4].contiguous(),
                             w[r0:r0 + k // 4].contiguous(), base, 0, 1e-3,
                             offsets=(r0, 0), **kw).float()
    err = (acc - full).abs().max() / scale
    assert err <= MM_RTOL[dtype], err


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


def _engine_vs_lone_trainers(cuda, cfg, quant, tmp_path, params):
    """The TrainEngine on the card (3 users on 2 slots, K = 2, 2 steps)
    against a lone Trainer on the card for each user: losses, parameters
    (deltas) and replay-log bytes at atol 0. Returns the engine's results
    and the CPU engine's, for the caller's own checks."""
    from repro_torch.core import MezoConfig
    from repro_torch.launch.train_fleet import user_batches
    from repro_torch.optim.quant import is_quantized
    from repro_torch.runtime import (Trainer, TrainerConfig,
                                     train_multi_tenant)
    from repro_torch.train import TrainJob, derive_user_seed
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
    launches = dict(ops.LAUNCHES)
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
    return launches, results, cpu_results


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_reduced_train_engine_on_card_bit_equals_lone_trainers(cuda, quant,
                                                               tmp_path):
    """The TrainEngine on the card (3 users on 2 slots, K = 2): each
    user's losses, parameters and replay log equal a lone Trainer's on
    the card at atol 0, through the user kernels only; within 1e-4 of
    the CPU engine's losses."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("opt-1.3b").reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    launches, results, cpu_results = _engine_vs_lone_trainers(
        cuda, cfg, quant, tmp_path, params)
    assert launches["zo_add_users"] > 0
    assert launches["zo_matmul"] == 0
    if quant == "none":
        assert launches["zo_matmul_users"] > 0
    for a, b in zip(results, cpu_results):
        np.testing.assert_allclose(a.losses, b.losses, rtol=0, atol=1e-4)


def test_reduced_moe_train_engine_on_card_bit_equals_lone_trainers(
        cuda, tmp_path):
    """Reduced granite-moe-1b-a400m (f32) at a capacity factor that drops
    assignments, through the TrainEngine on the card: each lane's MoE
    dispatch runs alone (its own capacity, its experts materialized by
    ``zo_add``), and each user's losses, parameters and replay log equal
    a lone Trainer's on the card at atol 0; within 1e-4 of the CPU
    engine's losses."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              capacity_factor=0.5)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    launches, results, cpu_results = _engine_vs_lone_trainers(
        cuda, cfg, "none", tmp_path, params)
    assert launches["zo_matmul_users"] > 0 and launches["zo_add"] > 0
    assert launches["zo_matmul"] == 0
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


# ---------------------------------------------------------------------------
# the Hopper tensor-core body (TMA loads, 2-CTA clusters, one n256 wgmma
# over the joint [W | z] tile): bf16 W with 16-byte rows and bases

# (dtype, dist, int8 W, K, N, W lane stride, X base, W base) -> the body
# (0 SIMT, 1 the 256 x 64 tensor-core body, 2 the Hopper body), each
# also route()'s answer (tests/test_torch_zo_matmul_route.py)
ROUTES = {(1, 0, 0, 2048, 2048, 0, 0x1000, 0x2000): 2,
          (1, 0, 0, 8192, 2048, 8192 * 2048 * 2, 0x1000, 0x2000): 2,
          (1, 0, 0, 72, 8, 0, 0x10, 0x20): 2,
          (1, 0, 1, 2048, 2048, 0, 0x1000, 0x2000): 1,
          (1, 0, 0, 33, 2048, 0, 0x1000, 0x2000): 1,
          (1, 0, 0, 2048, 130, 0, 0x1000, 0x2000): 1,
          (1, 0, 0, 2048, 2048, 2048 * 2048 + 4, 0x1000, 0x2000): 1,
          (1, 0, 0, 2048, 2048, 0, 0x1002, 0x2000): 1,
          (1, 0, 0, 2048, 2048, 0, 0x1000, 0x2008): 1,
          (0, 0, 0, 2048, 2048, 0, 0x1000, 0x2000): 0,
          (1, 1, 0, 2048, 2048, 0, 0x1000, 0x2000): 0}


def _route_model(dtype, dist, *rest):
    return route(("float32", "bfloat16")[dtype],
                 ("rademacher", "gaussian")[dist], *rest)


@pytest.mark.parametrize("args", sorted(ROUTES), ids=str)
def test_zo_matmul_body_rule_matches_the_route_model(cuda, args):
    assert build.library().repro_zo_matmul_body(*args) == ROUTES[args]
    assert _route_model(*args) == ROUTES[args]


def test_zo_matmul_body_rule_equals_the_route_model_on_random_launches(cuda):
    """The launcher's rule and the CPU tests' model agree over random
    dtypes, dists, W kinds, K, N, lane strides and base offsets."""
    r = np.random.default_rng(29)
    body = build.library().repro_zo_matmul_body
    seen = set()
    for _ in range(3000):
        k, n = (int(v) * int(r.choice([1, 8]))
                for v in r.integers(1, 1100, 2))
        args = (int(r.integers(2)), int(r.integers(2)), int(r.integers(2)),
                k, n, int(r.choice([0, k * n, k * n + int(r.integers(1, 8))])),
                *(0x10000 + int(v) for v in r.choice([0, 2, 8, 16], 2)))
        got = body(*args)
        assert got == _route_model(*args), args
        seen.add(got)
    assert seen == {0, 1, 2}


# (M a lane, N, lanes), K 64: the OPT cells' tile counts (8192 x 2048 and
# 8192 x 8192 single-lane, 16 lanes of 1024 x 2048), M a multiple of 128
# but not of 256 (a pair with an idle CTA), M <= 128 (every pair's second
# CTA idle), M off 128, N off 128 and under 128, more tiles than the
# card's clusters and fewer
TMA_WALKS = [(8192, 2048, 1), (8192, 8192, 1), (1024, 2048, 16),
             (384, 256, 1), (100, 512, 3), (128, 128, 1), (1, 8, 1),
             (300, 200, 2), (2000, 72, 5), (129, 2048, 16)]


@pytest.mark.parametrize("m,n,lanes", TMA_WALKS, ids=str)
def test_zo_matmul_tma_body_writes_every_output_tile(cuda, m, n, lanes):
    """The Hopper body's persistent walk over the 128 x 128 output tiles
    of every lane (2-CTA clusters on pairs of row tiles, a CTA past M
    idle): Y filled with NaN before the launch holds none after it, and
    every lane is within the bf16 limit of the plain version."""
    k = 64
    gen = torch.Generator(device=cuda).manual_seed(m + n + lanes)
    x = torch.randn((lanes, m, k), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((lanes, k, n), generator=gen, device=cuda) * 0.02
         ).bfloat16()
    seeds = list(range(40, 40 + lanes))
    coeffs = [0.05] * lanes
    salt = rng.leaf_salt("blocks/mlp/w_in/w")
    y = torch.full((lanes, m, n), float("nan"), dtype=torch.bfloat16,
                   device=cuda)
    lib = build.library()
    assert lib.repro_zo_matmul_body(1, 0, 0, k, n, k * n, x.data_ptr(),
                                    w.data_ptr()) == 2
    rc = lib.repro_zo_matmul_users(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), 1, m, k, n, k * n, lanes,
        (ctypes.c_uint32 * lanes)(*[zp._base(s, salt, False) for s in seeds]),
        (ctypes.c_float * lanes)(*coeffs), lanes, 0, 0,
        torch.cuda.current_stream(cuda).cuda_stream)
    assert rc == 0
    torch.cuda.synchronize(cuda)
    assert not torch.isnan(y).any()
    want = zp.zo_matmul_users_ref(x, w, seeds, salt, coeffs)
    err = (y.float() - want.float()).abs().max() / want.float().abs().max()
    assert err <= MM_RTOL["bfloat16"], err


# (M, K, N): OPT-1.3B's fused-cell products at B 16 x S 512 (q/k/v/o,
# w_in, w_out); M a multiple of 128 but not of 256 (a pair's second CTA
# idle); M <= 128 (every second CTA idle) and M 1; N off 128, N 8; K off 64
TMA_SHAPES = [(8192, 2048, 2048), (8192, 2048, 8192), (8192, 8192, 2048),
              (384, 256, 384), (100, 128, 256), (1, 64, 128),
              (512, 256, 200), (300, 72, 8)]


@pytest.mark.parametrize("coeff", [0.0, 0.05])
@pytest.mark.parametrize("mkn", TMA_SHAPES, ids=str)
def test_zo_matmul_tma_body_matches_plain(cuda, mkn, coeff):
    """The Hopper body (as ``BODIES`` counts) within the bf16 limit of
    the plain version, with z at 2.5 times W's scale (and without it: X W
    alone), at the cells' shapes and every edge of its tiles."""
    m, k, n = mkn
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((k, n), generator=gen, device=cuda) * 0.02).bfloat16()
    salt = rng.leaf_salt("blocks/mlp/w_in/w")
    before = dict(build.BODIES)
    got = ops.zo_matmul(x, w, 99, salt, coeff)
    for b in ("tc", "tc_tma"):
        assert build.BODIES[f"zo_matmul/{b}"] == before[f"zo_matmul/{b}"] + 1
    want = zp.zo_matmul_ref(x, w, 99, salt, coeff)
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err <= MM_RTOL["bfloat16"], err


@pytest.mark.parametrize("mkn", [(8192, 2048, 2048), (300, 72, 8)], ids=str)
def test_zo_matmul_tma_body_bits_equal_the_256x64_body(cuda, mkn):
    """The two tensor-core routes take the same k16 steps in the same
    order: X at a base 2 bytes off 16 takes the 256 x 64 body, X at an
    aligned base the Hopper body, and the outputs are equal at atol 0."""
    m, k, n = mkn
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((k, n), generator=gen, device=cuda) * 0.02).bfloat16()
    off = torch.empty(m * k + 1, dtype=torch.bfloat16, device=cuda)[1:]
    x_off = off.view(m, k)
    x_off.copy_(x)
    salt = rng.leaf_salt("blocks/mlp/w_out/w")
    before = dict(build.BODIES)
    got = ops.zo_matmul(x, w, 21, salt, 0.05)
    old = ops.zo_matmul(x_off, w, 21, salt, 0.05)
    assert build.BODIES["zo_matmul/tc_tma"] == before["zo_matmul/tc_tma"] + 1
    assert build.BODIES["zo_matmul/tc"] == before["zo_matmul/tc"] + 2
    assert torch.equal(got, old)


def test_zo_matmul_tma_body_at_large_shard_offsets(cuda):
    """A (256, 200) shard at (row0, col0) = (4096, 12288) of a stacked
    leaf (prime_offset 1): z is the whole leaf's slice there, within the
    bf16 limit of the plain version at the same offsets."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((300, 256), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((256, 200), generator=gen, device=cuda) * 0.02
         ).bfloat16()
    base = rng.fold_leading(rng.leaf_base(5, rng.leaf_salt("lm_head/w")), 3)
    kw = dict(prime_offset=1, prehashed=True, offsets=(4096, 12288))
    before = build.BODIES["zo_matmul/tc_tma"]
    got = ops.zo_matmul(x, w, base, 0, 0.05, **kw)
    assert build.BODIES["zo_matmul/tc_tma"] == before + 1
    want = zp.zo_matmul_ref(x, w, base, 0, 0.05, **kw)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err <= MM_RTOL["bfloat16"], err


def test_zo_matmul_users_tma_body_16_lanes_equal_lone_launches(cuda):
    """The tenants cell's launch: 16 lanes of (1024, 2048) @ (2048, 2048)
    over 8 W lanes, a layer slice of a stacked (8, 2, K, N) state, on the
    Hopper body; within the bf16 limit of the plain version, and every
    lane equal to a lone launch at atol 0."""
    m, k, n = 1024, 2048, 2048
    gen = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn((16, m, k), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((8, 2, k, n), generator=gen, device=cuda) * 0.02
         ).bfloat16()[:, 1]
    seeds = list(range(100, 116))
    coeffs = [0.05 * (i + 1) / 16 * (-1) ** i for i in range(16)]
    salt = rng.leaf_salt("blocks/attn/wq/w")
    before = build.BODIES["zo_matmul_users/tc_tma"]
    got = ops.zo_matmul_users(x, w, seeds, salt, coeffs)
    assert build.BODIES["zo_matmul_users/tc_tma"] == before + 1
    want = zp.zo_matmul_users_ref(x, w, seeds, salt, coeffs)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err <= MM_RTOL["bfloat16"], err
    for i in range(16):
        lone = ops.zo_matmul(x[i].contiguous(), w[i % 8].contiguous(),
                             seeds[i], salt, coeffs[i])
        assert torch.equal(got[i], lone), i


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128, 256])
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


# ---------------------------------------------------------------------------
# the SIMT bodies (f32 x, or Gaussian z; f32 attention): edges, the tile
# the launcher picks, head dims

SIMT_ARMS = [("float32", "rademacher"), ("float32", "gaussian"),
             ("bfloat16", "gaussian")]


def _simt_operands(kernel, m, k, n, dtype, cuda, seed=0):
    """x ((2, M, K) for a users entry point), w or int8 q with its scale,
    from a seeded generator."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    lead = (2,) if kernel.startswith("zo_matmul_users") else ()
    x = torch.randn(lead + (m, k), generator=gen, device=cuda).to(dt)
    if kernel.endswith("_q"):
        w = torch.randint(-127, 128, (k, n), generator=gen, device=cuda,
                          dtype=torch.int8)
        scale = 2.0 ** torch.randint(-12, -6, (n,), generator=gen,
                                     device=cuda).float()
    else:
        w = (torch.randn((k, n), generator=gen, device=cuda) * 0.02).to(dt)
        scale = None
    return x, w, scale


def _simt_call(kernel, x, w, scale, dist, ref=False):
    salt = rng.leaf_salt("blocks/mlp/w_in/w")
    if kernel.startswith("zo_matmul_users"):
        fn = zp.zo_matmul_users_ref if ref else ops.zo_matmul_users
        return fn(x, w, U_SEEDS[:2], salt, U_COEFFS[:2], dist, scale=scale)
    if ref:
        return (zp.zo_matmul_ref(x, w, 11, salt, 1e-3, dist) if scale is None
                else zp.zo_matmul_q_ref(x, w, scale, 11, salt, 1e-3, dist))
    return ops.zo_matmul(x, w, 11, salt, 1e-3, dist, scale=scale)


@pytest.mark.parametrize("mkn", [(1, 64, 64), (37, 33, 50), (64, 64, 2),
                                 (3, 32, 50272), (129, 257, 65),
                                 (300, 100, 130)], ids=str)
@pytest.mark.parametrize("dtype,dist", SIMT_ARMS)
@pytest.mark.parametrize("kernel", ["zo_matmul", "zo_matmul_q",
                                    "zo_matmul_users", "zo_matmul_users_q"])
def test_zo_matmul_simt_edges_match_plain(cuda, kernel, dtype, dist, mkn):
    """The SIMT body at every entry point, f32 and Gaussian, against its
    plain version at M 1, K 33, N 2, N 50272 and M, N, K off every tile
    multiple, within the kernels' limits; each launch on the SIMT body."""
    m, k, n = mkn
    x, w, scale = _simt_operands(kernel, m, k, n, dtype, cuda)
    before = build.BODIES[f"{kernel}/simt"]
    got = _simt_call(kernel, x, w, scale, dist)
    assert build.BODIES[f"{kernel}/simt"] == before + 1
    want = _simt_call(kernel, x, w, scale, dist, ref=True)
    assert got.dtype == x.dtype and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err <= MM_RTOL[dtype], err


@pytest.mark.parametrize("dtype,dist", SIMT_ARMS)
@pytest.mark.parametrize("kernel", ["zo_matmul", "zo_matmul_q"])
def test_zo_matmul_simt_bits_do_not_depend_on_the_tile(cuda, kernel, dtype,
                                                      dist):
    """Rows [:m'] of a product equal the product of X[:m'], and columns
    [:n'] that of W[:, :n'] (and the scales' [:n']), at atol 0, where the
    launcher picks three different tiles for the whole and the parts."""
    m, k, n = 1024, 256, 4096
    x, w, scale = _simt_operands(kernel, m, k, n, dtype, cuda, seed=1)
    full = _simt_call(kernel, x, w, scale, dist)
    tiles = {zp.simt_tile(m, n)}
    for mp in (1, 100, 700):
        tiles.add(zp.simt_tile(mp, n))
        part = _simt_call(kernel, x[:mp].contiguous(), w, scale, dist)
        assert torch.equal(full[:mp], part), mp
    for np_ in (2, 130, 1000):
        tiles.add(zp.simt_tile(m, np_))
        part = _simt_call(kernel, x, w[:, :np_].contiguous(),
                          None if scale is None else scale[:np_].contiguous(),
                          dist)
        assert torch.equal(full[:, :np_], part), np_
    assert len(tiles) >= 3, tiles


@pytest.mark.parametrize("dtype,dist", SIMT_ARMS)
@pytest.mark.parametrize("weight", ["shared", "int8"])
def test_zo_matmul_simt_lane_equals_a_lone_launch_across_tiles(
        cuda, weight, dtype, dist):
    """4 lanes of (1024, 128) @ (128, 1024) take another tile than a lone
    launch of one lane; every lane equals its lone launch at atol 0."""
    kernel = "zo_matmul" if weight == "shared" else "zo_matmul_q"
    _, w, scale = _simt_operands(kernel, 1024, 128, 1024, dtype, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((4, 1024, 128), generator=gen, device=cuda).to(
        getattr(torch, dtype))
    assert zp.simt_tile(1024, 1024, 4) != zp.simt_tile(1024, 1024, 1)
    salt = rng.leaf_salt("lm_head/w")
    got = ops.zo_matmul_users(x, w, U_SEEDS, salt, U_COEFFS, dist,
                              scale=scale)
    for i in range(4):
        lone = ops.zo_matmul(x[i].contiguous(), w, U_SEEDS[i], salt,
                             U_COEFFS[i], dist, scale=scale)
        assert torch.equal(got[i], lone), i


# the tiles csrc/zo_matmul.cu's pick_tile gives a 132-SM card
# (tests/test_torch_zo_matmul_tile.py models it on the CPU)
SIMT_PATH_TILES = {(1024, 1024, 1): (128, 64), (1024, 4096, 1): (256, 128),
                   (8, 2, 1): (64, 64), (1024, 8192, 1): (256, 128),
                   (1024, 50272, 1): (256, 128), (1024, 1024, 4): (256, 128)}


@pytest.mark.parametrize("shape", sorted(SIMT_PATH_TILES), ids=str)
def test_zo_matmul_simt_tile_choice(cuda, shape):
    m, n, lanes = shape
    assert zp.simt_tile(m, n, lanes, 132) == SIMT_PATH_TILES[shape]
    assert zp.simt_tile(m, n, lanes) in zp.SIMT_TILES


@pytest.mark.parametrize("st", [(100, 100), (70, 130), (129, 64), (1, 65),
                                (128, 128)], ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128, 256])
def test_flash_attention_simt_head_dims_gqa_ragged(cuda, hd, causal, st):
    """f32 at every head dim, GQA 8 over 2, ragged S and T (S past T and
    T past S, one row): the SIMT body within 2e-5 of the plain version,
    two calls bit-equal."""
    from repro_torch.kernels import flash_attention as fa
    s, t = st
    gen = torch.Generator(device=cuda).manual_seed(hd + s)
    q = torch.randn((2, s, 8, hd), generator=gen, device=cuda)
    k = torch.randn((2, t, 2, hd), generator=gen, device=cuda)
    v = torch.randn((2, t, 2, hd), generator=gen, device=cuda)
    before = build.BODIES["flash_attention/simt"]
    got = ops.flash_attention(q, k, v, causal)
    assert build.BODIES["flash_attention/simt"] == before + 1
    want = fa.flash_attention_ref(q, k, v, causal)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    assert torch.equal(ops.flash_attention(q, k, v, causal), got)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128, 256])
def test_flash_attention_simt_at_training_scale(cuda, hd, causal):
    """f32 at B 8 x 128, 32 heads over 8 KV heads: 512 blocks, two an SM
    where shared memory allows, causal warps skipping the tiles above
    their rows while others still read them: within 2e-5 of the plain
    version, two calls bit-equal."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=cuda).manual_seed(hd)
    q = torch.randn((8, 128, 32, hd), generator=gen, device=cuda)
    k = torch.randn((8, 128, 8, hd), generator=gen, device=cuda)
    v = torch.randn((8, 128, 8, hd), generator=gen, device=cuda)
    got = ops.flash_attention(q, k, v, causal)
    torch.testing.assert_close(got, fa.flash_attention_ref(q, k, v, causal),
                               rtol=0, atol=2e-5)
    assert torch.equal(ops.flash_attention(q, k, v, causal), got)


# ---------------------------------------------------------------------------
# the zo_add family's grid-stride stream: odometer edges and large lanes


@pytest.mark.parametrize("shape", [(1000, 1), (333, 7), (3, 50272),
                                   (2, 3, 1, 2, 5, 1, 3, 9), (64, 3),
                                   (5, 3, 2)], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zo_add_stream_edges_match_plain(cuda, shape, dtype):
    """Last dimensions 1, 7 and 50272, rank 8, rows shorter than a 16-byte
    vector (3 elements; such leaves take the one-element stream, so no
    vector crosses a row): Rademacher bit-exact, Gaussian (f32) within
    1e-6, and in place."""
    dt = getattr(torch, dtype)
    w = (torch.randn(shape, device=cuda) * 0.02).to(dt)
    seed, salt, coeff = 1234, rng.leaf_salt("blocks/mlp/w_out/w"), 0.0625
    assert torch.equal(zp.zo_add_cuda(w, seed, salt, coeff),
                       zp.zo_add_ref(w, seed, salt, coeff))
    w2 = w.clone()
    zp.zo_add_cuda(w2, seed, salt, coeff, out=w2)
    assert torch.equal(w2, zp.zo_add_ref(w, seed, salt, coeff))
    got = zp.zo_add_cuda(w.float(), seed, salt, -1.0, dist="gaussian")
    want = zp.zo_add_ref(w.float(), seed, salt, -1.0, dist="gaussian")
    torch.testing.assert_close(got, want, rtol=0, atol=GAUSS_ATOL)


@pytest.mark.parametrize("shape", [(3, 20), (5, 7), (2, 3, 50), (9, 36),
                                   (2, 2, 3, 5, 12), (7, 16), (3, 5, 48)],
                         ids=str)
@pytest.mark.parametrize("dist", ["rademacher", "gaussian"])
def test_zo_add_q_n_not_a_multiple_of_16(cuda, shape, dist):
    """zo_add_q with N not a multiple of 16: N % 4 == 0 (four elements a
    vector, their scales one 16-byte load) over several scale rows, and N
    odd (one element a vector, each scale row from the odometer)."""
    from repro_torch.optim.quant import quantize_leaf
    ql = quantize_leaf(torch.randn(shape, device=cuda) * 0.02)
    seed, salt, coeff = 77, rng.leaf_salt("blocks/mlp/w_in/w"), 0.003
    got = zp.zo_add_q_cuda(ql.q, ql.scale, seed, salt, coeff, dist)
    want = zp.zo_add_q_ref(ql.q, ql.scale, seed, salt, coeff, dist)
    atol = 0.0 if dist == "rademacher" else GAUSS_ATOL
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("shape", [(30, 50, 700, 33),
                                   (70, 3, 20, 5, 4, 3, 5, 8), (65536, 260),
                                   (1, 1, 4000000, 1)], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zo_add_family_over_many_grid_strides(cuda, shape, dtype):
    """Leaves of 4-35 M elements, so on the card's resident grid (4
    blocks of 256 an SM) every thread advances its odometer over many
    strides with carries through every digit: zo_add, zo_add_q and
    zo_add_users (with a lane subset in place) stay bit-exact with
    Rademacher z."""
    from repro_torch.optim.quant import quantize_leaf
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = math.prod(shape)
    vec = 16 // torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    vec = vec if shape[-1] % vec == 0 else 1
    assert n // vec >= 8 * sms * 4 * 256          # >= 8 strides a thread
    dt = getattr(torch, dtype)
    w = (torch.randn(shape, device=cuda) * 0.02).to(dt)
    seed, salt, coeff = 31, rng.leaf_salt("blocks/attn/wv/w"), -0.125
    assert torch.equal(zp.zo_add_cuda(w, seed, salt, coeff),
                       zp.zo_add_ref(w, seed, salt, coeff))
    ql = quantize_leaf(w.float())
    assert torch.equal(zp.zo_add_q_cuda(ql.q, ql.scale, seed, salt, coeff),
                       zp.zo_add_q_ref(ql.q, ql.scale, seed, salt, coeff))
    del ql
    stack = torch.stack([w, w * 2, w * 3])
    keep = stack.clone()
    zp.zo_add_users_cuda(stack, U_SEEDS[:2], salt, U_COEFFS[:2], out=stack,
                         lanes=[2, 0])
    assert torch.equal(stack[1], keep[1])
    assert torch.equal(stack[2], zp.zo_add_ref(keep[2], U_SEEDS[0], salt,
                                               U_COEFFS[0]))
    assert torch.equal(stack[0], zp.zo_add_ref(keep[0], U_SEEDS[1], salt,
                                               U_COEFFS[1]))


def test_zo_add_users_lane_past_2_31_elements(cuda):
    """3 bf16 lanes of (2^15 + 1) x (2^15 + 5) elements (~6.4 GB): the
    last lane starts past element 2^31 (int64 lane offsets). Every lane
    equals a lone zo_add launch, and the last lane's first and last rows
    equal the plain field at their offsets."""
    rows, cols = 2 ** 15 + 1, 2 ** 15 + 5
    w = torch.empty((3, rows, cols), dtype=torch.bfloat16, device=cuda)
    w.normal_(0.0, 0.02)
    assert 2 * rows * cols > 2 ** 31
    salt, seeds, coeffs = rng.leaf_salt("lm_head/w"), [5, 6, 7], [
        0.01, -0.02, 0.03]
    out = zp.zo_add_users_cuda(w, seeds, salt, coeffs)
    for i in (2, 0, 1):
        assert torch.equal(out[i], zp.zo_add_cuda(w[i], seeds[i], salt,
                                                  coeffs[i]))
    for r0 in (0, rows - 3):
        z = zp.tile_z(seeds[2], salt, (3, cols), r0, 0, "rademacher",
                      device=cuda)
        c = torch.tensor(coeffs[2], dtype=torch.float32, device=cuda)
        want = (w[2, r0:r0 + 3].float() + c * z).to(torch.bfloat16)
        assert torch.equal(out[2, r0:r0 + 3], want)


# ---------------------------------------------------------------------------
# flash_verify: the tensor-core body (bf16) and the SIMT body (f32)


@pytest.mark.parametrize("w,g", [(1, 4), (4, 1), (2, 8), (8, 2), (15, 1),
                                 (17, 1), (4, 16), (8, 8), (100, 1)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
def test_flash_verify_bodies_windows_and_rows(cuda, w, g, dtype, atol):
    """W in {1, 2, 4, 8, 15, 17, 100} and W * G in {4, 15, 16, 17, 64,
    100}: bf16 runs on the tensor-core body and f32 on the SIMT body,
    each launch counted once in its body; within the limit; two calls give
    the same bits; NaN where no row reads stays out."""
    from repro_torch.kernels import flash_verify as fv
    dt = getattr(torch, dtype)
    kvh, hd = 2, 64
    n_live = 1 + (max(RAGGED_POS) + w - 1) // PS + 1
    q, k, v, pages, pos = [t.to(cuda) for t in _case(
        8, 4, w, kvh * g, kvh, hd, n_live, RAGGED_POS, garbage=1e3)]
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    body = "tc" if dtype == "bfloat16" else "simt"
    before = dict(build.BODIES)
    got = ops.paged_verify_attn(q, k, v, pages, pos)
    moved = {b: build.BODIES[f"flash_verify/{b}"]
             - before[f"flash_verify/{b}"] for b in ("tc", "simt")}
    assert moved == {body: 1, ("simt" if body == "tc" else "tc"): 0}
    want = fv.verify_attn_ref(q, k, v, pages, pos)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    assert torch.equal(fv.flash_verify(q, k, v, pages, pos), got)
    _poison_unread(k, v, pages, [int(p) + w - 1 for p in pos.tolist()])
    assert torch.equal(fv.flash_verify(q, k, v, pages, pos), got)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
def test_flash_verify_window_past_the_table(cuda, dtype, atol):
    """An idle slot's stale pos puts pos + W - 1 past its table's last
    position n_live * ps - 1: its rows read every live position and
    nothing more, as the plain version does."""
    from repro_torch.kernels import flash_verify as fv
    dt = getattr(torch, dtype)
    w, n_live = 4, 3
    pos = (PS, 3 * PS - 2, 40 * PS, 3 * PS)      # slots 1-3 past the table
    q, k, v, pages, _ = [t.to(cuda) for t in _case(
        9, 4, w, 4, 2, 64, n_live, (0, 0, 0, 0), garbage=1e3)]
    pages[:, :] = torch.arange(1, 1 + 4 * n_live, device=cuda,
                               dtype=torch.int32).reshape(4, n_live)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    got = fv.flash_verify(q, k, v, pages, pos)
    want = fv.verify_attn_ref(q, k, v, pages, pos)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    k[0], v[0] = float("nan"), float("nan")
    assert torch.equal(fv.flash_verify(q, k, v, pages, pos), got)


@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128, 256])
def test_flash_verify_tensor_core_body_head_dims(cuda, hd):
    """bf16 at every head dim the kernel takes (W 4, GQA 8 over 2, page
    8, ragged positions): the tensor-core body within the bf16 limit,
    two calls bit-equal."""
    from repro_torch.kernels import flash_verify as fv
    q, k, v, pages, pos = [t.to(cuda) for t in _case(
        10, 4, 4, 8, 2, hd, 6, RAGGED_POS, garbage=1e3)]
    q, k, v = q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(
        torch.bfloat16)
    before = build.BODIES["flash_verify/tc"]
    got = fv.flash_verify(q, k, v, pages, pos)
    assert build.BODIES["flash_verify/tc"] == before + 1
    want = fv.verify_attn_ref(q, k, v, pages, pos)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)
    assert torch.equal(fv.flash_verify(q, k, v, pages, pos), got)


# ---------------------------------------------------------------------------
# the other model families (MoE, the real configs' head dims and groups)

# (name, heads, KV heads, head dim) of the configs whose attention the
# other families' paths run: gemma-2b (MQA, 256), qwen3-4b / pixtral-12b /
# jamba (groups of 4, 128), chatglm3-6b / glm4-9b (groups of 16, 128),
# whisper-base (64), kimi-k2-1t-a32b (groups of 8, 112)
REAL_GQA = [("gemma-2b", 8, 1, 256), ("qwen3-4b", 32, 8, 128),
            ("glm4-9b", 32, 2, 128), ("whisper-base", 8, 8, 64),
            ("kimi-k2-1t-a32b", 64, 8, 112)]


def test_moe_dispatch_is_bit_equal_across_calls(cuda):
    """granite-moe-1b-a400m's layer shapes (32 experts, top 8, bf16, B 8 x
    128): two dispatches of one input give the same bits (no atomics in
    dispatch or combine), and drops change nothing between calls."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("granite-moe-1b-a400m")
    g = torch.Generator(device=cuda).manual_seed(3)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_dff
    p = {"router": torch.randn((d, e), generator=g, device=cuda) * 0.02,
         "w_in": (torch.randn((e, d, f, 2), generator=g, device=cuda)
                  * 0.02).bfloat16(),
         "w_out": (torch.randn((e, f, d), generator=g, device=cuda)
                   * 0.02).bfloat16()}
    x = torch.randn((8, 128, d), generator=g, device=cuda).bfloat16()
    for cf in (cfg.capacity_factor, 0.25):
        c = dataclasses.replace(cfg, capacity_factor=cf)
        a, aux_a = moe.moe_apply(c, p, x)
        b, aux_b = moe.moe_apply(c, p, x)
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_reduced_kimi_on_card_matches_cpu(cuda):
    """Reduced kimi-k2-1t-a32b (MoE with its shared expert, f32): the
    forward logits and the fused loss on the card (``zo_matmul``, the
    experts through ``zo_add``) within 1e-4 of the CPU's plain run."""
    from repro_torch.configs import get_config
    from repro_torch.core import PerturbCtx
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import build_model
    cfg = get_config("kimi-k2-1t-a32b").reduced()
    assert cfg.n_shared_experts
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 12)))
    batch = {"tokens": toks, "targets": toks.roll(-1, dims=1)}
    on = {k: v.to(cuda) for k, v in params.items()}
    ctx = PerturbCtx(seed=17, coeff=1e-3)
    want, _ = model.forward(params, batch)
    got, _ = model.forward(on, {k: v.to(cuda) for k, v in batch.items()})
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    before = dict(kbuild.LAUNCHES)
    got = model.loss(on, {k: v.to(cuda) for k, v in batch.items()},
                     perturb=ctx)
    assert kbuild.LAUNCHES["zo_matmul"] > before["zo_matmul"]
    assert kbuild.LAUNCHES["zo_add"] > before["zo_add"]
    want = model.loss(params, batch, perturb=ctx)
    assert abs(got.item() - want.item()) <= 1e-4


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("arch,h,kvh,hd", REAL_GQA, ids=lambda v: str(v))
def test_attention_kernels_at_real_heads(cuda, arch, h, kvh, hd, dtype,
                                         atol):
    """The four attention kernels at the heads, KV heads and head dims of
    the real configs: ``flash_attention`` (B 2, S 128, causal),
    ``flash_decode``, ``flash_prefill`` (a 32-token chunk) and
    ``flash_verify`` (W 4) over pages of 16 against their plain
    versions."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_verify as fv
    dt = getattr(torch, dtype)
    q = torch.randn((2, 128, h, hd), device=cuda).to(dt)
    k = torch.randn((2, 128, kvh, hd), device=cuda).to(dt)
    v = torch.randn((2, 128, kvh, hd), device=cuda).to(dt)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, True).float(),
        fa.flash_attention_ref(q, k, v, True).float(), rtol=0, atol=atol)
    for c, kernel, ref in ((1, ops.paged_decode_attn, fd.paged_attn_ref),
                           (32, ops.paged_prefill_attn, fp.prefill_attn_ref),
                           (4, ops.paged_verify_attn, fv.verify_attn_ref)):
        q, k, v, pages, pos = [t.to(cuda) for t in _case(
            9, 4, c, h, kvh, hd, 10, (95, 110, 127, 40), garbage=1e3,
            ps=16)]
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        if c == 1:
            q = q[:, 0].contiguous()
        torch.testing.assert_close(
            kernel(q, k, v, pages, pos).float(),
            ref(q, k, v, pages, pos).float(), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the fleet, the stale-sgd rule, the gradient baseline, the data pipeline


def test_fleet_on_card_matches_cpu(cuda, tmp_path):
    """Reduced gemma-2b (f32) through the fleet on the card: the CPU's
    schedule event for event, losses within 1e-4, every update's gs
    within 1e-3, and the card's log replays to its live parameters at
    atol 0 (``zo_matmul`` and ``zo_add`` launched)."""
    from repro_torch.checkpoint.replay_log import ReplayLog, replay_into
    from repro_torch.configs import get_config
    from repro_torch.core import MezoConfig
    from repro_torch.kernels import build as kbuild
    from repro_torch.runtime.fleet import FaultSpec, FleetSim, WorkerSpec
    cfg = get_config("gemma-2b").reduced()
    mz = MezoConfig(lr=1e-3, n_directions=2, staleness_decay=0.95)
    workers = [WorkerSpec("flagship", FaultSpec(jitter=0.2,
                                                duplicate_every=2)),
               WorkerSpec("flagship", FaultSpec(jitter=0.2)),
               WorkerSpec("flagship", FaultSpec(latency_scale=5.0))]
    from repro_torch.models import build_model
    theta0 = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    reps, sims = {}, {}
    for dev in ("cpu", "cuda"):
        before = dict(kbuild.LAUNCHES)
        sims[dev] = FleetSim(cfg, workers, total_steps=10, mezo_cfg=mz,
                             device=dev, log_path=str(tmp_path / dev),
                             params={k: v.to(dev) for k, v in
                                     theta0.items()},
                             step_events=[(3, "join", WorkerSpec()),
                                          (6, "leave", 1)])
        reps[dev] = sims[dev].run()
    assert kbuild.LAUNCHES["zo_matmul"] > before["zo_matmul"]
    assert kbuild.LAUNCHES["zo_add"] > before["zo_add"]
    c, g = reps["cpu"], reps["cuda"]
    keys = ("step", "seed", "staleness")
    assert ([[r[k] for k in keys] for r in c.records]
            == [[r[k] for k in keys] for r in g.records])
    assert (c.dropped, c.reissued, c.resizes, c.virtual_s) == (
        g.dropped, g.reissued, g.resizes, g.virtual_s)
    np.testing.assert_allclose(g.losses, c.losses, rtol=0, atol=1e-4)
    np.testing.assert_allclose([r["gs"] for r in g.records],
                               [r["gs"] for r in c.records], rtol=0,
                               atol=1e-3)
    replayed, _ = replay_into(sims["cuda"].base_params,
                              ReplayLog.read(str(tmp_path / "cuda")), mz)
    for k, v in g.params.items():
        assert torch.equal(replayed[k], v), k


def test_fleet_evaluation_of_strided_host_slices(cuda, monkeypatch):
    """What broke the fleet's first full-width run, repeated: a lease's
    evaluation (``FleetSim._evaluate``'s device work) fed the strided
    int32 slices of one (B, S + 1) host draw -- ``tokens`` and
    ``targets`` -- moved to the card as they are, without the contiguous
    copy ``_evaluate`` makes first, at OPT-1.3B's vocabulary and FL1's
    B 8 x 128 (the width reduced), 200 times, each with a fresh draw
    freed right after the move: every id the embedding and the cross
    entropy gather is inside the vocabulary on the card, the moved arrays
    equal the host's, and the gs equal those of the contiguous copies at
    atol 0. Run it under ``CUDA_LAUNCH_BLOCKING=1`` (and compute-sanitizer
    where it works) to place a fault at its launch."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import MezoConfig
    from repro_torch.core.engine import _f32
    from repro_torch.models import layers, runtime
    from repro_torch.runtime.fleet import (FleetSim, WorkerSpec,
                                           default_batches)
    cfg = dataclasses.replace(get_config("opt-1.3b").reduced(),
                              vocab=50272, max_seq=128)
    sim = FleetSim(cfg, [WorkerSpec()], total_steps=1, device="cuda",
                   mezo_cfg=MezoConfig(n_directions=2), batch=8, seq=128)
    seen = []

    def embed(cfg_, p, tokens, *a, **kw):
        seen.append(torch.stack([tokens.min(), tokens.max()]))
        return orig_embed(cfg_, p, tokens, *a, **kw)

    def xent(logits, targets, mask=None):
        seen.append(torch.stack([targets.min(), targets.max()]))
        return orig_xent(logits, targets, mask)

    orig_embed, orig_xent = layers.embed_apply, runtime.softmax_xent
    monkeypatch.setattr(layers, "embed_apply", embed)
    monkeypatch.setattr(runtime, "softmax_xent", xent)
    draw = default_batches(cfg, 8, 128, 0)
    eps = _f32(None, sim.cfg.eps)              # as _evaluate passes it
    for step in range(200):
        host = draw(step)
        assert not host["targets"].flags.c_contiguous
        strided = {k: torch.as_tensor(v).to(cuda) for k, v in host.items()}
        dense = {k: torch.as_tensor(np.ascontiguousarray(v)).to(cuda)
                 for k, v in host.items()}
        want = {k: np.array(v) for k, v in host.items()}
        del host
        seen.clear()
        _, gs, _ = sim._eval_fn(sim.model.loss, sim.base_params, strided,
                                step, sim.cfg, eps=eps)
        _, gs_dense, _ = sim._eval_fn(sim.model.loss, sim.base_params,
                                      dense, step, sim.cfg, eps=eps)
        ranges = torch.stack(seen).cpu()
        assert int(ranges.min()) >= 0 and int(ranges.max()) < cfg.vocab, (
            step, ranges.tolist())
        for k, v in strided.items():
            assert np.array_equal(v.cpu().numpy(), want[k]), (step, k)
        assert torch.equal(gs, gs_dense), step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stale_sgd_replay_on_card_bit_equal_cpu(cuda, dtype):
    """A mixed log (synchronous, stale, masked records) replayed on the
    card equals the CPU's replay bit for bit (Rademacher z: the
    coefficients are host f32, ``zo_add`` is exact)."""
    from repro_torch.checkpoint.replay_log import replay_into
    from repro_torch.core import MezoConfig
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(5)
    params = {"a/w": (torch.randn((64, 48), generator=g) * 0.02).to(dt),
              "b": torch.randn((37,), generator=g).to(dt)}
    recs = [dict(step=0, seed=3, gs=[0.5, -0.25], lr=1e-2, eps=1e-3),
            dict(step=2, seed=9, gs=[1.5, 0.75], lr=1e-2, eps=1e-3,
                 staleness=4, mask=[1.0, 0.0]),
            dict(step=1, seed=4, gs=[-2.0, 0.125], lr=1e-2, eps=1e-3,
                 staleness=1)]
    mz = MezoConfig(n_directions=2, staleness_decay=0.8)
    want, _ = replay_into(params, recs, mz)
    got, _ = replay_into({k: v.to(cuda) for k, v in params.items()}, recs,
                         mz)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


def test_adam_on_card_matches_cpu(cuda):
    """Reduced OPT-1.3B (f32): autograd's loss and gradients on the card
    within 1e-4 of the CPU's (cuBLAS vs CPU summation order); two Adam
    updates from the same gradients within 1e-6 of the CPU's (a gradient
    near 0 may flip its sign between the two devices, and Adam scales it
    to a step of lr, so the steps are compared on one gradient); flash
    attention under a gradient raises on the card as on the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models import build_model
    from repro_torch.optim import adam
    cfg = get_config("opt-1.3b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in next(lm_batches(2, 16, cfg.vocab, seed=0)).items()}
    on = {k: v.to(cuda) for k, v in params.items()}
    ob = {k: v.to(cuda) for k, v in batch.items()}
    lc, gc = adam.value_and_grad(model.loss, params, batch)
    lg, gg = adam.value_and_grad(model.loss, on, ob)
    assert abs(lc.item() - lg.item()) <= 1e-4
    for k in gc:
        torch.testing.assert_close(gg[k].cpu(), gc[k], rtol=1e-3,
                                   atol=1e-4)
    sc, sg = adam.adam_init(params), adam.adam_init(on)
    acfg = adam.AdamConfig(lr=1e-3, weight_decay=0.01)
    for _ in range(2):
        params, sc = adam.adam_update(params, gc, sc, acfg)
        on, sg = adam.adam_update(on, {k: v.to(cuda) for k, v in gc.items()},
                                  sg, acfg)
    for k in params:
        torch.testing.assert_close(on[k].cpu(), params[k], rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(sg.nu[k].cpu(), sc.nu[k], rtol=1e-6,
                                   atol=0)
    flash = build_model(dataclasses.replace(cfg, attn_impl="flash"))
    with pytest.raises(RuntimeError, match="no backward"):
        adam.value_and_grad(flash.loss, on, ob)


def test_data_pipeline_to_card(cuda):
    """Batches placed through pinned memory on the pipeline's stream equal
    the host's, read at once on the consumer's (default and side)
    stream; close() joins; next() after close() raises."""
    from repro_torch.data import DataPipeline, lm_batches
    host = list(lm_batches(8, 128, 50272, seed=2, n_steps=5))
    side = torch.cuda.Stream()
    for stream in (torch.cuda.current_stream(), side):
        with torch.cuda.stream(stream):
            pipe = DataPipeline(lm_batches(8, 128, 50272, seed=2,
                                           n_steps=5), device=cuda)
            sums = [b["tokens"].to(torch.int64).sum() for b in pipe]
        torch.cuda.synchronize()
        assert [int(s) for s in sums] == [
            int(h["tokens"].astype(np.int64).sum()) for h in host]
    pipe = DataPipeline(lm_batches(8, 128, 50272, seed=2, n_steps=3),
                        device=cuda)
    for b, h in zip(pipe, host):
        assert b["tokens"].is_cuda
        assert torch.equal(b["targets"].cpu(), torch.from_numpy(h["targets"]))
    pipe = DataPipeline(lm_batches(8, 128, 50272, seed=2, n_steps=3),
                        device=cuda, prefetch=1)
    next(pipe)
    pipe.close()
    assert not pipe._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        next(pipe)


SCAN_F32_RTOL = 1e-4    # of max|y|: fast exp (ex2.approx) and FMA
#                         contraction against the plain version's exact
#                         exp, carried through the recurrence
SCAN_BF16_RTOL = 2e-2   # of each |y|: four bf16 roundings (2^-8 each) lie
#                         between the two, three in the plain version (C.h
#                         + D x, silu(z), their product), one in the kernel
SCAN_BF16_RMS = 1e-3    # of rms(y): the f32 differences where y is near 0


def _scan_close(got, want, dtype):
    """y within the f32 limit of max|y|, or in bf16 element by element."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if dtype == torch.float32:
        return err.max().item() <= SCAN_F32_RTOL * want.abs().max().item()
    rms = want.square().mean().sqrt().item()
    return bool((err <= SCAN_BF16_RTOL * want.abs() + SCAN_BF16_RMS * rms)
                .all())


def _scan_case(device, bsz, s, di, n, dtype, h0, seed=5):
    """Scan inputs at a Mamba layer's scales: x and z a views of one
    in_proj-shaped (B, S, 2 di) output (z strided), dt before its bias."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).to(device)
    xz = rnd(bsz, s, 2 * di).to(dtype)
    x, z = xz[..., :di].contiguous(), xz[..., di:]
    a_log = (torch.log(torch.arange(1, n + 1, dtype=torch.float32))
             .expand(di, n).to(device) + rnd(di, n, std=0.05))
    args = (x, rnd(bsz, s, di, std=0.3), rnd(di, std=0.1).to(dtype), a_log,
            rnd(bsz, s, n), rnd(bsz, s, n), 1.0 + rnd(di, std=0.1), z)
    return args, (rnd(bsz, di, n) if h0 else None)


@pytest.mark.parametrize("h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_matches_plain_at_jamba_widths(cuda, dtype, h0):
    """d_inner 8192, d_state 16, S 4096 (the benchmark's Jamba cell): y and
    the last state within the f32 (bf16) limit of the plain scan, with
    and without an initial state; no (B, S, di, n) tensor is allocated
    (the allocator's peak over the call)."""
    from repro_torch.kernels import selective_scan as ss
    dt = getattr(torch, dtype)
    args, h0 = _scan_case(cuda, 2, 4096, 8192, 16, dt, h0)
    want_y, want_h = ss.selective_scan_ref(*args, h0=h0)
    before = build.LAUNCHES["selective_scan"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y, h = ops.selective_scan(*args, h0=h0)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert build.LAUNCHES["selective_scan"] == before + 1
    state_bytes = 2 * 4096 * 8192 * 16 * 4
    assert extra <= y.numel() * y.element_size() + (64 << 20), extra
    assert extra < state_bytes // 8
    err = (y.float() - want_y.float()).abs().max().item()
    scale = want_y.float().abs().max().item()
    print(f"selective_scan {dtype} h0={h0 is not None}: max|dy| {err:.3e} "
          f"of max|y| {scale:.3e}; max|dh| "
          f"{(h - want_h).abs().max().item():.3e} of "
          f"{want_h.abs().max().item():.3e}")
    assert _scan_close(y, want_y, dt)
    assert (h - want_h).abs().max().item() <= SCAN_F32_RTOL * \
        want_h.abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_lanes_equal_their_own_launches(cuda, dtype):
    """Leaves per lane (the user-axis forward's: 3 lanes of 2 rows): one
    launch equals each lane's launch on its rows with its leaves bit for
    bit, and the plain version (lane by lane) within the limits."""
    from repro_torch.kernels import selective_scan as ss
    dt, u, rows = getattr(torch, dtype), 3, 2
    args, h0 = _scan_case(cuda, u * rows, 300, 256, 16, dt, True)
    x, dtr, bias, a_log, bmat, cmat, d, z = args
    g = torch.Generator(device="cpu").manual_seed(9)
    jitter = [(torch.randn(t.shape, generator=g) * 0.05).to(cuda)
              for t in (bias, a_log, d)]
    lanes = [torch.stack([t.float() + i * j for i in range(u)])
             for t, j in zip((bias, a_log, d), jitter)]
    before = build.LAUNCHES["selective_scan"]
    y, h = ops.selective_scan(x, dtr, lanes[0], lanes[1], bmat, cmat,
                              lanes[2], z, h0=h0)
    assert build.LAUNCHES["selective_scan"] == before + 1
    for i in range(u):
        r = slice(i * rows, (i + 1) * rows)
        yi, hi = ops.selective_scan(x[r], dtr[r], lanes[0][i], lanes[1][i],
                                    bmat[r], cmat[r], lanes[2][i], z[r],
                                    h0=h0[r])
        assert torch.equal(y[r], yi) and torch.equal(h[r], hi), i
    want_y, want_h = ss.selective_scan_ref(x, dtr, lanes[0], lanes[1], bmat,
                                           cmat, lanes[2], z, h0=h0)
    assert _scan_close(y, want_y, dt)
    assert (h - want_h).abs().max().item() <= SCAN_F32_RTOL * \
        want_h.abs().max().item()


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("shape", [(3, 37, 200), (1, 1, 129), (2, 9, 128)],
                         ids=str)
def test_selective_scan_ragged_edges(cuda, shape, n):
    """Channels off the block's 128, lengths off the 8-step chunk, one
    step (decode), every state width the kernel is built for."""
    from repro_torch.kernels import selective_scan as ss
    for h0 in (False, True):
        args, h0 = _scan_case(cuda, *shape, n, torch.float32, h0)
        want_y, want_h = ss.selective_scan_ref(*args, h0=h0)
        y, h = ops.selective_scan(*args, h0=h0)
        torch.cuda.synchronize()
        assert (y - want_y).abs().max().item() <= SCAN_F32_RTOL * \
            want_y.abs().max().item()
        assert (h - want_h).abs().max().item() <= SCAN_F32_RTOL * \
            want_h.abs().max().item()

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
bf16 (the plain version rounds probabilities to bf16).
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


def _case(seed, b, c, h, kvh, hd, n_live, pos, garbage):
    """Queries + pools with a scrambled page table (page 0 = trash, filled
    with ``garbage``), covering positions pos .. pos + c - 1."""
    r = np.random.default_rng(seed)
    n_pages = 1 + b * n_live + 3
    q = r.normal(size=(b, c, h, hd)).astype(np.float32)
    k = r.normal(size=(n_pages, PS, kvh, hd)).astype(np.float32)
    v = r.normal(size=(n_pages, PS, kvh, hd)).astype(np.float32)
    k[0] = garbage
    v[0] = garbage
    pos = np.asarray(pos, np.int32)
    perm = r.permutation(np.arange(1, n_pages))
    pages = np.zeros((b, n_live), np.int32)
    for i in range(b):
        live = 1 + (pos[i] + c - 1) // PS
        pages[i, :live] = perm[i * n_live:i * n_live + live]
    return [torch.from_numpy(a) for a in (q, k, v, pages, pos)]


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("kvh,g,hd", [(1, 4, 64), (2, 2, 128), (4, 1, 64),
                                      (2, 8, 32), (1, 2, 256), (2, 2, 16)])
@pytest.mark.parametrize("c", [1, 3, 2 * PS + 3])
def test_attention_kernels_match_plain(cuda, dtype, atol, kvh, g, hd, c):
    dt = getattr(torch, dtype)
    q, k, v, pages, pos = [t.to(cuda) for t in _case(
        5, 4, c, kvh * g, kvh, hd, 6, RAGGED_POS, garbage=1e3)]
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    got = ops.paged_prefill_attn(q, k, v, pages, pos)
    want = fp.prefill_attn_ref(q, k, v, pages, pos)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    if c == 1:
        dq = q[:, 0].contiguous()
        got_d = ops.paged_decode_attn(dq, k, v, pages, pos)
        want_d = fd.paged_attn_ref(dq, k, v, pages, pos)
        torch.testing.assert_close(got_d.float(), want_d.float(), rtol=0,
                                   atol=atol)
    # NaN in the trash page is never read
    k[0], v[0] = float("nan"), float("nan")
    assert torch.equal(fp.flash_prefill(q, k, v, pages, pos), got)


def test_attention_launchers_reject_what_they_do_not_take(cuda):
    q, k, v, pages, pos = [t.to(cuda) for t in _case(
        1, 2, 1, 4, 2, 24, 2, (1, 3), garbage=0.0)]
    with pytest.raises(ValueError, match="head_dim 24"):
        fd.flash_decode(q[:, 0].contiguous(), k, v, pages, pos)
    with pytest.raises(TypeError, match="int32"):
        fp.flash_prefill(q, k, v, pages.long(), pos)


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

    before = dict(ops.LAUNCHES)
    on_card = serve(cuda)
    assert all(ops.LAUNCHES[k] > before[k] for k in before)
    assert on_card == serve("cpu")

"""Port parity: the split route of ``flash_decode`` (flash-decoding).

``paged_attn_split_ref`` is the plain model of the CUDA split route:
each slot's positions in ``split_plan``'s chunks, a partial (m, l, acc)
a chunk, the chunks merged in chunk order. It is held to the JAX Pallas
kernel in interpret mode at atol 1e-5 in f32 (summation order only) at
G 1, 2, 8 and 16 and head dims 64, 112 and 256, with NaN in the trash
page, chunks wholly past a slot's position and a slot at position 0.
The chunk plan depends on the head dim and the page table's width
alone, never on B or ``pos``, and G = 1 keeps the slot route. The
model's ``round_p`` (the tensor-core body's rounding of P) stays within
one rounding of P of it. The CUDA kernel is held to the plain versions
and to this model on the card by ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_decode import flash_decode as j_flash_decode  # noqa: E402,E501
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5
PS = 16
KVH = 2
N_LIVE = 12                  # 192 positions: 3 chunks at hd 256, else 2
# a slot reading every position, one whose last chunk is past its
# position, one at position 0 (every chunk but the first past it)
POS = (N_LIVE * PS - 1, 70, 0)


def _case(seed, b, h, kvh, hd, n_live, pos, garbage, ps=PS):
    """Queries + pools with a scrambled page table (page 0 = trash, filled
    with ``garbage``); q (B, H, hd)."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * n_live + 3
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    k = rng.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32)
    k[0] = garbage
    v[0] = garbage
    pos = np.asarray(pos, np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    pages = np.zeros((b, n_live), np.int32)
    for i in range(b):
        live = 1 + pos[i] // ps
        pages[i, :live] = perm[i * n_live:i * n_live + live]
    return q, k, v, pages, pos


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("hd", [64, 112, 256])
@pytest.mark.parametrize("g", [1, 2, 8, 16])
def test_split_model_matches_jax_kernel(g, hd):
    """NaN in the trash page, which every unused table entry points at:
    neither the Pallas kernel (it skips pages past ``pos``) nor the model
    (it reads live positions only) lets it through."""
    case = _case(g * 1000 + hd, len(POS), g * KVH, KVH, hd, N_LIVE, POS,
                 float("nan"))
    got = fd.paged_attn_split_ref(*_t(*case)).numpy()
    want = np.asarray(j_flash_decode(*[jnp.asarray(a) for a in case],
                                     interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("g", [2, 8, 16])
def test_split_model_matches_plain_version(g):
    """Against the port's CPU path (``paged_attn_ref``), finite garbage
    in the trash page, ragged positions across chunk and page edges."""
    pos = (63, 64, 127, 128, 5)
    case = _t(*_case(g, len(pos), g * KVH, KVH, 112, N_LIVE, pos, 1e4))
    torch.testing.assert_close(fd.paged_attn_split_ref(*case),
                               ops.paged_decode_attn(*case), rtol=0,
                               atol=ATOL)


def test_slot_at_position_zero_reads_its_first_value():
    """Every chunk but the first is past the slot's position: their
    weights are 0, so the output is v at position 0 exactly."""
    g, hd = 8, 256
    q, k, v, pages, pos = _t(*_case(3, 4, g * KVH, KVH, hd, 128, (0,) * 4,
                                    float("nan")))
    chunk, n_chunks = fd.split_plan(hd, 128 * PS)
    assert n_chunks == 32
    got = fd.paged_attn_split_ref(q, k, v, pages, pos)
    first = v[pages[:, 0].long(), 0]                  # (B, KV, hd)
    want = first[:, :, None].expand(4, KVH, g, hd).reshape(4, g * KVH, hd)
    assert torch.equal(got, want)


@pytest.mark.parametrize("hd,n_keys,plan", [
    (256, 128, (64, 2)), (128, 128, (64, 2)), (64, 128, (64, 2)),
    (128, 256, (128, 2)), (256, 2048, (64, 32)), (128, 2048, (128, 16)),
    (112, 2048, (128, 16)), (64, 2048, (256, 8)), (16, 2048, (1024, 2)),
    (256, 2049, (128, 17)), (64, 32768, (1024, 32))])
def test_split_plan(hd, n_keys, plan):
    chunk, n_chunks = fd.split_plan(hd, n_keys)
    assert (chunk, n_chunks) == plan
    assert chunk % 64 == 0 and n_chunks <= 32
    assert (n_chunks - 1) * chunk < n_keys <= n_chunks * chunk


def test_chunks_depend_on_neither_batch_nor_pos():
    """The launcher's plan reads shapes only (B never, pos never), and a
    slot's output of the model is the same at B 1 and B 8, bit for bit."""
    g, hd = 8, 112
    pos8 = (191, 70, 0, 64, 63, 128, 150, 3)
    q, k, v, pages, pos = _t(*_case(5, 8, g * KVH, KVH, hd, N_LIVE, pos8,
                                    float("nan")))
    seen = []

    def fake_launch(kernel, fn_name, *args, body=None):
        seen.append((fn_name, args[14], args[15], body))

    wide = fd.paged_attn_split_ref(q, k, v, pages, pos)
    for i in range(8):
        one = fd.paged_attn_split_ref(q[i:i + 1], k, v, pages[i:i + 1],
                                      pos[i:i + 1])
        assert torch.equal(one[0], wide[i])
    with pytest.MonkeyPatch.context() as mp:
        _fake_cuda(mp, fake_launch)
        for b in (1, 8):
            for p in (pos[:b], torch.zeros(b, dtype=torch.int32)):
                fd.flash_decode(q[:b], k, v, pages[:b], p)
    assert len(set(seen)) == 1
    assert seen[0] == ("repro_flash_decode_split",
                       *fd.split_plan(hd, N_LIVE * PS), "split")


def _fake_cuda(mp, fake_launch):
    """Let the launcher run on CPU tensors with ``fake_launch`` in place of
    the library (its argument checks need CUDA tensors)."""

    class _Stream:
        cuda_stream = 0

    mp.setattr(fd, "check_paged_args", lambda *a: None)
    mp.setattr(fd, "launch", fake_launch)
    mp.setattr(fd, "body", lambda fn, dtype, g: "simt")
    mp.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())


@pytest.mark.parametrize("h,kvh,route", [(32, 32, "slot"), (8, 8, "slot"),
                                         (16, 8, "split"), (8, 1, "split"),
                                         (32, 2, "split"), (64, 8, "split")])
def test_g1_takes_the_slot_route(h, kvh, route):
    """G = 1 (OPT-1.3B, RoBERTa-large, whisper-base) calls the slot
    route's entry point with its unchanged arguments; every G >= 2 the
    split route's, with a workspace of (B, KV, chunks, G, hd + 2)."""
    hd, b = 64, 3
    q, k, v, pages, pos = _t(*_case(7, b, h, kvh, hd, 4, (5, 20, 63), 0.0))
    seen = {}

    def fake_launch(kernel, fn_name, *args, body=None):
        seen.update(kernel=kernel, fn=fn_name, body=body, n=len(args))

    with pytest.MonkeyPatch.context() as mp:
        _fake_cuda(mp, fake_launch)
        ws_shapes = []
        orig_empty = torch.empty
        mp.setattr(torch, "empty", lambda *s, **kw: ws_shapes.append(s[0])
                   or orig_empty(*s, **kw))
        fd.flash_decode(q, k, v, pages, pos)
    assert fd.decode_route(h, kvh) == route
    assert seen["kernel"] == "flash_decode" and seen["body"] == route
    if route == "slot":
        assert seen["fn"] == "repro_flash_decode" and seen["n"] == 15
        assert not ws_shapes
    else:
        g = h // kvh
        _, n_chunks = fd.split_plan(hd, 4 * PS)
        assert seen["fn"] == "repro_flash_decode_split" and seen["n"] == 18
        assert ws_shapes == [(b, kvh, n_chunks, g, hd + 2)]


@pytest.mark.parametrize("g,hd", [(8, 256), (16, 128), (8, 112)])
def test_rounded_split_model_is_within_one_p_rounding(g, hd):
    """``round_p`` (the tensor-core body's arithmetic: P rounded to bf16
    for P V, l from the unrounded P) moves each output by at most the
    rounding of P: every p changes by <= 2^-8 of itself (bf16's unit
    roundoff), so an output sum_t p_t v_t / sum_t p_t moves by <= 2^-8
    max|v| -- and it does move."""
    q, k, v, pages, pos = _t(*_case(5, len(POS), g * KVH, KVH, hd, N_LIVE,
                                    POS, float("nan")))
    exact = fd.paged_attn_split_ref(q, k, v, pages, pos)
    rounded = fd.paged_attn_split_ref(q, k, v, pages, pos, round_p=True)
    live = torch.cat([v[pages[i, :1 + int(pos[i]) // PS].long()].flatten()
                      for i in range(len(POS))])
    diff = (rounded - exact).abs().max().item()
    assert 0 < diff <= 2 ** -8 * live.abs().max().item()

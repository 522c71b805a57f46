"""Jamba as AI21-Jamba2-Mini publishes it (Mamba-1 with inner norms, GQA
attention, dropless top-2 MoE without renormalized gates): the port's
fused MeZO path against the plain reference ``perfbench/reference/
jamba.py``, at a tiny size on the CPU (d 64, one 8-layer period, 4
experts top-2, S 32), on seeded random weights, in f32.

  * the fused losses at +-eps within 1e-6 of the reference, gs alike,
    and an SGD step's update equal to the reference's replay of it with
    the port's gs at atol 0;
  * ``selective_scan_ref`` (the port's plain scan) against the
    reference's time-ordered recurrence, with and without an initial
    state, within 1e-6;
  * dropless routing: a router that sends every token to one expert
    drops nothing (capacity its load, rounded up to 64) and equals the
    reference; the capacity-factor path drops there;
  * ``moe_renorm=False`` gates are the top-2 softmax probabilities;
  * the 16-layer configuration's parameters, operations and bounds in
    ``perfbench/flops_hybrid.py`` against hand counts.
"""

import json
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from perfbench import flops_hybrid  # noqa: E402
from perfbench.reference import jamba as J  # noqa: E402
from perfbench.reference import zhash  # noqa: E402
from perfbench.traffic import make_batch  # noqa: E402
from repro_torch.core import build_strategy, rng  # noqa: E402
from repro_torch.core.engine import MezoConfig  # noqa: E402
from repro_torch.core.perturb_ctx import PerturbCtx  # noqa: E402
from repro_torch.core.spans import COUNTS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.selective_scan import selective_scan_ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FULL = json.loads((ROOT / "perfbench/configs/jamba2-mini.json")
                  .read_text())["model"]
TINY = dict(FULL, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=128, n_experts=4, expert_dff=64, max_seq=64,
            dtype="float32")
SEED = 2 ** 32 + 7
EPS, LR = 1e-3, 1e-3


def _batch():
    return make_batch({"task": "lm", "batch": 2, "seq": 32}, TINY["vocab"],
                      0, SEED, 0, "cpu")


def test_param_tree_is_the_references():
    ours = param_shapes(ModelConfig(**TINY))
    assert list(ours) == list(J.param_spec(TINY))
    for path, spec in J.param_spec(TINY).items():
        assert ours[path] == spec, path


def test_fused_losses_gs_and_update_match_the_reference():
    params = J.make_params(TINY, SEED, "cpu")
    batch = _batch()
    model = build_model(ModelConfig(**TINY))
    s = zhash.direction_seed(SEED, 0)
    got = [float(model.loss(params, batch, perturb=PerturbCtx(
        seed=s, coeff=torch.tensor(c, dtype=torch.float32))))
        for c in (EPS, -EPS)]
    want, _ = J.losses(TINY, params, batch, s, (EPS, -EPS))
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-6 * abs(w), (got, want)
    mcfg = MezoConfig(eps=EPS, lr=LR, n_directions=1, dist="rademacher")
    strategy = build_strategy("fused", "sgd")
    state = strategy.init_state({k: v.clone() for k, v in params.items()},
                                mcfg)
    step_seed = rng.fold_seed(SEED, 0)
    assert rng.fold_seed(step_seed, 0) == s
    state, aux = strategy.step(model.loss, state, batch, step_seed, mcfg)
    gs = float(aux.gs[0])
    assert EPS * abs(gs - (want[0] - want[1]) / (2 * EPS)) <= \
        1e-6 * abs(want[0])
    mezo = {"eps": EPS, "lr": LR, "n_directions": 1}
    J.replay(TINY, mezo, params, [[gs]], SEED, SEED)
    for path, p in params.items():
        assert torch.equal(state.params[path], p), path
    start = J.make_params(TINY, SEED, "cpu")
    assert not torch.equal(params["lm_head/w"], start["lm_head/w"])


@pytest.mark.parametrize("h0", [False, True], ids=["zeros", "h0"])
def test_selective_scan_ref_is_the_references_recurrence(h0):
    g = torch.Generator().manual_seed(3)
    b, s, di, n = 2, 19, 12, 4

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=g) * std
    x, z = rnd(b, s, di), rnd(b, s, di)
    dt, bias = rnd(b, s, di, std=0.3), rnd(di, std=0.1)
    a_log = torch.log(torch.arange(1.0, n + 1)).expand(di, n) + rnd(di, n,
                                                                     std=0.05)
    bmat, cmat, d = rnd(b, s, n), rnd(b, s, n), 1.0 + rnd(di, std=0.1)
    start = rnd(b, di, n) if h0 else None
    y, h = selective_scan_ref(x, dt, bias, a_log, bmat, cmat, d, z, start)
    assert y.shape == (b, s, di) and h.shape == (b, di, n)
    delta = J._softplus(dt + bias)
    want = J._scan(x, delta, (-torch.exp(a_log)).expand(b, di, n), bmat,
                   cmat, d.expand(b, di), z, start)
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    # the kernels' entry point takes the plain version on the CPU
    y2, h2 = ops.selective_scan(x, dt, bias, a_log, bmat, cmat, d, z, start)
    assert torch.equal(y2, y) and torch.equal(h2, h)


def _moe_case(factor):
    """A MoE layer whose router sends every token to expert 0 first."""
    cfg = ModelConfig(**dict(TINY, capacity_factor=factor))
    g = torch.Generator().manual_seed(4)
    d, e, f = TINY["d_model"], TINY["n_experts"], TINY["expert_dff"]
    router = torch.randn((d, e), generator=g) * 0.02
    router[:, 0] = 1.0
    p = {"router": router,
         "w_in": torch.randn((e, d, f, 2), generator=g) * 0.02,
         "w_out": torch.randn((e, f, d), generator=g) * 0.02}
    x = torch.randn((2, 32, d), generator=g).abs()
    return cfg, p, x


def test_dropless_routing_keeps_every_token():
    cfg, p, x = _moe_case(None)
    ops.reset_launches()
    out, aux = moe.moe_apply(cfg, p, x)
    t, k, e = 64, TINY["topk"], TINY["n_experts"]
    assert COUNTS["moe.calls"] == 1 and COUNTS["moe.max_load"] == t
    assert COUNTS["moe.assignments"] == t * k
    assert COUNTS["moe.rows"] == e * 64           # load 64, rounded to 64
    params = {f"blocks/sub_1/moe/{k_}": v[None] for k_, v in p.items()}
    want, want_aux = J._moe(J.Leaves(params, None, (0.0,)),
                            "blocks/sub_1/moe", x[None], 0, TINY, "f32",
                            None, None)
    torch.testing.assert_close(out, want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(aux, want_aux[0])
    # the capacity-factor path drops there (capacity 40 of 64 for expert 0)
    dropped, _ = moe.moe_apply(*_moe_case(1.25))
    assert (dropped - want[0]).abs().max() > 1e-3
    # two calls on the same input are bit-equal
    assert torch.equal(moe.moe_apply(cfg, p, x)[0], out)


@pytest.mark.parametrize("renorm", [False, True])
def test_gates_without_renormalization_are_the_softmax_probs(renorm):
    cfg, p, x = _moe_case(None)
    cfg = ModelConfig(**dict(TINY, moe_renorm=renorm))
    xf = x.reshape(-1, x.shape[-1])
    _, gate, idx, _ = moe._gates(cfg, xf, p["router"])
    top = torch.topk(torch.softmax(xf @ p["router"], dim=-1), 2, dim=-1)
    assert torch.equal(idx, top.indices)
    if renorm:
        torch.testing.assert_close(gate.sum(-1), torch.ones(64))
    else:
        assert torch.equal(gate, top.values)


def test_counts_of_the_16_layer_configuration():
    assert flops_hybrid.param_count(FULL) == 26_053_599_168
    assert sum(math.prod(s) for s, _, _ in param_shapes(
        ModelConfig(**FULL)).values()) == 26_053_599_168
    plain = dict(FULL, mamba_inner_norm=False)
    assert flops_hybrid.param_count(plain) == 26_053_595_136
    d, di, f, v = 4096, 8192, 14336, 65536
    attn = d * d * 2 + d * 1024 * 2                  # wq, wo; wk, wv
    mamba = d * 2 * di + di * 288 + 256 * di + di * d
    mlp = d * 2 * f + f * d
    moe_ = d * 16 + 2 * mlp                           # router, top-2
    per_token = 2 * attn + 14 * mamba + 8 * mlp + 8 * moe_ + d * v
    b, s = 2, 4096
    attention = 2 * (2 * 2 * b * 32 * s * s * 128 / 2)
    assert flops_hybrid.forward_flops(FULL, b, s) == \
        2 * b * s * per_token + attention
    mz = {"n_directions": 1, "dist": "rademacher"}
    assert flops_hybrid.step_flops(FULL, mz, b, s) == pytest.approx(
        199.4e12, rel=2e-3)
    assert flops_hybrid.zo_matmul_launches(FULL) == 2 * 4 + 14 * 3 + 8 + 1
    scan_bytes = (2 * b * s * (3 * di + 256 + 32)
                  + 256 * di * 2 + di * 2 + (256 + 32) * 4 + di * 16 * 4
                  + di * 4)
    assert flops_hybrid.scan_bytes(FULL, b, s) == scan_bytes
    # 5/11 of the exponentials on the SFUs (16 a clock an SM), the rest
    # at 3 FP32 operations each beside 2 a state and step (128 a clock):
    # 16 x / 16 = (3 (1 - x) + 2) / 128 at x = 5 / 11
    exps = 5 / 11 * b * s * di * 16 / (16 * 132 * 1.98e9)
    assert flops_hybrid.scan_compute_s(b * s * di * 16) == pytest.approx(exps)
    assert exps < scan_bytes / 3.35e12
    assert flops_hybrid.selective_scan_bound_s(FULL, b, s) == \
        pytest.approx(14 * scan_bytes / 3.35e12)

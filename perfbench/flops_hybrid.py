"""Operations and bytes of the Jamba hybrid's work (``family`` "hybrid"),
counted from the configuration's shapes and the batch, not from what the
program launches (``flops.py`` counts the dense and encoder models).

Per forward of ``B x S`` tokens (M = B * S rows): each period of
``block_len`` layers has one GQA attention mixer at ``attn_index`` and
Mamba-1 mixers elsewhere, MoE FFNs on odd layers and dense SwiGLU FFNs on
even ones; then the untied LM head. The products:

* attention: wq, wk, wv, wo; causal attention ``2 * 2 B H S^2 hd / 2``;
* Mamba: in_proj (d, 2 di), x_proj (di, dt_rank + 2 n), dt_proj
  (dt_rank, di), out_proj (di, d);
* dense FFN: w_in (d, 2 f), w_out (f, d); MoE: the router (d, E) and, a
  token's top-k experts, each (d, 2 f_e) and (f_e, d);
* the head (d, V).

A MeZO step is ``2 K`` forwards. Of the products, ``zo_matmul`` runs the
perturbed 2-D weights: the attention projections, Mamba's in_proj,
x_proj and out_proj, the dense FFN's w_out and the head; dt_proj, the
router, the gated (d, f, 2) w_in and the experts are perturbed into
transients and multiplied outside it.

The selective scan's bound (``selective_scan_bound_s``) is the larger of
the least bytes any implementation moves over HBM bandwidth -- x, z and
y at 2 bytes, dt's low-rank input, B and C at 2 bytes, the scan's own
leaves (dt_proj, the inner norms' scales, A_log, D) as stored -- and the
least time its arithmetic takes (``scan_compute_s``). That arithmetic is
``B * S * di * n`` exponentials and, for each, at least
:data:`SCAN_FMA_OPS` operations of the FP32 pipe (the recurrence's FMA
and that of ``C . h``). An exponential runs on the SFU,
:data:`SFU_EXP_PER_S` (16 a clock an SM), or on the FP32 pipe,
:data:`FMA_OPS_PER_S` (128 a clock an SM), in no fewer than
:data:`EXP_FMA_OPS` operations there (a degree-3 polynomial in Horner
form; the range reduction and the exponent's shift go to the integer
pipe). The bound splits the exponentials between the two pipes so that
both finish together, so no design that moves part of them to the FP32
pipe reads over 100 %. Rates at 132 SMs and 1.98 GHz, the H100 SXM's
boost clock.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from perfbench.peaks import HBM_BYTES_PER_S, PEAK_FLOPS
from perfbench.reference.jamba import param_spec

SFU_EXP_PER_S = 16 * 132 * 1.98e9
FMA_OPS_PER_S = 128 * 132 * 1.98e9
EXP_FMA_OPS = 3
SCAN_FMA_OPS = 2
_BYTES = {"bfloat16": 2, "float32": 4}


def _dims(model: dict):
    d, h = model["d_model"], model["n_heads"]
    hd = model.get("head_dim") or d // h
    di = model["mamba_expand"] * d
    return d, h, model["n_kv_heads"], hd, di, max(1, d // 16), \
        model["mamba_d_state"]


def layers(model: dict) -> List[Tuple[str, str]]:
    """(mixer, ffn) of every layer: ``attention`` or ``mamba``, ``moe``
    or ``mlp``."""
    out = []
    for _ in range(model["n_layers"] // model["block_len"]):
        for i in range(model["block_len"]):
            out.append(("attention" if i == model["attn_index"] else "mamba",
                        "moe" if model.get("n_experts") and i % 2 == 1
                        else "mlp"))
    return out


def projections(model: dict, b: int, s: int
                ) -> List[Tuple[int, int, int, bool]]:
    """(M, K, N, through zo_matmul) of every product of one forward."""
    d, h, kv, hd, di, dtr, n = _dims(model)
    f = model["d_ff"]
    fe = model.get("expert_dff") or f
    m = b * s
    out = []
    for mixer, ffn in layers(model):
        if mixer == "attention":
            out += [(m, d, h * hd, True), (m, d, kv * hd, True),
                    (m, d, kv * hd, True), (m, h * hd, d, True)]
        else:
            out += [(m, d, 2 * di, True), (m, di, dtr + 2 * n, True),
                    (m, dtr, di, False), (m, di, d, True)]
        if ffn == "moe":
            mk = m * model["topk"]
            out += [(m, d, model["n_experts"], False), (mk, d, 2 * fe, False),
                    (mk, fe, d, False)]
        else:
            out += [(m, d, 2 * f, False), (m, f, d, True)]
    out.append((m, d, model["vocab"], True))
    return out


def attention_flops(model: dict, b: int, s: int) -> float:
    _, h, _, hd, _, _, _ = _dims(model)
    n_attn = sum(1 for mixer, _ in layers(model) if mixer == "attention")
    return 2.0 * 2.0 * b * h * s * s * hd / 2.0 * n_attn


def forward_flops(model: dict, b: int, s: int) -> float:
    return (sum(2.0 * m * k * n for m, k, n, _ in projections(model, b, s))
            + attention_flops(model, b, s))


def step_flops(model: dict, mezo: dict, b: int, s: int) -> float:
    return 2.0 * int(mezo.get("n_directions", 1)) * forward_flops(model, b, s)


def zo_matmul_bound_s(model: dict, mezo: dict, b: int, s: int) -> float:
    """Least device time of one forward's ``zo_matmul`` products: per
    product max(operations / the body's peak, (X + W + Y bytes) / HBM),
    as ``flops.zo_matmul_bound_s`` counts them."""
    xb = _BYTES[model["dtype"]]
    tc = model["dtype"] == "bfloat16" and mezo["dist"] == "rademacher"
    peak = PEAK_FLOPS["bfloat16" if tc else "float32"]
    total = 0.0
    for m, k, n, zo in projections(model, b, s):
        if zo:
            by = m * k * xb + m * n * xb + k * n * xb
            total += max(2.0 * m * k * n / peak, by / HBM_BYTES_PER_S)
    return total


def zo_matmul_launches(model: dict) -> int:
    """``zo_matmul`` launches of one forward."""
    return sum(1 for *_, zo in projections(model, 1, 1) if zo)


def scan_bytes(model: dict, b: int, s: int) -> float:
    """The least bytes one layer's scan moves (module docstring)."""
    d, _, _, _, di, dtr, n = _dims(model)
    spec = param_spec(model)
    first = f"blocks/sub_{1 if model['attn_index'] == 0 else 0}/mamba/"
    own = ("/dt_proj/w", "/dt_proj/b", "/dt_norm/scale", "/b_norm/scale",
           "/c_norm/scale", "/A_log", "/D")
    leaves = 0.0
    for path, (shape, dt, _) in spec.items():
        if path.startswith(first) and path.endswith(own):
            size = 2 if str(dt).endswith("bfloat16") else 4
            leaves += math.prod(shape[1:]) * size
    return 2.0 * b * s * (3 * di + dtr + 2 * n) + leaves


def scan_compute_s(n_exp: float) -> float:
    """Least time of ``n_exp`` exponentials and ``SCAN_FMA_OPS`` FP32
    operations each, a share ``x`` of the exponentials on the SFU and the
    rest on the FP32 pipe at ``EXP_FMA_OPS`` each, ``x`` where the two
    pipes finish together (at most 1)."""
    sfu, fma, c = SFU_EXP_PER_S, FMA_OPS_PER_S, EXP_FMA_OPS
    x = min(1.0, sfu * (c + SCAN_FMA_OPS) / (fma + c * sfu))
    return max(x * n_exp / sfu, ((1 - x) * c + SCAN_FMA_OPS) * n_exp / fma)


def selective_scan_bound_s(model: dict, b: int, s: int) -> float:
    """Least device time of one forward's scans: per Mamba layer the
    larger of its bytes over HBM and its arithmetic
    (:func:`scan_compute_s`)."""
    _, _, _, _, di, _, n = _dims(model)
    n_mamba = sum(1 for mixer, _ in layers(model) if mixer == "mamba")
    one = max(scan_bytes(model, b, s) / HBM_BYTES_PER_S,
              scan_compute_s(b * s * di * n))
    return n_mamba * one


def param_count(model: dict) -> int:
    return sum(math.prod(shape) for shape, _, _ in param_spec(model).values())
